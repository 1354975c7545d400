from .schemas import QUESTION_PREFIX, RESPONSE_PREFIX, QAExample
from .templates import DEFAULT_BANK, TemplateBank
from .tokenizer import ByteTokenizer, HFTokenizer, Tokenizer, batch_encode

__all__ = [
    "DEFAULT_BANK",
    "QUESTION_PREFIX",
    "RESPONSE_PREFIX",
    "ByteTokenizer",
    "HFTokenizer",
    "QAExample",
    "TemplateBank",
    "Tokenizer",
    "batch_encode",
]
