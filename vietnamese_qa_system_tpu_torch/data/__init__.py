from .loader import IGNORE_INDEX, DataFileSpec, QADataLoader
from .schemas import QUESTION_PREFIX, RESPONSE_PREFIX, InstructExample, QAExample, parse_record
from .templates import DEFAULT_BANK, TemplateBank
from .tokenizer import ByteTokenizer, HFTokenizer, Tokenizer, batch_encode

__all__ = [
    "DEFAULT_BANK",
    "IGNORE_INDEX",
    "QUESTION_PREFIX",
    "RESPONSE_PREFIX",
    "ByteTokenizer",
    "DataFileSpec",
    "HFTokenizer",
    "InstructExample",
    "QADataLoader",
    "QAExample",
    "TemplateBank",
    "Tokenizer",
    "batch_encode",
    "parse_record",
]
