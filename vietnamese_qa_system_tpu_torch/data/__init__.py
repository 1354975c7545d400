from .tokenizer import ByteTokenizer, HFTokenizer, Tokenizer, batch_encode

__all__ = ["ByteTokenizer", "HFTokenizer", "Tokenizer", "batch_encode"]
