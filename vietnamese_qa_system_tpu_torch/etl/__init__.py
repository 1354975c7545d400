"""The offline ETL pipeline: dataset parsers, content filters, tone
normalization and fault-tolerant translation (the port's copy of
``vietnamese_qa_system_tpu/etl``)."""

from .filters import code_likelihood_score, have_code
from .normalize import TONE_MAP, normalize_tones
from .parser import DataParser, load_json_or_jsonl, reformat_data
from .translate import (
    FlakyWrapper,
    NullTranslator,
    Translator,
    translate_texts,
)
from .parsers import PARSER_REGISTRY, get_parser

__all__ = [
    "code_likelihood_score",
    "have_code",
    "TONE_MAP",
    "normalize_tones",
    "DataParser",
    "load_json_or_jsonl",
    "reformat_data",
    "Translator",
    "NullTranslator",
    "FlakyWrapper",
    "translate_texts",
    "PARSER_REGISTRY",
    "get_parser",
]
