"""QA record schema and the prompt markers of the reader.

The part of ``vietnamese_qa_system_tpu/data/schemas.py`` that the QA
pipeline uses, carried into the port (standard library only): the
question / response markers and ``QAExample.flatten_docs``, the ``[CTX i]``
concatenation of retrieved passages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .templates import DEFAULT_BANK, TemplateBank

QUESTION_PREFIX = "### Câu hỏi:"
RESPONSE_PREFIX = "### Trả lời:"


@dataclasses.dataclass
class QAExample:
    """Retrieval-augmented QA record: question + retrieved docs + answer
    (``answer=None`` is unanswerable)."""

    id: str
    question: str
    documents: list[str] = dataclasses.field(default_factory=list)
    answer: Optional[str] = None
    is_trivial: bool = False

    @staticmethod
    def flatten_docs(docs: list[str], bank: TemplateBank = DEFAULT_BANK) -> str:
        """[CTX i] ... [ECTX i] concatenation of the passages."""
        if not docs:
            return f"[KHÔNG CÓ TÀI LIỆU] {bank.families['no_docs'][0]}"
        return "".join(f" [CTX{i}]: {doc} [ECTX{i}] " for i, doc in enumerate(docs))
