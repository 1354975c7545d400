"""Concrete dataset parsers.

Capability of the reference's 16 dataset parsers
(reference src/data/features/final_storge_converted/*/ — OpenOrca, alpaca
-cleaned, dolly-15k, WizardLM-70k, Bactrian-X, lima-vi, MathInstruct,
math_qa, grade-school-math, zaloAI-math (+test), mt_eng_vietnamese, ELI5
(train/val/custom/mult-answers), webglm-qa, Train-v2.0 (SQuAD), Train_IR,
ctx_injector.py).  Each reference parser streams a HF dataset and maps
fields to its record dataclass; here the raw source is pluggable
(etl/sources.py): LOCAL json/jsonl by default (this environment has no
network egress), or an ``hf://`` spec that streams through
``datasets.load_dataset(streaming=True)`` like the reference.  Field
mappings follow the public dataset formats, and each class notes the
reference parser it mirrors.

The port's copy of ``vietnamese_qa_system_tpu/etl/parsers/builtin.py``:
the same 17 classes, ``PARSER_REGISTRY`` and ``get_parser``; system
prompts come from the port's ``data/templates.DEFAULT_BANK``.
"""

from __future__ import annotations

import json
from typing import Optional

from ...data.templates import DEFAULT_BANK
from ..parser import DataParser


class GenericInstructParser(DataParser):
    """Configurable field-mapping parser: covers simple instruction sets
    with one class (the reference wrote a near-identical class per dataset).
    """

    schema = "instruct"
    instruction_key = "instruction"
    input_key: Optional[str] = "input"
    output_key = "output"
    system_key: Optional[str] = None
    max_examples: Optional[int] = None

    def read(self):
        super().read()
        self.raw = self.load_raw(self.max_examples)

    def _system_prompt(self, row: dict) -> str:
        if self.system_key and row.get(self.system_key):
            return str(row[self.system_key])
        return DEFAULT_BANK.render_random("system", self.rng)

    def _question(self, row: dict) -> str:
        q = str(row[self.instruction_key])
        if self.input_key and row.get(self.input_key):
            q = f"{q}\n{row[self.input_key]}"
        return q

    def _answer(self, row: dict) -> Optional[str]:
        a = row.get(self.output_key)
        return None if a in (None, "") else str(a)

    def convert(self):
        super().convert()
        self.converted = [
            {
                "id": str(row.get("id", self.new_id())),
                "system_prompt": self._system_prompt(row),
                "question": self._question(row),
                "answer": self._answer(row),
            }
            for row in self.raw
        ]


class AlpacaParser(GenericInstructParser):
    """yahma/alpaca-cleaned (reference yahma_alpaca-cleaned parser)."""


class DollyParser(GenericInstructParser):
    """databricks-dolly-15k (reference databricks-dolly-15k parser):
    instruction/context/response — context folds into the question."""

    instruction_key = "instruction"
    input_key = "context"
    output_key = "response"


class OpenOrcaParser(GenericInstructParser):
    """Open-Orca/OpenOrca (reference OpenOrca_Parser.py:16): keeps the
    dataset's own system prompt."""

    instruction_key = "question"
    input_key = None
    output_key = "response"
    system_key = "system_prompt"


class WizardLMParser(GenericInstructParser):
    """WizardLM evol-instruct-70k (reference WizardLM parser)."""

    instruction_key = "instruction"
    input_key = None
    output_key = "output"


class BactrianXParser(GenericInstructParser):
    """MBZUAI/Bactrian-X vi split (reference MBZUAI-Bactrian-X parser)."""


class MathInstructParser(GenericInstructParser):
    """TIGER-Lab/MathInstruct (reference TIGER-Lab-MathInstruct parser)."""

    instruction_key = "instruction"
    input_key = None
    output_key = "output"


class GradeSchoolMathParser(GenericInstructParser):
    """grade-school-math-instructions (reference parser): question/answer
    pairs, code-like answers kept untranslated by the base filter gate."""

    instruction_key = "INSTRUCTION"
    input_key = None
    output_key = "RESPONSE"


class MathQAParser(GenericInstructParser):
    """math_qa (reference math_qa parser): Problem + options; the rationale
    plus the correct option letter forms the answer."""

    instruction_key = "Problem"
    input_key = "options"
    output_key = "Rationale"

    def _answer(self, row):
        rationale = row.get("Rationale", "")
        correct = row.get("correct", "")
        if correct:
            return f"{rationale}\nĐáp án: {correct}"
        return rationale or None


class ZaloAIMathParser(GenericInstructParser):
    """zaloAI-math (reference zaloAI-math + zaloAI-math-train parsers):
    multiple-choice Vietnamese math with explanations."""

    instruction_key = "question"
    input_key = None
    output_key = "explanation"

    def _question(self, row):
        q = str(row[self.instruction_key])
        choices = row.get("choices") or []
        if choices:
            opts = "\n".join(f"{chr(65 + i)}. {c}" for i, c in enumerate(choices))
            q = f"{q}\n{opts}"
        return q

    def _answer(self, row):
        expl = row.get("explanation") or ""
        ans = row.get("answer") or ""
        parts = [p for p in (expl, f"Đáp án: {ans}" if ans else "") if p]
        return "\n".join(parts) or None


class LimaViParser(GenericInstructParser):
    """vilm/lima-vi (reference vilm-lima-vi parser): conversation turns —
    first turn is the question, second the answer."""

    def read(self):
        super(GenericInstructParser, self).read()
        self.raw = self.load_raw()

    def convert(self):
        super(GenericInstructParser, self).convert()
        out = []
        for row in self.raw:
            conv = row.get("conversations") or []
            if len(conv) < 2:
                continue
            out.append(
                {
                    "id": str(row.get("id", self.new_id())),
                    "system_prompt": DEFAULT_BANK.render_random("system", self.rng),
                    "question": str(conv[0]),
                    "answer": str(conv[1]),
                }
            )
        self.converted = out


class TranslationPairParser(DataParser):
    """mt_eng_vietnamese (reference MTEngVietnameseParser.py:20):
    synthesize translation instructions from en↔vi sentence pairs, both
    directions, with varied instruction phrasings."""

    schema = "instruct"
    directions = (("en", "vi"), ("vi", "en"))
    _PHRASES = {
        ("en", "vi"): [
            "Dịch câu sau sang tiếng Việt:",
            "Hãy chuyển câu tiếng Anh này thành tiếng Việt:",
            "Bản dịch tiếng Việt của câu sau là gì?",
        ],
        ("vi", "en"): [
            "Dịch câu sau sang tiếng Anh:",
            "Hãy chuyển câu tiếng Việt này thành tiếng Anh:",
            "Bản dịch tiếng Anh của câu sau là gì?",
        ],
    }

    def read(self):
        super().read()
        self.raw = self.load_raw()

    def convert(self):
        super().convert()
        out = []
        for row in self.raw:
            pair = row.get("translation", row)
            en, vi = pair.get("en"), pair.get("vi")
            if not en or not vi:
                continue
            for src, dst in self.directions:
                text = {"en": en, "vi": vi}
                phrase = self.rng.choice(self._PHRASES[(src, dst)])
                out.append(
                    {
                        "id": self.new_id(),
                        "system_prompt": DEFAULT_BANK.render_random(
                            "system", self.rng
                        ),
                        "question": f"{phrase}\n{text[src]}",
                        "answer": text[dst],
                    }
                )
        self.converted = out

    # translating a translation dataset would destroy it
    translatable_fields = ()


class Eli5Parser(DataParser):
    """ELI5 long-form QA with retrieved passages (reference
    ELI5_Parser_train_10_doc.py:16 + val/custom/mult-answer variants):
    question + doc_tokens/ctxs → QA schema with documents."""

    schema = "qa"
    max_docs = 10
    all_answers = False  # mult-answers variant keeps every answer

    def read(self):
        super().read()
        self.raw = self.load_raw()

    @staticmethod
    def _docs(row) -> list[str]:
        docs = row.get("doc_tokens") or row.get("ctxs") or row.get("documents") or []
        return [d["text"] if isinstance(d, dict) else str(d) for d in docs]

    @staticmethod
    def _answers(row) -> list[str]:
        ans = row.get("answers")
        if isinstance(ans, dict):  # HF eli5 format {"text": [...], ...}
            return [str(a) for a in ans.get("text", [])]
        if isinstance(ans, list):
            return [str(a) for a in ans]
        return [str(ans)] if ans else []

    def convert(self):
        super().convert()
        out = []
        for row in self.raw:
            answers = self._answers(row)
            question = str(row.get("question") or row.get("title") or "")
            if not question:
                continue
            docs = self._docs(row)[: self.max_docs]
            keep = answers if (self.all_answers and answers) else answers[:1]
            for ans in keep or [None]:
                out.append(
                    {
                        "id": str(row.get("q_id", row.get("id", self.new_id()))),
                        "question": question,
                        "documents": docs,
                        "answer": ans,
                    }
                )
        self.converted = out


class WebglmQAParser(DataParser):
    """THUDM/webglm-qa (reference THUDMWebglmQaParser.py:15): LFQA whose
    answers cite [i] references; references become the document list."""

    schema = "qa"

    def read(self):
        super().read()
        self.raw = self.load_raw()

    def convert(self):
        super().convert()
        self.converted = [
            {
                "id": str(row.get("id", self.new_id())),
                "question": str(row["question"]),
                "documents": [str(r) for r in row.get("references", [])],
                "answer": str(row["answer"]) if row.get("answer") else None,
            }
            for row in self.raw
        ]


class SquadV2Parser(DataParser):
    """SQuAD v2 Train-v2.0.json (reference Train-v2.0 parser): nested
    data→paragraphs→qas with is_impossible flags → QA schema (impossible →
    answer None → refusal targets)."""

    schema = "qa"

    def read(self):
        super().read()
        with open(self.input_path, encoding="utf-8") as f:
            self.raw = json.load(f)

    def convert(self):
        super().convert()
        out = []
        for article in self.raw.get("data", []):
            for para in article.get("paragraphs", []):
                ctx = para.get("context", "")
                for qa in para.get("qas", []):
                    answers = qa.get("answers") or []
                    impossible = qa.get("is_impossible", not answers)
                    out.append(
                        {
                            "id": str(qa.get("id", self.new_id())),
                            "question": str(qa["question"]),
                            "documents": [ctx] if ctx else [],
                            "answer": None
                            if impossible or not answers
                            else str(answers[0]["text"]),
                        }
                    )
        self.converted = out


class TrainIRParser(DataParser):
    """Train_IR (reference TrainIR_Parser.py:16): retrieval training pairs
    query + positive (+ hard negative) passages → QA schema where the
    positive passages are the documents."""

    schema = "qa"

    def read(self):
        super().read()
        self.raw = self.load_raw()

    def convert(self):
        super().convert()
        out = []
        for row in self.raw:
            pos = row.get("pos") or row.get("positive_passages") or []
            neg = row.get("neg") or row.get("negative_passages") or []
            docs = [p["text"] if isinstance(p, dict) else str(p) for p in pos]
            docs += [p["text"] if isinstance(p, dict) else str(p) for p in neg[:2]]
            out.append(
                {
                    "id": str(row.get("query_id", row.get("id", self.new_id()))),
                    "question": str(row.get("query") or row.get("question")),
                    "documents": docs,
                    "answer": docs[0] if docs else None,
                }
            )
        self.converted = out


class CtxInjectorParser(DataParser):
    """ctx_injector.py capability (reference
    final_storge_converted/ctx_injector.py:19): re-process an already
    converted QA JSONL, mixing random unrelated contexts into each record's
    documents (the base class injection machinery does the work)."""

    schema = "qa"

    def __init__(self, input_path, output_dir, *, ctx_pool=None, **kw):
        if not ctx_pool:
            raise ValueError("CtxInjectorParser requires a ctx_pool")
        super().__init__(input_path, output_dir, ctx_pool=ctx_pool, **kw)

    def read(self):
        super().read()
        self.raw = self.load_raw()

    def convert(self):
        super().convert()
        self.converted = list(self.raw)


PARSER_REGISTRY = {
    "alpaca": AlpacaParser,
    "dolly": DollyParser,
    "openorca": OpenOrcaParser,
    "wizardlm": WizardLMParser,
    "bactrian_x": BactrianXParser,
    "lima_vi": LimaViParser,
    "math_instruct": MathInstructParser,
    "math_qa": MathQAParser,
    "grade_school_math": GradeSchoolMathParser,
    "zaloai_math": ZaloAIMathParser,
    "mt_eng_vietnamese": TranslationPairParser,
    "eli5": Eli5Parser,
    "webglm_qa": WebglmQAParser,
    "squad_v2": SquadV2Parser,
    "train_ir": TrainIRParser,
    "ctx_injector": CtxInjectorParser,
    "generic_instruct": GenericInstructParser,
}


def get_parser(name: str):
    if name not in PARSER_REGISTRY:
        raise KeyError(
            f"unknown parser {name!r}; available: {sorted(PARSER_REGISTRY)}"
        )
    return PARSER_REGISTRY[name]
