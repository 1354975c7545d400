"""Example record schemas and prompt assembly.

A copy of ``vietnamese_qa_system_tpu/data/schemas.py`` (standard library
only), carried into the port because the JAX package's ``data`` package
imports jax: the question / response markers, ``QAExample`` (the ``[CTX
i]`` concatenation of retrieved passages, template rendering),
``InstructExample`` and ``parse_record``, which the QA pipeline and the
training loader (data/loader.py) use.  Rendering is seeded and identical to
the JAX package's, so both loaders build the same batches.

One difference: ``parse_record`` also takes an instruct record in the raw
alpaca layout (``instruction`` / ``input`` / ``output``, the layout of
``examples/sample_instruct.jsonl``), mapped as the JAX package's
``AlpacaParser`` maps it but with an empty system prompt (that parser draws
one from the template bank with its own seeded generator).  The JAX
package refuses such a record; its flow converts it with ``cli parse``
first.
"""

from __future__ import annotations

import dataclasses
import random
import string
from typing import Optional

from .templates import DEFAULT_BANK, TemplateBank

# Markers owned by this framework (the reference used "####### Instruction:"
# / "%%%%%%% Response:" prefixes, advance_instruct_sample.py:64-65).
QUESTION_PREFIX = "### Câu hỏi:"
RESPONSE_PREFIX = "### Trả lời:"


def generate_id(rng: random.Random, size: int = 12) -> str:
    """Random example id (capability of DataParser.id_generator,
    reference data_parser.py:125)."""
    alphabet = string.ascii_lowercase + string.digits
    return "".join(rng.choice(alphabet) for _ in range(size))


@dataclasses.dataclass
class QAExample:
    """Retrieval-augmented QA record: question + retrieved docs + answer.

    ``answer=None`` → unanswerable (refusal target); ``is_trivial`` →
    answerable without documents.
    """

    id: str
    question: str
    documents: list[str] = dataclasses.field(default_factory=list)
    answer: Optional[str] = None
    is_trivial: bool = False

    @property
    def is_impossible(self) -> bool:
        return self.answer is None

    def shuffled_docs(self, rng: random.Random) -> list[str]:
        """Shuffle doc order per render — the reference shuffles in
        __post_init__ (advance_qa_sample.py:38-40) to fight 'Lost in the
        Middle' position bias; here the shuffle is explicit and seeded."""
        docs = list(self.documents)
        rng.shuffle(docs)
        return docs

    @staticmethod
    def flatten_docs(docs: list[str], bank: TemplateBank = DEFAULT_BANK) -> str:
        """[CTX i] ... [ECTX i] concatenation (reference straighten_docs,
        advance_qa_sample.py:99-106)."""
        if not docs:
            return f"[KHÔNG CÓ TÀI LIỆU] {bank.families['no_docs'][0]}"
        return "".join(
            f" [CTX{i}]: {doc} [ECTX{i}] " for i, doc in enumerate(docs)
        )

    def render(
        self,
        rng: random.Random,
        bank: TemplateBank = DEFAULT_BANK,
    ) -> dict:
        """→ {"prompt", "target"} via the template bank, mirroring the
        reference's branching (advance_qa_sample.py:77-97): impossible →
        refusal; trivial without docs → trivial answer; docs → normal
        response; answerable but no docs → refusal."""
        context = self.flatten_docs(self.shuffled_docs(rng), bank)
        prompt = bank.render_random(
            "prompt", rng, question=self.question, context=context
        )
        if self.is_impossible:
            target = bank.render_random("no_answer", rng, question=self.question)
        elif self.is_trivial and not self.documents:
            target = bank.render_random(
                "trivial", rng, question=self.question, answer=self.answer
            )
        elif self.documents:
            target = bank.render_random("response", rng, answer=self.answer)
        else:
            target = bank.render_random("no_answer", rng, question=self.question)
        return {"prompt": prompt, "target": target}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def keys(cls) -> list[str]:
        return [f.name for f in dataclasses.fields(cls)]


@dataclasses.dataclass
class InstructExample:
    """Instruction-following record: system prompt + instruction + answer."""

    id: str
    system_prompt: str
    question: str
    answer: Optional[str] = None

    def render(
        self,
        *,
        task: str = "causal",  # "causal" | "seq2seq"
        mode: str = "train",  # "train" | "generative" | "perplexity" | "eval"
    ) -> dict:
        """Prompt assembly (capability of get_example,
        advance_instruct_sample.py:60-100):

        - seq2seq: {"prompt", "target"} always split.
        - causal train: one concatenated text, plus "prompt_len_chars" so
          the collator can mask the prompt portion of the labels
          (completion-only training) by construction.
        - causal generative eval: prompt ends right after the response
          marker; target separate.
        - causal perplexity eval: full concatenated text.
        - mode="eval" returns both generative + perplexity fields.
        """
        system = f"{self.system_prompt}\n\n" if self.system_prompt else ""
        prompt = f"{system}{QUESTION_PREFIX}\n{self.question}\n\n"
        answer = f"{self.answer}" if self.answer is not None else ""

        if task == "seq2seq":
            return {"prompt": prompt, "target": answer}
        if task != "causal":
            raise ValueError(f"unknown task {task!r}")

        gen_prompt = prompt + RESPONSE_PREFIX + "\n"
        full = gen_prompt + answer
        if mode == "train":
            return {"text": full, "prompt_len_chars": len(gen_prompt)}
        out: dict = {}
        if mode in ("generative", "eval"):
            out["prompt"] = gen_prompt
            out["target"] = answer
        if mode in ("perplexity", "eval"):
            out["perplexity"] = full
        if not out:
            raise ValueError(f"unknown mode {mode!r}")
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def keys(cls) -> list[str]:
        return [f.name for f in dataclasses.fields(cls)]


SCHEMAS = {"qa": QAExample, "instruct": InstructExample}


_ALPACA_KEYS = {"instruction", "input", "output", "id"}


def _from_alpaca(record: dict) -> dict:
    """A raw alpaca-layout record as an instruct record (etl/parsers/
    builtin.py GenericInstructParser, with an empty system prompt)."""
    question = str(record["instruction"])
    if record.get("input"):
        question = f"{question}\n{record['input']}"
    answer = record.get("output")
    return {"id": str(record.get("id", "")), "system_prompt": "", "question": question,
            "answer": None if answer in (None, "") else str(answer)}


def parse_record(record: dict, schema: str):
    """dict → schema instance, validating fields (capability of
    DataParser.validate, reference data_parser.py:95-102)."""
    cls = SCHEMAS[schema]
    if schema == "instruct" and "instruction" in record and set(record) <= _ALPACA_KEYS:
        record = _from_alpaca(record)
    valid = set(cls.keys())
    unknown = set(record) - valid
    if unknown:
        raise ValueError(
            f"record has unknown fields {sorted(unknown)} for schema "
            f"{schema!r} (valid: {sorted(valid)})"
        )
    return cls(**record)
