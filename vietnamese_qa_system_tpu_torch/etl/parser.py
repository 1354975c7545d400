"""Dataset parser framework: enforced read → convert → save pipeline.

Capability of the reference's `DataParser` ABC
(reference src/data/features/final_storge_converted/data_parser.py:36-370):
subclasses implement ``read`` (load a raw dataset) and ``convert`` (map to
the framework's example schema); the base provides record validation,
id generation, random-context injection ("Lost in the Middle" augmentation,
data_parser.py:129-158), optional en→vi translation with the code filter
as a translate-skip gate (post_translate_validate, data_parser.py:104-123),
and JSONL output.  The read/convert base-call contract is enforced at
runtime (the reference used the ForceBaseCallMeta metaclass;
utils/contracts.py provides the equivalent, used here via the same
mechanism on the lifecycle hooks).

The port's copy of ``vietnamese_qa_system_tpu/etl/parser.py`` (the
JAX module imports jax through ``core/profiling.py``; the port's
``timeit`` is its own).  Its output files equal the JAX package's,
byte for byte, for the same inputs and seed.
"""

from __future__ import annotations

import json
import os
import random
from abc import ABC, abstractmethod
from typing import Optional, Sequence

from ..core.profiling import timeit
from ..data.schemas import generate_id, parse_record
from ..utils.contracts import BaseCallEnforcedMeta, enforce_base_call
from ..utils.logging import get_logger
from .filters import have_code
from .normalize import normalize_tones
from .translate import NullTranslator, Translator, translate_texts

logger = get_logger("vqa_tpu.etl")


class _ABCEnforced(BaseCallEnforcedMeta, type(ABC)):
    pass


class DataParser(ABC, metaclass=_ABCEnforced):
    """Subclass contract:

    - ``read()``  must call ``super().read()`` and set ``self.raw``.
    - ``convert()`` must call ``super().convert()`` and set
      ``self.converted`` to a list of schema dicts.
    - ``run()`` drives read → convert → (translate) → save.
    """

    schema: str = "instruct"  # "qa" | "instruct"
    translatable_fields: Sequence[str] = ("system_prompt", "question", "answer")

    def __init__(
        self,
        input_path: Optional[str],
        output_dir: str,
        *,
        name: Optional[str] = None,
        seed: int = 42,
        do_translate: bool = False,
        translator: Optional[Translator] = None,
        normalize: bool = True,
        code_threshold: int = 5,
        ctx_pool: Optional[Sequence[str]] = None,
        max_ctx_inject: int = 2,
        source=None,
    ):
        from .sources import parse_source_spec

        self.input_path = input_path
        # pluggable raw source (etl/sources.py): explicit DataSource, an
        # hf:// spec, or (default) the local json/jsonl path — the
        # reference's parsers stream from the Hub the same way
        self.source = source or (
            parse_source_spec(input_path) if input_path is not None else None
        )
        self.output_dir = output_dir
        self.name = name or type(self).__name__
        self.rng = random.Random(seed)
        self.do_translate = do_translate
        self.translator = translator or NullTranslator()
        self.normalize = normalize
        self.code_threshold = code_threshold
        self.ctx_pool = list(ctx_pool) if ctx_pool else []
        self.max_ctx_inject = max_ctx_inject
        self.raw = None
        self.converted: Optional[list[dict]] = None
        self.stats = {"converted": 0, "translate_skipped_code": 0}

    # ----------------------------------------------------------- lifecycle

    @enforce_base_call
    @abstractmethod
    def read(self) -> None:
        """Load the raw dataset into self.raw."""
        if self.source is not None and not self.source.exists():
            raise FileNotFoundError(self.input_path)

    def load_raw(self, max_examples: Optional[int] = None) -> list[dict]:
        """Materialize the source's records (hf:// specs stream)."""
        if self.source is None:
            raise RuntimeError(f"{self.name}: no input source configured")
        return self.source.load(max_examples)

    @enforce_base_call
    @abstractmethod
    def convert(self) -> None:
        """Map self.raw into self.converted (list of schema dicts)."""
        if self.raw is None:
            raise RuntimeError("convert() called before read()")

    def new_id(self) -> str:
        return generate_id(self.rng)

    # --------------------------------------------------------- enrichment

    def inject_random_contexts(self, record: dict) -> dict:
        """Mix unrelated passages into the documents list and shuffle —
        content-level long-context robustness (reference
        data_parser.py:129-158, motivated by 'Lost in the Middle')."""
        if self.schema != "qa" or not self.ctx_pool:
            return record
        docs = list(record.get("documents", []))
        n = self.rng.randint(0, self.max_ctx_inject)
        for _ in range(n):
            docs.append(self.rng.choice(self.ctx_pool))
        self.rng.shuffle(docs)
        record = dict(record)
        record["documents"] = docs
        return record

    def _translate_all(self) -> None:
        """Translate text fields of non-code records (the code filter is a
        skip gate: reference post_translate_validate, data_parser.py:104-123)."""
        assert self.converted is not None
        idx_map: list[tuple[int, str]] = []
        texts: list[str] = []
        for i, rec in enumerate(self.converted):
            joined = " ".join(
                str(rec.get(f, "")) for f in self.translatable_fields
            )
            if have_code(joined, self.code_threshold)[0]:
                self.stats["translate_skipped_code"] += 1
                continue
            for f in self.translatable_fields:
                if rec.get(f):
                    idx_map.append((i, f))
                    texts.append(str(rec[f]))
        translated = translate_texts(texts, self.translator)
        for (i, f), text in zip(idx_map, translated):
            self.converted[i][f] = text

    # --------------------------------------------------------------- save

    @timeit
    def save(self) -> str:
        """Validate every record against the schema, normalize tones,
        write JSONL (reference save property, data_parser.py:335-370)."""
        if self.converted is None:
            raise RuntimeError("save() called before convert()")
        if self.do_translate:
            self._translate_all()
        os.makedirs(self.output_dir, exist_ok=True)
        suffix = "_translated" if self.do_translate else ""
        path = os.path.join(self.output_dir, f"{self.name}{suffix}.jsonl")
        n = 0
        with open(path, "w", encoding="utf-8") as f:
            for rec in self.converted:
                rec = self.inject_random_contexts(rec)
                parse_record(rec, self.schema)  # raises on schema mismatch
                if self.normalize:
                    rec = {
                        k: normalize_tones(v) if isinstance(v, str) else v
                        for k, v in rec.items()
                    }
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
                n += 1
        self.stats["converted"] = n
        logger.info("%s: wrote %d records -> %s", self.name, n, path)
        return path

    def run(self) -> str:
        self.read()
        self.convert()
        return self.save()


def load_json_or_jsonl(path: str) -> list[dict]:
    """Accept a JSON array file or JSONL (reformat_data capability,
    reference src/data/features/data_utils.py:8-21)."""
    with open(path, encoding="utf-8") as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


def reformat_data(paths: Sequence[str], suffix: str = "Formated") -> list[str]:
    """JSON array → JSONL files (pyarrow-friendly), reference data_utils.py:8."""
    out = []
    for path in paths:
        records = load_json_or_jsonl(path)
        base, ext = os.path.splitext(path)
        new_path = f"{base}{suffix}.jsonl"
        with open(new_path, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
        out.append(new_path)
    return out
