"""Weighted multi-file JSONL dataset and static-shape batching.

A copy of ``vietnamese_qa_system_tpu/data/loader.py`` (standard library and
numpy only): ``QADataLoader`` (per-file mix fractions, schema-driven prompt
assembly, too-long skipping, completion-only label masking, seq2seq
collation, ``group_texts`` packing, seeded per-epoch shuffles, the bucket
ladder of padded widths), ``DataFileSpec`` and ``IGNORE_INDEX``.  Batches
are numpy arrays, bit-identical to the JAX package's.
``shard_for_process`` takes the process index and count explicitly: the
port runs on one device.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Iterator, Optional, Sequence

import numpy as np

from .schemas import parse_record
from .tokenizer import Tokenizer

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class DataFileSpec:
    path: str
    schema: str = "instruct"  # "qa" | "instruct"
    fraction: float = 1.0  # portion of `max_examples` drawn from this file


def _buckets_for(max_len: int) -> list[int]:
    out, b = [], 64
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


class QADataLoader:
    """Build train/eval example streams and static-shape batches."""

    def __init__(
        self,
        tokenizer: Tokenizer,
        *,
        task: str = "causal",  # "causal" | "seq2seq"
        max_len: int = 512,
        target_max_len: int = 256,
        batch_size: int = 8,
        seed: int = 42,
        skip_too_long: bool = True,
        pack: bool = False,
        buckets: Optional[Sequence[int]] = None,
    ):
        self.tok = tokenizer
        self.task = task
        self.max_len = max_len
        self.target_max_len = target_max_len
        self.batch_size = batch_size
        self.seed = seed
        self.skip_too_long = skip_too_long
        self.pack = pack
        self.buckets = list(buckets) if buckets else _buckets_for(max_len)
        # seq2seq labels have their own length budget (target_max_len), so
        # they need their own ladder — reusing the input ladder would cap
        # label width at max_len and overflow when target_max_len > max_len.
        self.label_buckets = (
            list(buckets) if buckets else _buckets_for(target_max_len)
        )
        self.stats = {"skipped_too_long": 0, "loaded": 0}

    # ------------------------------------------------------------- loading

    def load_examples(
        self,
        files: Sequence[DataFileSpec],
        *,
        max_examples: Optional[int] = None,
        split: str = "train",
    ) -> list[dict]:
        """Stream each file, draw its fraction of the budget, render
        prompts/targets (template RNG seeded per split for reproducibility)."""
        rng = random.Random(f"{self.seed}-{split}")
        out: list[dict] = []
        for spec in files:
            budget = None
            if max_examples is not None:
                budget = max(1, int(max_examples * spec.fraction))
            n_from_file = 0
            with open(spec.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if budget is not None and n_from_file >= budget:
                        break
                    record = json.loads(line)
                    ex = parse_record(record, spec.schema)
                    if spec.schema == "qa":
                        rendered = ex.render(rng)
                        text_fields = {
                            "prompt": rendered["prompt"],
                            "target": rendered["target"],
                        }
                    else:
                        if self.task == "seq2seq":
                            text_fields = ex.render(task="seq2seq")
                        else:
                            r = ex.render(task="causal", mode="train")
                            text_fields = {
                                "prompt": r["text"][: r["prompt_len_chars"]],
                                "target": r["text"][r["prompt_len_chars"]:],
                            }
                    tokenized = self._tokenize(text_fields)
                    if tokenized is None:
                        self.stats["skipped_too_long"] += 1
                        continue
                    out.append(tokenized)
                    n_from_file += 1
        self.stats["loaded"] += len(out)
        return out

    def _tokenize(self, fields: dict) -> Optional[dict]:
        prompt_ids = self.tok.encode(fields["prompt"])
        target_ids = self.tok.encode(fields["target"]) + [self.tok.eos_id]
        if self.task == "seq2seq":
            return {
                "input_ids": prompt_ids[: self.max_len],
                "labels": target_ids[: self.target_max_len],
            }
        total = len(prompt_ids) + len(target_ids)
        if total > self.max_len:
            if self.skip_too_long:
                return None  # reference skips too-long causal examples
            # truncate-from-the-prompt first (keep the completion intact),
            # then hard-cap the target itself: a plain `max_len - len(target)`
            # slice goes negative for over-long targets and would silently
            # truncate the prompt from the END while still exceeding max_len.
            keep_prompt = max(self.max_len - len(target_ids), 0)
            prompt_ids = prompt_ids[:keep_prompt]
            target_ids = target_ids[: self.max_len]
        ids = prompt_ids + target_ids
        # completion-only masking: prompt tokens never contribute to loss
        labels = [IGNORE_INDEX] * len(prompt_ids) + list(target_ids)
        return {"input_ids": ids, "labels": labels}

    # ------------------------------------------------------------- packing

    def pack_examples(self, examples: list[dict], block_len: int) -> list[dict]:
        """group_texts capability (reference dataloader.py:468-481): concat
        all token streams and cut fixed blocks (causal only; labels keep
        their masking)."""
        ids, labels = [], []
        for ex in examples:
            ids.extend(ex["input_ids"])
            labels.extend(ex["labels"])
        n_blocks = len(ids) // block_len
        out = []
        for i in range(n_blocks):
            s = slice(i * block_len, (i + 1) * block_len)
            out.append({"input_ids": ids[s], "labels": labels[s]})
        return out

    # ------------------------------------------------------------ batching

    def _bucket_len(self, n: int, buckets: Optional[Sequence[int]] = None) -> int:
        ladder = self.buckets if buckets is None else buckets
        for b in ladder:
            if n <= b:
                return b
        return ladder[-1]

    def _collate_causal(self, group: list[dict]) -> dict:
        width = self._bucket_len(max(len(ex["input_ids"]) for ex in group))
        b = len(group)
        ids = np.full((b, width), self.tok.pad_id, np.int32)
        mask = np.zeros((b, width), np.int32)
        labels = np.full((b, width), IGNORE_INDEX, np.int32)
        for r, ex in enumerate(group):
            n = min(len(ex["input_ids"]), width)
            ids[r, :n] = ex["input_ids"][:n]
            mask[r, :n] = 1
            labels[r, :n] = ex["labels"][:n]
        return {"input_ids": ids, "attention_mask": mask, "labels": labels}

    def _collate_seq2seq(self, group: list[dict]) -> dict:
        in_w = self._bucket_len(max(len(ex["input_ids"]) for ex in group))
        lb_w = self._bucket_len(
            max(len(ex["labels"]) for ex in group), self.label_buckets
        )
        b = len(group)
        ids = np.full((b, in_w), self.tok.pad_id, np.int32)
        mask = np.zeros((b, in_w), np.int32)
        labels = np.full((b, lb_w), IGNORE_INDEX, np.int32)
        for r, ex in enumerate(group):
            n = min(len(ex["input_ids"]), in_w)
            ids[r, :n] = ex["input_ids"][:n]
            mask[r, :n] = 1
            m = min(len(ex["labels"]), lb_w)
            labels[r, :m] = ex["labels"][:m]
        return {"input_ids": ids, "attention_mask": mask, "labels": labels}

    @staticmethod
    def shard_for_process(examples: list[dict], process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> list[dict]:
        """Each process keeps its strided slice of the examples (this
        process's index and count under ``torch.distributed`` by default,
        core/distributed.py)."""
        from ..core import distributed

        pi = distributed.process_index() if process_index is None else process_index
        pc = distributed.process_count() if process_count is None else process_count
        return examples[pi::pc]

    def batches(
        self,
        examples: list[dict],
        *,
        epoch: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
    ) -> Iterator[dict]:
        """Seeded shuffle → length-sorted bucketing within a shuffle window
        → static-shape batches.  drop_last keeps the global batch static."""
        order = list(range(len(examples)))
        if shuffle:
            random.Random(self.seed + epoch).shuffle(order)
        if self.pack and self.task == "causal":
            packed = self.pack_examples([examples[i] for i in order], self.max_len)
            group_src = packed
            order = list(range(len(packed)))
        else:
            group_src = examples
        collate = (
            self._collate_seq2seq if self.task == "seq2seq" else self._collate_causal
        )
        bs = self.batch_size
        n_full = len(order) // bs
        for i in range(n_full):
            group = [group_src[j] for j in order[i * bs : (i + 1) * bs]]
            yield collate(group)
        if not drop_last and len(order) % bs:
            group = [group_src[j] for j in order[n_full * bs :]]
            yield collate(group)
