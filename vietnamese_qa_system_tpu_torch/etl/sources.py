"""Pluggable dataset sources for the parser framework.

The port's copy of ``vietnamese_qa_system_tpu/etl/sources.py``.  A
parser's ``input_path`` is a local JSON array or JSONL file (the default),
or an ``hf://`` spec that streams through ``datasets.load_dataset(
streaming=True)``, which is imported only when such a source is read;
without the ``datasets`` package it raises the JAX package's
``RuntimeError``.

Spec grammar: ``hf://<dataset-name>[@<config>][#<split>]``
(e.g. ``hf://Open-Orca/OpenOrca#train``).
"""

from __future__ import annotations

import itertools
import os
from abc import ABC, abstractmethod
from typing import Iterator, Optional


class DataSource(ABC):
    """One raw dataset: an iterator of record dicts."""

    @abstractmethod
    def iter_records(self) -> Iterator[dict]: ...

    def load(self, max_examples: Optional[int] = None) -> list[dict]:
        it = self.iter_records()
        if max_examples is not None:
            it = itertools.islice(it, max_examples)
        return list(it)

    def exists(self) -> bool:
        return True


class LocalFileSource(DataSource):
    """JSON array or JSONL file on disk (the offline default)."""

    def __init__(self, path: str):
        self.path = path

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def iter_records(self) -> Iterator[dict]:
        from .parser import load_json_or_jsonl

        yield from load_json_or_jsonl(self.path)


class HFDatasetSource(DataSource):
    """A streamed HF dataset: from the Hub when it is reachable, or from
    local dataset directories / ``data_files`` offline."""

    def __init__(self, name: str, *, config: Optional[str] = None, split: str = "train", streaming: bool = True,
                 data_files=None):
        self.name = name
        self.config = config
        self.split = split
        self.streaming = streaming
        self.data_files = data_files

    def iter_records(self) -> Iterator[dict]:
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise RuntimeError(
                "hf:// sources need the `datasets` library; install it or "
                "use a local json/jsonl path"
            ) from e
        ds = load_dataset(self.name, self.config, split=self.split, streaming=self.streaming,
                          data_files=self.data_files)
        for row in ds:
            yield dict(row)


def parse_source_spec(spec: str) -> DataSource:
    """``hf://name[@config][#split]`` -> HFDatasetSource; anything else is
    a local file path."""
    if not spec.startswith("hf://"):
        return LocalFileSource(spec)
    body = spec[len("hf://"):]
    split = "train"
    if "#" in body:
        body, split = body.rsplit("#", 1)
    config = None
    if "@" in body:
        body, config = body.rsplit("@", 1)
    if not body:
        raise ValueError(f"empty dataset name in source spec {spec!r}")
    return HFDatasetSource(body, config=config, split=split)
