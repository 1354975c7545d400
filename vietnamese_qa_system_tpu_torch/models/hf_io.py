"""Read and write a local Hugging Face model directory without
``transformers`` or ``safetensors``.

``read_config`` returns ``config.json`` as a dict; :class:`Checkpoint`
reads the weights, one tensor at a time, from whichever of these the
directory holds (in this order): ``model.safetensors``, sharded
safetensors behind ``model.safetensors.index.json``,
``pytorch_model.bin``, sharded ``.bin`` files behind
``pytorch_model.bin.index.json``.

A safetensors file is an 8-byte little-endian header length, a JSON
header ({name: {"dtype", "shape", "data_offsets"}}, plus an optional
``__metadata__``) and the raw bytes.  A tensor is read when it is asked
for, by positional reads (``os.preadv``) of its byte range into a fresh
tensor, so reading a multi-gigabyte checkpoint holds one tensor at a time
in host memory.  (A mapping of the file does not: on the H100 machine the
pages of a private mapping stayed resident after ``madvise(MADV_DONTNEED)``
until the mapping closed.)  ``.bin`` files load through
``torch.load(weights_only=True, mmap=True)``, whose tensors are views of
the mapped file.

The write half leaves a directory as ``save_pretrained(...,
safe_serialization=False)`` does: ``config.json`` and
``generation_config.json`` (:func:`write_config`) and the weights as
``torch.save`` of contiguous CPU tensors in ``pytorch_model.bin``, or,
above :data:`MAX_SHARD_BYTES`, in ``pytorch_model-0000i-of-0000n.bin``
shards behind ``pytorch_model.bin.index.json`` (:class:`BinWriter`, which
holds at most one shard in host memory).
"""

from __future__ import annotations

import json
import os
import struct
from collections.abc import Iterator, Mapping

import torch

# safetensors dtype codes -> torch dtypes
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
SAFETENSORS, SAFETENSORS_INDEX = "model.safetensors", "model.safetensors.index.json"
BIN, BIN_INDEX = "pytorch_model.bin", "pytorch_model.bin.index.json"
# transformers' default max_shard_size ("5GB"); a test may lower it
MAX_SHARD_BYTES = 5 * 10**9


def read_config(model_dir: str) -> dict:
    """``config.json`` of ``model_dir``."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{model_dir}: no config.json (not a Hugging Face model directory)")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class SafetensorsFile:
    """One ``.safetensors`` file: its header, and its tensors read one at a
    time."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        (n,) = struct.unpack("<Q", os.pread(self._fd, 8, 0))
        header = json.loads(os.pread(self._fd, n, 8))
        self._base = 8 + n
        header.pop("__metadata__", None)
        self.entries = header
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {e['dtype']}, which the reader does not take")

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        start, end = (self._base + o for o in e["data_offsets"])
        dtype = DTYPES[e["dtype"]]
        raw = torch.empty(end - start, dtype=torch.uint8)
        view, done = memoryview(raw.numpy()), 0
        while done < len(view):
            got = os.preadv(self._fd, [view[done:]], start + done)
            if got <= 0:
                raise OSError(f"{self.path}: file ends inside tensor {name!r}")
            done += got
        return raw.view(dtype).reshape(e["shape"])

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class _BinFile:
    """One ``pytorch_model.bin`` file, loaded as views of its mapping."""

    def __init__(self, path: str):
        self.path = path
        self._sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)

    def keys(self):
        return self._sd.keys()

    def get(self, name: str) -> torch.Tensor:
        return self._sd[name].clone()

    def close(self) -> None:
        self._sd = {}


class Checkpoint(Mapping):
    """The weights of a local HF directory as a read-only mapping of
    tensor names to CPU tensors in their stored dtype; each lookup reads
    that tensor (a copy).  Sharded files open on first use."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self._files: dict[str, object] = {}
        self._where: dict[str, str] = {}
        for single, index, opener in ((SAFETENSORS, SAFETENSORS_INDEX, SafetensorsFile), (BIN, BIN_INDEX, _BinFile)):
            if os.path.exists(os.path.join(model_dir, single)):
                self._opener = opener
                self._where = {name: single for name in self._open(single).keys()}
                break
            if os.path.exists(os.path.join(model_dir, index)):
                self._opener = opener
                with open(os.path.join(model_dir, index), encoding="utf-8") as f:
                    self._where = dict(json.load(f)["weight_map"])
                break
        else:
            raise FileNotFoundError(
                f"{model_dir}: no weights ({SAFETENSORS}, {SAFETENSORS_INDEX}, {BIN} or {BIN_INDEX})")

    def _open(self, file: str):
        if file not in self._files:
            self._files[file] = self._opener(os.path.join(self.model_dir, file))
        return self._files[file]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._open(self._where[name]).get(name)

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files = {}

    def __enter__(self) -> "Checkpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the write half
# ---------------------------------------------------------------------------


def write_json(path: str, obj: dict) -> None:
    """``obj`` as transformers writes its config files: keys sorted, two
    spaces of indent, a newline at the end."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(obj, indent=2, sort_keys=True) + "\n")


def write_config(out_dir: str, config: dict, generation: dict) -> None:
    """``config.json`` and ``generation_config.json`` of ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    write_json(os.path.join(out_dir, "config.json"), config)
    write_json(os.path.join(out_dir, "generation_config.json"), generation)


def _storage_bytes(tensors: dict, seen: set) -> int:
    """Bytes of the storages of ``tensors`` not in ``seen`` (a tied weight
    is stored once), adding them to ``seen``."""
    n = 0
    for t in tensors.values():
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


class BinWriter:
    """The weights of an HF directory as ``pytorch_model.bin``, or as
    shards behind its index when they pass :data:`MAX_SHARD_BYTES`.  Tensors come in
    groups (:meth:`add`): a group never straddles two shards, and a shard
    is written as soon as the next group would take it past the limit, so
    the host holds about one shard.  Tensors of one group may share storage
    (a tied head): ``torch.save`` stores it once."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self._shard: dict = {}
        self._shard_bytes = 0
        self._seen: set = set()
        self._files: list[list[str]] = []  # the names of each written shard
        self.total_bytes = 0

    def add(self, tensors: dict) -> None:
        host: dict = {}  # id of a given tensor -> its host copy: a tied pair stays one storage
        for v in tensors.values():
            if id(v) not in host:
                t = v.detach().cpu().contiguous()
                # torch.save writes whole storages: a view of a larger one is copied out
                host[id(v)] = t if t.untyped_storage().nbytes() == t.nbytes else t.clone()
        tensors = {k: host[id(v)] for k, v in tensors.items()}
        seen = set(self._seen)
        n = _storage_bytes(tensors, seen)
        if self._shard and self._shard_bytes + n > MAX_SHARD_BYTES:
            self._flush()
            seen = set()
            n = _storage_bytes(tensors, seen)
        self._seen = seen
        self._shard.update(tensors)
        self._shard_bytes += n
        self.total_bytes += n

    def _flush(self) -> None:
        torch.save(self._shard, os.path.join(self.out_dir, f"{BIN}.part{len(self._files)}"))
        self._files.append(list(self._shard))
        self._shard, self._shard_bytes, self._seen = {}, 0, set()

    def close(self) -> list[str]:
        """Write what is left; returns the files written."""
        if self._shard or not self._files:
            self._flush()
        n = len(self._files)
        if n == 1:
            os.replace(os.path.join(self.out_dir, f"{BIN}.part0"), os.path.join(self.out_dir, BIN))
            return [BIN]
        names = [f"pytorch_model-{i + 1:05d}-of-{n:05d}.bin" for i in range(n)]
        weight_map = {}
        for i, (name, keys) in enumerate(zip(names, self._files)):
            os.replace(os.path.join(self.out_dir, f"{BIN}.part{i}"), os.path.join(self.out_dir, name))
            weight_map.update({k: name for k in keys})
        write_json(os.path.join(self.out_dir, BIN_INDEX),
                   {"metadata": {"total_size": self.total_bytes}, "weight_map": dict(sorted(weight_map.items()))})
        return names + [BIN_INDEX]
