"""The byte tokenizer's rule and the recursive character chunker, written
out again from their published behaviour (UTF-8 bytes shifted past four
special ids; langchain's ``RecursiveCharacterTextSplitter`` at a chunk
size and a fractional overlap, pieces under ``min_chunk`` merged into the
one before)."""

from __future__ import annotations

import numpy as np

N_SPECIAL = 4  # pad, bos, eos, unk
SEPARATORS = ("\n\n", "\n", ". ", " ", "")


def byte_ids(texts, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Right-padded (ids, mask) int64 of ``texts``, truncated to ``max_len``."""
    ids = np.zeros((len(texts), max_len), np.int64)
    mask = np.zeros((len(texts), max_len), np.int64)
    for r, t in enumerate(texts):
        b = np.frombuffer(t.encode("utf-8"), np.uint8)[:max_len].astype(np.int64) + N_SPECIAL
        ids[r, : len(b)] = b
        mask[r, : len(b)] = 1
    return ids, mask


def _split_on(text: str, sep: str) -> list[str]:
    if sep == "":
        return list(text)
    parts = text.split(sep)
    return [p + sep for p in parts[:-1]] + ([parts[-1]] if parts[-1] else [])


def _pieces(text: str, size: int, seps) -> list[str]:
    if len(text) <= size:
        return [text]
    out = []
    for part in _split_on(text, seps[0]):
        if len(part) <= size:
            out.append(part)
        elif len(seps) > 1:
            out.extend(_pieces(part, size, seps[1:]))
        else:
            out.extend(part[i: i + size] for i in range(0, len(part), size))
    return out


def chunks(text: str, size: int = 512, overlap: float = 0.1, min_chunk: int = 8) -> list[str]:
    keep = int(size * overlap)
    out, cur = [], ""
    for piece in _pieces(text, size, SEPARATORS):
        if len(cur) + len(piece) <= size:
            cur += piece
            continue
        if cur:
            out.append(cur)
            cur = cur[len(cur) - keep:] if keep else ""
        cur += piece
    if cur.strip():
        if len(cur) < min_chunk and out:
            out[-1] += cur
        else:
            out.append(cur)
    return [c.strip() for c in out if c.strip()]
