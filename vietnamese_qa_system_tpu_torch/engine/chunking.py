"""Recursive character chunking for corpus ingestion.

A copy of ``vietnamese_qa_system_tpu/engine/chunking.py`` (whose package
imports jax on import).

Capability of the reference's langchain `RecursiveCharacterTextSplitter`
usage (reference inference_pipeline/db_utils/setup_docs_db.py:25-33:
chunk_size=512, 10% overlap) without the langchain dependency: greedy
splitting on a separator hierarchy with character-count windows + overlap.
"""

from __future__ import annotations

SEPARATORS = ["\n\n", "\n", ". ", " ", ""]


def _split_on(text: str, sep: str) -> list[str]:
    if sep == "":
        return list(text)
    parts = text.split(sep)
    # keep separators attached so joins reconstruct the text
    return [p + sep for p in parts[:-1]] + ([parts[-1]] if parts[-1] else [])


def _recursive_pieces(text: str, chunk_size: int, seps) -> list[str]:
    """Pieces each <= chunk_size, splitting on the coarsest separator that
    produces small-enough fragments."""
    if len(text) <= chunk_size:
        return [text]
    sep, rest = seps[0], seps[1:]
    out = []
    for part in _split_on(text, sep):
        if len(part) <= chunk_size:
            out.append(part)
        elif rest:
            out.extend(_recursive_pieces(part, chunk_size, rest))
        else:
            out.extend(
                part[i : i + chunk_size] for i in range(0, len(part), chunk_size)
            )
    return out


def chunk_text(
    text: str,
    chunk_size: int = 512,
    overlap: float = 0.1,
    *,
    min_chunk: int = 8,
) -> list[str]:
    """Split `text` into ~chunk_size-char chunks with fractional overlap.

    Matches the reference's ingestion granularity (512 chars, 10% overlap,
    setup_docs_db.py:26-27).  Chunks shorter than `min_chunk` are merged
    into their predecessor.
    """
    pieces = _recursive_pieces(text, chunk_size, SEPARATORS)
    keep = int(chunk_size * overlap)
    chunks: list[str] = []
    cur = ""
    for piece in pieces:
        if len(cur) + len(piece) <= chunk_size:
            cur += piece
            continue
        if cur:
            chunks.append(cur)
            cur = cur[len(cur) - keep:] if keep else ""
        cur += piece
    if cur.strip():
        if len(cur) < min_chunk and chunks:
            chunks[-1] += cur
        else:
            chunks.append(cur)
    return [c.strip() for c in chunks if c.strip()]
