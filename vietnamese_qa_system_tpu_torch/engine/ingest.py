"""Batched embed-and-write ingest pipeline.

Counterpart of ``vietnamese_qa_system_tpu/engine/ingest.py``: texts -> host
tokenize (fixed shapes) -> encoder forward on the device -> unit vectors ->
vector store + doc store (+ the BM25 term index of hybrid retrieval).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data.tokenizer import batch_encode
from .chunking import chunk_text
from .docstore import DocStore
from .store import VectorStore


def embed_batches(encoder, tokenizer, texts: Sequence[str], batch_size: int, max_len: int) -> np.ndarray:
    """Encode texts to (N, D) f32 unit vectors in fixed (batch_size, max_len)
    batches; short batches are padded with empty strings, as in the JAX
    package.  Batch i+1 is tokenized and launched before batch i is
    fetched, so host tokenization overlaps the device forward."""
    out = []
    pending = None  # (device embeddings, valid rows) still in flight
    dev = encoder.device
    with torch.inference_mode():
        for i in range(0, len(texts), batch_size):
            chunk = list(texts[i: i + batch_size])
            n = len(chunk)
            chunk += [""] * (batch_size - n)
            ids, mask = batch_encode(tokenizer, chunk, max_len)
            emb = encoder.sentence_embed(
                torch.from_numpy(ids).to(dev, torch.long), torch.from_numpy(mask).to(dev, torch.long)
            )
            if pending is not None:
                out.append(pending[0][: pending[1]].cpu().numpy())
            pending = (emb, n)
        if pending is not None:
            out.append(pending[0][: pending[1]].cpu().numpy())
    if not out:
        return np.zeros((0, encoder.cfg.d_model), np.float32)
    return np.concatenate(out, axis=0).astype(np.float32, copy=False)


class IngestPipeline:
    def __init__(self, encoder, tokenizer, store: VectorStore, docstore: Optional[DocStore] = None, *,
                 batch_size: int = 256, max_len: int = 128, lexical=None):
        self.encoder = encoder
        self.tok = tokenizer
        self.store = store
        self.docstore = docstore
        self.batch_size = batch_size
        self.max_len = max_len
        self.lexical = lexical  # a BM25Index over the same global ids, or None

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return embed_batches(self.encoder, self.tok, texts, self.batch_size, self.max_len)

    def add_texts(self, texts: Sequence[str], sources: Optional[Sequence[str]] = None) -> np.ndarray:
        """Embed + index + persist docs.  Returns assigned global ids."""
        return self.index_vectors(self.embed_texts(texts), texts, sources)

    def index_vectors(self, vecs: np.ndarray, texts: Sequence[str],
                      sources: Optional[Sequence[str]] = None) -> np.ndarray:
        """The index/docstore mutation alone, so a server can embed outside
        its index lock.  The docstore row commits first: a failure then
        leaves doc rows without vectors (invisible to search) rather than
        live vectors whose doc fetch returns None."""
        if not isinstance(self.store, VectorStore):
            # the JAX package fails here with an AttributeError (an IVF
            # index has no capacity); the cause, said plainly, nothing added
            raise ValueError(f"ingest adds to a flat VectorStore; this index is a {type(self.store).__name__}: "
                             "ingest into the flat store, then rebuild the IVF index (build-ivf)")
        vecs = np.asarray(vecs, np.float32)
        if sources is not None and len(sources) != len(texts):
            raise ValueError(f"sources length {len(sources)} != texts length {len(texts)}")
        if vecs.ndim != 2 or vecs.shape[1] != self.store.dim:
            raise ValueError(f"expected (E, {self.store.dim}) vectors, got {vecs.shape}")
        if vecs.shape[0] != len(texts):
            raise ValueError(f"vector count {vecs.shape[0]} != text count {len(texts)}")
        if self.store.size + vecs.shape[0] > self.store.capacity:
            raise ValueError(
                f"store full: size={self.store.size} + {vecs.shape[0]} > capacity={self.store.capacity}"
            )
        ids = np.arange(self.store.size, self.store.size + vecs.shape[0], dtype=np.int64)
        if self.docstore is not None:
            self.docstore.insert(ids, list(texts), sources)
        assigned = self.store.add(vecs)
        if not np.array_equal(assigned, ids):
            raise RuntimeError("vector store assigned unexpected ids")
        if self.lexical is not None:
            self.lexical.add(ids, list(texts))
        return ids

    def add_documents(self, documents: Sequence[str], sources: Optional[Sequence[str]] = None, *,
                      chunk_size: int = 512, overlap: float = 0.1) -> np.ndarray:
        """Chunk long documents, then ingest the chunks."""
        chunks, chunk_sources = [], []
        for i, doc in enumerate(documents):
            for c in chunk_text(doc, chunk_size, overlap):
                chunks.append(c)
                chunk_sources.append(sources[i] if sources else None)
        return self.add_texts(chunks, chunk_sources)
