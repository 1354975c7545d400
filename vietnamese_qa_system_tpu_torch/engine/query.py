"""Query path: encode -> fused top-k -> doc fetch (+ dual-encoder agreement).

Counterpart of ``vietnamese_qa_system_tpu/engine/query.py``, hybrid BM25
fusion included.  Every top-k mode of the port is exact and takes k up to
``ops.topk.MAX_K``, so there is no fallback to an exact mode for large k;
hybrid search asks the dense side for at most ``MAX_K`` candidates, as the
JAX package caps its non-exact modes at one vector lane.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..ops.topk import MAX_K
from .docstore import DocStore
from .ingest import embed_batches


@dataclasses.dataclass
class SearchResult:
    id: int
    score: float
    doc: Optional[str] = None
    source: Optional[str] = None


class Retriever:
    """One encoder + one index (a flat :class:`VectorStore` or an
    :class:`~.ivf.IVFIndex`) + optional doc store.

    With ``lexical`` (a :class:`~.lexical.BM25Index` over the same global
    ids) and ``hybrid_weight`` below 1, searches run hybrid: dense and BM25
    candidates are unioned and fused at ``hybrid_weight`` (the reference's
    txtai ``Embeddings(hybrid=True)``)."""

    def __init__(self, encoder, tokenizer, store, docstore: Optional[DocStore] = None, *,
                 max_len: int = 128, query_batch: int = 256, lexical=None, hybrid_weight: float = 0.5,
                 mode: str = "fast", rerank: int | None = None):
        self.encoder = encoder
        self.tok = tokenizer
        self.store = store
        self.docstore = docstore
        self.max_len = max_len
        self.query_batch = query_batch
        self.lexical = lexical
        self.hybrid_weight = hybrid_weight
        self.mode = mode
        # two-stage candidate count (store.topk rerank=K'); None = the
        # store's dtype default (auto 4*k on int8_res, off otherwise)
        self.rerank = rerank

    def embed_queries(self, texts: Sequence[str]) -> np.ndarray:
        return embed_batches(self.encoder, self.tok, texts, self.query_batch, self.max_len)

    def search(self, queries: Sequence[str], k: int = 10, *, fetch_docs: bool = True) -> list[list[SearchResult]]:
        # an index smaller than k yields shorter rows (online ingest from empty)
        k_eff = min(k, self.store.size)
        if k_eff <= 0:
            return [[] for _ in queries]
        qvecs = self.embed_queries(queries)
        if self.lexical is not None and self.hybrid_weight < 1.0:
            return self._hybrid_search(queries, qvecs, k_eff, fetch_docs)
        results: list[list[SearchResult]] = []
        bs = self.query_batch
        for i in range(0, len(qvecs), bs):
            block = qvecs[i: i + bs]
            n = len(block)
            if n < bs:
                block = np.pad(block, ((0, bs - n), (0, 0)))
            rr = None if self.rerank is None else max(self.rerank, k_eff)
            scores, ids = self.store.topk(block, k_eff, mode=self.mode, rerank=rr)
            scores = scores[:n].cpu().numpy()
            ids = ids[:n].cpu().numpy()
            for r in range(n):
                row = [SearchResult(int(ids[r, j]), float(scores[r, j])) for j in range(k_eff)]
                results.append(self._fetch(row, fetch_docs))
        return results

    def _fetch(self, row: list[SearchResult], fetch_docs: bool) -> list[SearchResult]:
        if fetch_docs and self.docstore is not None:
            fetched = self.docstore.get_rows(int(x.id) for x in row)
            for res, got in zip(row, fetched):
                if got is not None:
                    res.doc, res.source = got[1], got[2]
        return row

    def _dense_candidates(self, qvecs: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
        """The index's top-m (scores, ids) of each query vector, on the host."""
        bs = self.query_batch
        dense_s = np.zeros((len(qvecs), m), np.float32)
        dense_i = np.zeros((len(qvecs), m), np.int64)
        for i in range(0, len(qvecs), bs):
            block = qvecs[i: i + bs]
            n = len(block)
            if n < bs:
                block = np.pad(block, ((0, bs - n), (0, 0)))
            rr = None if self.rerank is None else max(self.rerank, m)
            s, ids = self.store.topk(block, m, mode=self.mode, rerank=rr)
            dense_s[i: i + n] = s[:n].cpu().numpy()
            dense_i[i: i + n] = ids[:n].cpu().numpy()
        return dense_s, dense_i

    def _hybrid_search(self, queries, qvecs, k: int, fetch_docs: bool):
        """Fuse dense and BM25 scores over the candidate union.

        Dense candidates come from the index's top-k on the card, BM25
        candidates from the host inverted index, and the exact dense scores
        of BM25-only candidates from a small gather (``get_vectors``).
        Dense cosine is clamped to [0, 1] and BM25 max-normalized so both
        sides fuse on one scale."""
        from .lexical import fuse_scores

        m = min(max(4 * k, 20), self.store.size, MAX_K)
        dense_s, dense_i = self._dense_candidates(qvecs, m)
        results: list[list[SearchResult]] = []
        w = self.hybrid_weight
        for r, query in enumerate(queries):
            dense = {int(g): max(float(s), 0.0) for g, s in zip(dense_i[r], dense_s[r]) if g >= 0}
            sparse = dict(self.lexical.search(query, k=m))
            fused = fuse_scores(dense, sparse, w)
            # exact dense scores for BM25-only candidates
            missing = [g for g in sparse if g not in dense]
            if missing:
                exact = self.store.get_vectors(missing) @ qvecs[r]
                for g, s in zip(missing, exact):
                    fused[g] = w * max(float(s), 0.0) + (1 - w) * sparse[g]
            top = sorted(fused.items(), key=lambda kv: -kv[1])[:k]
            results.append(self._fetch([SearchResult(int(g), float(s)) for g, s in top], fetch_docs))
        return results


class DualRetriever:
    """Two independent encoder + index pairs queried together with the
    agreement accept rule."""

    def __init__(self, retriever_a: Retriever, retriever_b: Retriever, *, threshold: float = 0.4):
        self.a = retriever_a
        self.b = retriever_b
        self.threshold = threshold

    def search(self, queries, k: int = 1):
        """The agreed top hit per query, or None when the encoders disagree
        or the score sum is low."""
        res_a = self.a.search(queries, k=max(k, 1))
        res_b = self.b.search(queries, k=max(k, 1))
        return dual_agreement(res_a, res_b, self.threshold)


def dual_agreement(results_a: list[list[SearchResult]], results_b: list[list[SearchResult]],
                   threshold: float = 0.4) -> list[Optional[SearchResult]]:
    """Accept the top-1 hit when both retrievers agree on the id AND the
    summed scores clear the threshold."""
    out = []
    for ra, rb in zip(results_a, results_b):
        if not ra or not rb:
            out.append(None)
            continue
        top_a, top_b = ra[0], rb[0]
        if top_a.id == top_b.id and (top_a.score + top_b.score) > threshold:
            out.append(SearchResult(top_a.id, top_a.score + top_b.score, top_a.doc, top_a.source))
        else:
            out.append(None)
    return out
