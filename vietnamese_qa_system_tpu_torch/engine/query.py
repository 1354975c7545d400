"""Query path: encode -> fused top-k -> doc fetch (+ dual-encoder agreement).

Counterpart of ``vietnamese_qa_system_tpu/engine/query.py``.  Hybrid BM25
fusion is not ported yet.  Every top-k mode of the port is exact and takes
k up to ``ops.topk.MAX_K``, so there is no fallback to an exact mode for
large k.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

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
    :class:`~.ivf.IVFIndex`) + optional doc store."""

    def __init__(self, encoder, tokenizer, store, docstore: Optional[DocStore] = None, *,
                 max_len: int = 128, query_batch: int = 256, mode: str = "fast", rerank: int | None = None):
        self.encoder = encoder
        self.tok = tokenizer
        self.store = store
        self.docstore = docstore
        self.max_len = max_len
        self.query_batch = query_batch
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
                if fetch_docs and self.docstore is not None:
                    fetched = self.docstore.get_rows(int(x.id) for x in row)
                    for res, got in zip(row, fetched):
                        if got is not None:
                            res.doc, res.source = got[1], got[2]
                results.append(row)
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
