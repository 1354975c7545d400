"""Sparse lexical scoring (Okapi BM25) for hybrid retrieval.

A copy of ``vietnamese_qa_system_tpu/engine/lexical.py``: ``tokenize``,
the incremental ``BM25Index`` (its frozen posting arrays extended after
each add, scored by the native scorer), the ``bm25.json`` layout of
``save`` / ``load`` and ``fuse_scores``.  The inverted index lives on the
host; the dense side stays on the card and the fusion runs over a small
candidate union per query (engine/query.py).

The native scorer is ``csrc/bm25.cpp``, built by ``g++ -O3 -shared -fPIC``
at first use into ``csrc/build/`` under a name keyed on a hash of the
source and the flags.  A host without g++ scores with the Python loop
(the behavioural reference: the same double math term for term) and says
so once on stderr.  ``BM25Index.scored`` counts the queries each scorer
answered.

Tokenization: lowercase unicode word split -- Vietnamese is written as
space-separated syllables, so word-level BM25 is the natural unit.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import threading
from typing import Optional, Sequence

_WORD = re.compile(r"\w+", re.UNICODE)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BM25_SRC = os.path.join(CSRC, "bm25.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def tokenize(text: str) -> list[str]:
    return _WORD.findall(text.lower())


def bm25_lib_path() -> str:
    """The library of ``csrc/bm25.cpp``, keyed on its source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(BM25_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(CSRC, "build", f"libvqa_bm25_{h.hexdigest()[:16]}.so")


def native_bm25() -> Optional[ctypes.CDLL]:
    """The native scorer, built on first use; None (said once on stderr)
    when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = bm25_lib_path()
        try:
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, BM25_SRC], check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as exc:
            print(f"BM25: the native scorer ({BM25_SRC}) could not be built or loaded ({exc}); scoring with the "
                  "Python loop", file=sys.stderr, flush=True)
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.bm25_score.argtypes = [i64p, f64p, ctypes.c_int32, i64p, f64p, f64p, ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, i64p, f64p]
        lib.bm25_score.restype = ctypes.c_int64
        _lib = lib
        return _lib


class BM25Index:
    """Incremental Okapi BM25 inverted index keyed by global doc id.

    Standard parameters k1=1.2, b=0.75 (txtai's scoring defaults).
    ``search`` returns max-normalized scores so they fuse with unit-cosine
    dense scores on a comparable [0, 1] scale.  ``native=False`` scores
    with the Python loop.
    """

    def __init__(self, k1: float = 1.2, b: float = 0.75, *, native: bool = True):
        self.k1 = k1
        self.b = b
        self.native = native
        self.scored = {"native": 0, "python": 0}  # queries answered by each scorer
        self.postings: dict[str, list[tuple[int, int]]] = collections.defaultdict(list)
        self.doc_len: dict[int, int] = {}
        self.total_len = 0
        # frozen contiguous posting arrays for the native scorer; built
        # lazily, extended incrementally after adds (a full rebuild would be
        # an O(total postings) Python loop under the server's index lock)
        self._frozen = None
        self._stale = False

    # ------------------------------------------------------------------ build

    def add(self, ids: Sequence[int], texts: Sequence[str]) -> None:
        if len(ids) != len(texts):
            raise ValueError(f"{len(ids)} ids for {len(texts)} texts")
        for gid, text in zip(ids, texts):
            gid = int(gid)
            if gid in self.doc_len:
                raise ValueError(f"doc id {gid} already indexed")
            toks = tokenize(text)
            self.doc_len[gid] = len(toks)
            self.total_len += len(toks)
            for term, tf in collections.Counter(toks).items():
                self.postings[term].append((gid, tf))
        self._stale = True

    @property
    def n_docs(self) -> int:
        return len(self.doc_len)

    # ----------------------------------------------------------------- query

    def _idf(self, term: str) -> float:
        df = len(self.postings.get(term, ()))
        if not df:
            return 0.0
        # BM25+-style floor avoids negative idf for very common terms
        return max(math.log((self.n_docs - df + 0.5) / (df + 0.5) + 1.0), 1e-9)

    def _freeze(self):
        """Flatten postings into contiguous per-term arrays.  Incremental:
        postings lists are append-only, so each freeze walks only the
        postings added since the last one and appends a (start, end)
        segment per touched term (``ranges`` maps term -> segment list)."""
        import numpy as np

        if self._frozen is None:
            self._frozen = (np.empty(0, np.int64), np.empty(0, np.float64), np.empty(0, np.float64), {}, {})
        f_gids, f_tf, f_dlen, ranges, counts = self._frozen
        new_g: list[int] = []
        new_tf: list[float] = []
        new_dl: list[float] = []
        pos = len(f_gids)
        for term, plist in self.postings.items():
            done = counts.get(term, 0)
            fresh = len(plist) - done
            if not fresh:
                continue
            for gid, tf in plist[done:]:
                new_g.append(gid)
                new_tf.append(float(tf))
                new_dl.append(float(self.doc_len[gid]))
            ranges.setdefault(term, []).append((pos, pos + fresh))
            pos += fresh
            counts[term] = len(plist)
        if new_g:
            f_gids = np.concatenate([f_gids, np.asarray(new_g, np.int64)])
            f_tf = np.concatenate([f_tf, np.asarray(new_tf, np.float64)])
            f_dlen = np.concatenate([f_dlen, np.asarray(new_dl, np.float64)])
        self._frozen = (f_gids, f_tf, f_dlen, ranges, counts)
        self._stale = False
        return self._frozen

    def _scores_native(self, terms, lib):
        import numpy as np

        if self._frozen is None or self._stale:
            self._freeze()
        f_gids, f_tf, f_dlen, ranges, _counts = self._frozen
        segs = []
        idfs = []
        for term in terms:
            idf = self._idf(term)
            if not idf or term not in ranges:
                continue
            for seg in ranges[term]:  # one idf per contiguous segment
                segs.append(seg)
                idfs.append(idf)
        if not segs:
            return {}
        g = np.concatenate([f_gids[s:e] for s, e in segs])
        tf = np.concatenate([f_tf[s:e] for s, e in segs])
        dl = np.concatenate([f_dlen[s:e] for s, e in segs])
        off = np.zeros(len(segs) + 1, np.int64)
        np.cumsum([e - s for s, e in segs], out=off[1:])
        idf_arr = np.asarray(idfs, np.float64)
        out_g = np.empty(len(g), np.int64)
        out_s = np.empty(len(g), np.float64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        n = lib.bm25_score(
            off.ctypes.data_as(i64p), idf_arr.ctypes.data_as(f64p), len(segs),
            np.ascontiguousarray(g).ctypes.data_as(i64p), np.ascontiguousarray(tf).ctypes.data_as(f64p),
            np.ascontiguousarray(dl).ctypes.data_as(f64p), self.k1, self.b, self.total_len / self.n_docs,
            out_g.ctypes.data_as(i64p), out_s.ctypes.data_as(f64p),
        )
        return dict(zip(out_g[:n].tolist(), out_s[:n].tolist()))

    def scores(self, query: str) -> dict[int, float]:
        """Raw BM25 scores for every matching doc id: the native scorer
        when it is built, else the Python loop (the same double math term
        for term; only the accumulation order differs)."""
        if not self.n_docs:
            return {}
        terms = set(tokenize(query))
        lib = native_bm25() if self.native else None
        if lib is not None:
            self.scored["native"] += 1
            return self._scores_native(sorted(terms), lib)
        self.scored["python"] += 1
        avg_len = self.total_len / self.n_docs
        out: dict[int, float] = collections.defaultdict(float)
        for term in terms:
            idf = self._idf(term)
            if not idf:
                continue
            for gid, tf in self.postings[term]:
                denom = tf + self.k1 * (1 - self.b + self.b * self.doc_len[gid] / avg_len)
                out[gid] += idf * tf * (self.k1 + 1) / denom
        return dict(out)

    def search(self, query: str, k: int = 10) -> list[tuple[int, float]]:
        """Top-k (id, max-normalized score) pairs, best first."""
        raw = self.scores(query)
        if not raw:
            return []
        top = sorted(raw.items(), key=lambda kv: -kv[1])[:k]
        peak = top[0][1]
        return [(gid, s / peak) for gid, s in top]

    # ---------------------------------------------------------------- persist

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"k1": self.k1, "b": self.b, "doc_len": list(self.doc_len.items()),
                       "postings": {t: p for t, p in self.postings.items()}}, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str, *, native: bool = True) -> "BM25Index":
        with open(path) as f:
            data = json.load(f)
        idx = cls(k1=data["k1"], b=data["b"], native=native)
        idx.doc_len = {int(g): int(n) for g, n in data["doc_len"]}
        idx.total_len = sum(idx.doc_len.values())
        for term, plist in data["postings"].items():
            idx.postings[term] = [(int(g), int(tf)) for g, tf in plist]
        return idx


def fuse_scores(dense: dict[int, float], sparse: dict[int, float], weight: float) -> dict[int, float]:
    """weight * dense + (1 - weight) * sparse over the candidate union
    (txtai's hybrid combination).  A missing side contributes 0."""
    out = {}
    for gid in set(dense) | set(sparse):
        out[gid] = weight * dense.get(gid, 0.0) + (1 - weight) * sparse.get(gid, 0.0)
    return out
