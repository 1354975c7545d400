"""IVF (inverted-file) clustered ANN index on one GPU.

Counterpart of ``vietnamese_qa_system_tpu/engine/ivf.py`` for one device
(``n_shards == 1``, like the port's :class:`VectorStore`):

- **Build.**  Spherical k-means over a seeded sample of the flat store
  (the same numpy draws, in the same order, as the JAX package, so the
  sample and the initial centroids are equal), then a nearest-centroid
  assignment of every row.  Both are f32 products of bf16-rounded inputs;
  ties go to the first centroid; the centroid sums are one-hot products
  (no atomics), so a build repeats bit for bit on one card.
- **Fixed-shape buckets.**  Every cluster is a ``cap``-row slab of one
  ``(C, cap, D)`` tensor, padded with ``gid = -1`` rows; rows past a full
  bucket land in a spill region that every query scans.  Quantized codes
  move from the store verbatim (no requantization), scales beside them;
  int8_res carries its residual level in parallel slabs for the rerank.
- **Query.**  Centroid scores pick ``nprobe`` clusters, kernel K5
  (``ops/ivf_probe.py``) scores the probed buckets, the spill region is
  one product, and a stable descending sort selects (where the JAX package
  calls ``lax.top_k``: ties to the lowest position).  ``rerank`` re-scores
  the candidates exactly in f32, with the residual level on int8_res.
- **Files.**  ``save`` / ``load`` use the JAX package's layout (leading
  shard axis of 1, bf16 slabs as f32, ``gid_loc.npy``), so an index saved
  by either package loads in the other.

Whether the IVF probe or the flat scan answers a query batch faster is a
property of the card: :func:`select_serving_index` encodes the crossover
measured on an H100 (``IVF_KAPPA``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.ivf_probe import ivf_probe_scores
from ..ops.quant import quantize_int8, quantize_int8_residual
from .store import VectorStore

KMEANS_CHUNK = 4096  # sample padding and assignment chunk (ivf.py:238)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _stable_topk(scores: torch.Tensor, k: int):
    """(values, positions) of the k largest per row, ties to the lowest
    position (``lax.top_k``'s rule; ``torch.topk`` promises none)."""
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


# --------------------------------------------------------------------- kmeans


def kmeans_draws(n: int, n_clusters: int, sample_n: int, seed: int):
    """The seeded draws of a build: (row ids of the k-means sample, padded
    to a chunk multiple by repeating the last, and the sample positions of
    the initial centroids).  Same numpy calls in the same order as the JAX
    package (ivf.py:237-252), so both packages draw the same rows."""
    rng = np.random.default_rng(seed)
    n_sample = min(n, sample_n)
    rows = rng.choice(n, size=n_sample, replace=False)
    rows = np.pad(rows, (0, _round_up(n_sample, KMEANS_CHUNK) - n_sample), mode="edge")
    init = rng.choice(n_sample, size=n_clusters, replace=n_sample < n_clusters)
    return rows, init


def _scores_bf16(x: torch.Tensor, cents_t: torch.Tensor) -> torch.Tensor:
    """bf16(x) @ cents_t in f32: exact products of bf16 values, f32 sums."""
    return x.to(torch.bfloat16).float() @ cents_t


def kmeans(sample: torch.Tensor, init_idx, iters: int) -> torch.Tensor:
    """Spherical Lloyd iterations over (n, D) f32 rows; returns (C, D) f32
    unit centroids.  An empty cluster keeps its previous centroid."""
    cents = sample[torch.as_tensor(init_idx, device=sample.device)]
    n_clusters = cents.shape[0]
    for _ in range(iters):
        cents_t = cents.to(torch.bfloat16).float().T
        sums = torch.zeros_like(cents)
        counts = torch.zeros(n_clusters, device=sample.device)
        for x in sample.split(KMEANS_CHUNK):
            onehot = torch.nn.functional.one_hot(_scores_bf16(x, cents_t).argmax(1), n_clusters).float()
            sums += onehot.T @ x
            counts += onehot.sum(0)
        new = sums / counts.clamp_min(1.0)[:, None]
        new = new / torch.linalg.vector_norm(new, dim=-1, keepdim=True).clamp_min(1e-12)
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def _dequant(codes: torch.Tensor, scales: Optional[torch.Tensor], global_scale) -> torch.Tensor:
    v = codes.float()
    if scales is not None:
        return v * scales[:, None]
    if global_scale is not None:
        return v * torch.tensor(global_scale, dtype=torch.float32, device=v.device)
    return v


def assign_rows(store: VectorStore, cents: torch.Tensor) -> np.ndarray:
    """Nearest centroid of each of the store's rows, dequantized chunk by
    chunk (no f32 copy of the corpus).  Returns (size,) int64 on the host."""
    cents_t = cents.to(torch.bfloat16).float().T
    scales = store.scales if store.dtype in ("int8", "int8_res") else None
    out = torch.empty(store.size, dtype=torch.long, device=store.device)
    for lo in range(0, store.size, KMEANS_CHUNK):
        hi = min(lo + KMEANS_CHUNK, store.size)
        x = _dequant(store.vectors[lo:hi], None if scales is None else scales[lo:hi], store.global_scale)
        out[lo:hi] = _scores_bf16(x, cents_t).argmax(1)
    return out.cpu().numpy()


def bucket_layout(assign: np.ndarray, n_clusters: int, cap: int, spill_headroom: int) -> dict:
    """Host layout of one shard's buckets from each row's cluster (row ==
    global id): a row's rank among its cluster's rows, in id order, is its
    bucket slot; ranks past ``cap`` spill, in (cluster, id) order.

    Returns ``gids`` (C*cap,) and ``spill_gids`` (spill_cap,), the id (==
    store row) of each slot, -1 on pads; ``spill_count``; and ``spill_cap``
    (rounded to 128 after ``spill_headroom`` free slots)."""
    group = np.asarray(assign, np.int64)
    rows = np.argsort(group, kind="stable")
    group = group[rows]
    starts = np.r_[0, np.flatnonzero(np.diff(group)) + 1]
    lens = np.diff(np.r_[starts, len(group)])
    rank = np.arange(len(group)) - np.repeat(starts, lens)
    in_bucket = rank < cap
    gids = np.full(n_clusters * cap, -1, np.int64)
    gids[group[in_bucket] * cap + rank[in_bucket]] = rows[in_bucket]
    spilled = rows[~in_bucket]
    spill_cap = _round_up(len(spilled) + spill_headroom, 128)
    spill_gids = np.full(spill_cap, -1, np.int64)
    spill_gids[: len(spilled)] = spilled
    return {"gids": gids, "spill_gids": spill_gids, "spill_count": len(spilled), "spill_cap": spill_cap}


# ---------------------------------------------------------------------- index


class IVFIndex:
    """Clustered ANN index over a :class:`VectorStore`'s rows, made by
    :meth:`build` or :meth:`load`.  Exposes the store's query surface
    (``topk`` / ``size`` / ``dim`` / ``get_vectors`` / ``save``), so the
    Retriever and the serving layer take either."""

    n_shards = 1

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = "bf16"
        self.dim = 0
        self.size = 0
        self.n_clusters = 0
        self.cap = 0
        self.spill_cap = 0
        self.nprobe = 8
        self.global_scale: float | None = None
        self.centroids = None         # (C, D) f32
        self.buckets = None           # (C, cap, D) bf16 | int8
        self.bucket_scales = None     # (C, cap) f32 (int8, int8_res)
        self.bucket_gids = None       # (C, cap) int32, -1 pad
        self.spill_vecs = None        # (spill_cap, D)
        self.spill_scales = None      # (spill_cap,) f32 (int8, int8_res)
        self.spill_gids = None        # (spill_cap,) int32, -1 pad
        # int8_res: the residual level, read only by the rerank
        self.res_buckets = None
        self.res_bucket_scales = None
        self.res_spill_vecs = None
        self.res_spill_scales = None
        self.spill_count = 0
        self._gid_loc: np.ndarray = None  # (size, 3) host: [shard 0, cluster | -1, slot]

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, store: VectorStore, *, n_clusters: Optional[int] = None, nprobe: int = 8,
              cap_mult: float = 1.6, kmeans_iters: int = 10, sample_n: int = 131072, seed: int = 0,
              spill_headroom: int = 1024) -> "IVFIndex":
        """Cluster a populated store into an IVF index on the store's device.

        ``n_clusters`` defaults to ~4*sqrt(N) rounded to 128; ``cap_mult``
        sets the bucket capacity as a multiple of the mean cluster size,
        rounded to 128 rows; rows past a full bucket spill."""
        if store.size <= 0:
            raise ValueError("cannot build an IVF index over an empty store")
        idx = cls(store.device)
        n = idx.size = store.size
        idx.dtype, idx.dim, idx.nprobe, idx.global_scale = store.dtype, store.dim, nprobe, store.global_scale
        if n_clusters is None:
            n_clusters = max(128, _round_up(int(4 * np.sqrt(n)), 128))
        n_clusters = idx.n_clusters = min(n_clusters, _round_up(max(n // 8, 1), 8))
        has_scales = store.dtype in ("int8", "int8_res")

        rows, init = kmeans_draws(n, n_clusters, sample_n, seed)
        rows_t = torch.as_tensor(rows, device=store.device)
        sample = _dequant(store.vectors[rows_t], store.scales[rows_t] if has_scales else None, store.global_scale)
        idx.centroids = kmeans(sample, init, kmeans_iters)
        del sample

        idx.cap = _round_up(max(int(np.ceil(cap_mult * max(n / n_clusters, 1.0))), 8), 128)
        lay = bucket_layout(assign_rows(store, idx.centroids), n_clusters, idx.cap, spill_headroom)
        idx.spill_cap, idx.spill_count = lay["spill_cap"], lay["spill_count"]
        dev = store.device
        # pad slots gather row 0, as in the JAX package (their gid masks them)
        gi = torch.as_tensor(lay["gids"], device=dev).clamp_min(0)
        si = torch.as_tensor(lay["spill_gids"], device=dev).clamp_min(0)

        def slabs(vectors, scales):
            # one device gather a slab: codes and scales move verbatim
            b = vectors.index_select(0, gi).view(n_clusters, idx.cap, -1)
            s = vectors.index_select(0, si)
            if scales is None:
                return b, s, None, None
            return b, s, scales.index_select(0, gi).view(n_clusters, idx.cap), scales.index_select(0, si)

        idx.buckets, idx.spill_vecs, idx.bucket_scales, idx.spill_scales = slabs(
            store.vectors, store.scales if has_scales else None)
        if store.dtype == "int8_res":
            idx.res_buckets, idx.res_spill_vecs, idx.res_bucket_scales, idx.res_spill_scales = slabs(
                store.res_vectors, store.res_scales)
        idx.bucket_gids = torch.as_tensor(lay["gids"].reshape(n_clusters, idx.cap), dtype=torch.int32, device=dev)
        idx.spill_gids = torch.as_tensor(lay["spill_gids"], dtype=torch.int32, device=dev)
        idx._gid_loc = _gid_locations(lay["gids"], lay["spill_gids"], n, idx.cap)
        return idx

    # ------------------------------------------------------------- query

    def topk(self, queries, k: int = 10, *, mode: str = "fast", nprobe: Optional[int] = None,
             rerank: Optional[int] = None):
        """(B, D) queries -> (scores (B, k) f32, global ids (B, k) int32).

        ``nprobe`` overrides the build-time default; ``mode="exact"`` probes
        every cluster.  ``rerank=K'`` keeps K' >= k candidates and re-scores
        them exactly in f32 (with the residual level on int8_res) before the
        final top-k; ``None`` means ``4 * k`` on int8_res and off otherwise,
        ``0`` switches it off.  Fewer than k probed rows leave id -1 and
        score 0 in the tail."""
        if rerank == 0:
            rerank = None
        elif rerank is None and self.dtype == "int8_res":
            rerank = 4 * k
        if rerank is not None and rerank < k:
            raise ValueError(f"rerank={rerank} must be >= k={k} (or 0)")
        if self.size < k:
            raise ValueError(f"index has {self.size} < k={k} vectors")
        p = self.n_clusters if mode == "exact" else (nprobe if nprobe is not None else self.nprobe)
        p = min(p, self.n_clusters)
        cap, spill_cap = self.cap, self.spill_cap
        if k > p * cap + spill_cap:
            raise ValueError(f"k={k} exceeds probed rows {p}*{cap}+{spill_cap}; raise nprobe")
        is_int8 = self.dtype in ("int8", "int8_res")
        q = torch.as_tensor(queries, device=self.device).float()
        bsz = q.shape[0]
        g_scale = None
        if self.dtype == "int8_global":
            g_scale = torch.tensor(self.global_scale, dtype=torch.float32, device=self.device)

        bq = q.to(torch.bfloat16).float()
        _, probe = _stable_topk(bq @ self.centroids.to(torch.bfloat16).float().T, p)
        # K5, with a global scale folded into the query before its bf16
        # rounding, as the JAX package's kernel route does (ivf.py:474-480)
        sc, g = ivf_probe_scores(q if g_scale is None else q * g_scale, probe.to(torch.int32), self.buckets,
                                 self.bucket_scales, self.bucket_gids)
        # the spill region: an always-scanned flat mini-index
        ssc = bq @ self.spill_vecs.float().T
        if is_int8:
            ssc = ssc * self.spill_scales[None, :]
        elif g_scale is not None:
            ssc = ssc * g_scale
        ssc = torch.where(self.spill_gids[None, :] >= 0, ssc, float("-inf"))
        sc = torch.cat([sc.reshape(bsz, -1), ssc], dim=1)
        g = torch.cat([g.reshape(bsz, -1), self.spill_gids[None, :].expand(bsz, -1)], dim=1)

        if rerank is None:
            vals, pos = _stable_topk(sc, k)
            ids = torch.gather(g, 1, pos)
        else:
            vals, ids = self._rerank(q, probe, sc, g, k, min(rerank, p * cap + spill_cap), g_scale)
        # the one-shard merge: the unfilled tail reports id -1 and score 0
        ids = torch.where(torch.isfinite(vals), ids, -1)
        vals = torch.where(ids >= 0, vals, 0.0)
        return vals.contiguous(), ids.to(torch.int32).contiguous()

    def _rerank(self, q, probe, sc, g, k: int, kp: int, g_scale):
        """Exact f32 re-score of the best ``kp`` probe-score candidates
        (+ the residual level on int8_res), then the top k.  Candidate
        position ``pos`` is a bucket row in probe order below ``p * cap``,
        else a spill row."""
        p, cap, spill_cap = probe.shape[1], self.cap, self.spill_cap
        _, pos = _stable_topk(sc, kp)
        cg = torch.gather(g, 1, pos)
        in_bucket = pos < p * cap
        cl = torch.gather(probe, 1, (pos // cap).clamp(0, p - 1))
        bidx = torch.where(in_bucket, cl * cap + pos % cap, 0)
        sidx = (pos - p * cap).clamp(0, spill_cap - 1)

        # (an index built with no spill headroom and no spilled row has an
        # empty spill region: every candidate is a bucket row)
        def gather(slab, spill):
            a = slab.reshape(-1, slab.shape[-1])[bidx]
            return a if spill_cap == 0 else torch.where(in_bucket[..., None], a, spill[sidx])

        def gather_scales(slab, spill):
            a = slab.reshape(-1)[bidx]
            return a if spill_cap == 0 else torch.where(in_bucket, a, spill[sidx])

        rs = torch.einsum("bd,bkd->bk", q, gather(self.buckets, self.spill_vecs).float())
        if self.dtype in ("int8", "int8_res"):
            rs = rs * gather_scales(self.bucket_scales, self.spill_scales)
        elif g_scale is not None:
            rs = rs * g_scale
        if self.dtype == "int8_res":
            rv = gather(self.res_buckets, self.res_spill_vecs).float()
            rs = rs + torch.einsum("bd,bkd->bk", q, rv) * gather_scales(self.res_bucket_scales,
                                                                         self.res_spill_scales)
        rs = torch.where(cg >= 0, rs, float("-inf"))
        vals, pos2 = _stable_topk(rs, k)
        return vals, torch.gather(cg, 1, pos2)

    # --------------------------------------------------------------- add

    def add(self, vectors) -> np.ndarray:
        """Streaming adds land in the spill region (scanned by every query,
        so they are searchable at once); rebuild from a flat store when the
        spill grows.  Returns the assigned global ids."""
        new = torch.as_tensor(vectors, device=self.device).float()
        if new.ndim != 2 or new.shape[1] != self.dim:
            raise ValueError(f"expected (E, {self.dim}) vectors, got {tuple(new.shape)}")
        e = new.shape[0]
        room = self.spill_cap - self.spill_count
        if e > room:
            raise ValueError(f"spill region full ({room} slots left, adding {e}); "
                             "rebuild the IVF index from the flat store")
        base = self.spill_count
        rows = slice(base, base + e)
        if self.dtype == "int8":
            self.spill_vecs[rows], self.spill_scales[rows] = quantize_int8(new)
        elif self.dtype == "int8_res":
            q1, s1, q2, s2 = quantize_int8_residual(new)
            self.spill_vecs[rows], self.spill_scales[rows] = q1, s1
            self.res_spill_vecs[rows], self.res_spill_scales[rows] = q2, s2
        elif self.dtype == "int8_global":
            # a 0-d tensor: a true division on the card too (ops/quant.py div127)
            gs = torch.tensor(self.global_scale, dtype=torch.float32, device=self.device)
            self.spill_vecs[rows] = torch.round(new / gs).clamp(-127, 127).to(torch.int8)
        else:
            self.spill_vecs[rows] = new.to(torch.bfloat16)
        ids = np.arange(self.size, self.size + e, dtype=np.int64)
        self.spill_gids[rows] = torch.as_tensor(ids, dtype=torch.int32, device=self.device)
        loc = np.zeros((e, 3), np.int64)
        loc[:, 1] = -1
        loc[:, 2] = np.arange(base, base + e)
        self._gid_loc = np.concatenate([self._gid_loc, loc], axis=0)
        self.spill_count += e
        self.size += e
        return ids

    # --------------------------------------------------------- get_vectors

    def get_vectors(self, ids) -> np.ndarray:
        """Global ids -> (n, D) dequantized f32 vectors on the host."""
        ids = np.asarray(ids if isinstance(ids, np.ndarray) else list(ids), np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise ValueError(f"ids out of range [0, {self.size})")
        loc = self._gid_loc[ids]
        out = np.zeros((len(ids), self.dim), np.float32)
        spill = loc[:, 1] < 0
        for rows, at, planes in (
            (~spill, (loc[~spill, 1], loc[~spill, 2]),
             (self.buckets, self.bucket_scales, self.res_buckets, self.res_bucket_scales)),
            (spill, (loc[spill, 2],), (self.spill_vecs, self.spill_scales, self.res_spill_vecs, self.res_spill_scales)),
        ):
            if rows.any():
                at = tuple(torch.as_tensor(a) for a in at)
                codes, scales, res, res_scales = (None if t is None else t[at].float().cpu().numpy() for t in planes)
                # the JAX package's host arithmetic (ivf.py:704-729)
                if self.dtype in ("int8", "int8_res"):
                    codes *= scales[:, None]
                elif self.dtype == "int8_global":
                    codes *= np.float32(self.global_scale)
                if self.dtype == "int8_res":
                    codes += res * res_scales[:, None]
                out[rows] = codes
        return out

    # ------------------------------------------------------------ persist

    def save(self, path: str) -> None:
        """The JAX package's IVF directory: ``meta.json`` and one ``.npy``
        a slab, each with a leading shard axis of 1 (bf16 slabs as f32)."""
        os.makedirs(path, exist_ok=True)
        meta = {
            "type": "ivf", "dim": self.dim, "dtype": self.dtype, "size": self.size, "n_shards": 1,
            "n_clusters": self.n_clusters, "cap": self.cap, "spill_cap": self.spill_cap,
            "nprobe": self.nprobe, "global_scale": self.global_scale, "spill_counts": [self.spill_count],
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

        def put(name, t, shard_axis=True):
            if t is not None:
                a = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
                np.save(os.path.join(path, name), a[None] if shard_axis else a)

        put("centroids.npy", self.centroids, shard_axis=False)
        for name in _SLABS:
            put(f"{name}.npy", getattr(self, name))
        np.save(os.path.join(path, "gid_loc.npy"), self._gid_loc)

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "IVFIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta["n_shards"] != 1:
            raise ValueError(f"IVF index was built over {meta['n_shards']} shards; the port serves one -- "
                             "rebuild from the flat store")
        idx = cls(device)
        for key in ("dim", "dtype", "size", "n_clusters", "cap", "spill_cap", "nprobe", "global_scale"):
            setattr(idx, key, meta[key])
        idx.spill_count = int(meta["spill_counts"][0])
        vec_dt = torch.bfloat16 if idx.dtype == "bf16" else torch.int8
        dev = idx.device
        idx.centroids = torch.as_tensor(np.load(os.path.join(path, "centroids.npy")), device=dev)
        for name in _SLABS:
            file = os.path.join(path, f"{name}.npy")
            if os.path.exists(file):
                arr = torch.as_tensor(np.load(file)[0], device=dev)
                setattr(idx, name, arr.to(vec_dt) if name in ("buckets", "spill_vecs") else arr)
        idx._gid_loc = np.load(os.path.join(path, "gid_loc.npy"))
        return idx


# slabs saved one file each, in the JAX package's names
_SLABS = ("buckets", "bucket_gids", "spill_vecs", "spill_gids", "bucket_scales", "spill_scales",
          "res_buckets", "res_bucket_scales", "res_spill_vecs", "res_spill_scales")


def _gid_locations(bucket_gids: np.ndarray, spill_gids: np.ndarray, n: int, cap: int) -> np.ndarray:
    """(n, 3) host map id -> [shard 0, cluster | -1 for the spill, slot]."""
    loc = np.zeros((n, 3), np.int64)
    at = np.flatnonzero(bucket_gids >= 0)
    loc[bucket_gids[at], 1] = at // cap
    loc[bucket_gids[at], 2] = at % cap
    at = np.flatnonzero(spill_gids >= 0)
    loc[spill_gids[at], 1] = -1
    loc[spill_gids[at], 2] = at
    return loc


def load_index(path: str, *, capacity: Optional[int] = None, device="cuda"):
    """Open a saved index directory by its ``meta.json`` type: an IVF
    directory as :class:`IVFIndex`, a flat one as :class:`VectorStore`."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("type") == "ivf":
        return IVFIndex.load(path, device=device)
    return VectorStore.load(path, capacity=capacity, device=device)


# The crossover between probing the IVF index and scanning the flat store,
# as the JAX package's byte-efficiency factor: IVF reads nprobe * cap rows a
# QUERY, the flat scan the corpus once a BATCH, so IVF wins while batch <=
# rows / (nprobe * cap * kappa).  Measured by chip_smoke.py's IVF-vs-flat
# sweep (IVFIndex.topk against VectorStore.topk on 1,048,576 x 768 bf16,
# nprobe 8, cap 512) on an NVIDIA H100 80GB HBM3 at a 700 W power limit: the
# IVF query was faster at every batch from 64 to 4,096 (the flat scan's
# kernel is bound by operations past B ~ 64) and within host noise of the
# flat scan below 64, so no crossover up to 4,096: kappa <= 1M / (8 * 512 *
# 4096) = 0.0625, and that bound is the constant.
IVF_KAPPA = 0.0625


def ivf_crossover_batch(ivf: IVFIndex, *, kappa: float = IVF_KAPPA) -> int:
    """Largest query batch at which probing the IVF index beats the flat
    scan: IVF wins while batch <= rows / (nprobe * cap * kappa)."""
    rows_per_shard = ivf.size // max(ivf.n_shards, 1)
    return max(1, int(rows_per_shard // (ivf.nprobe * ivf.cap * kappa)))


def select_serving_index(flat, ivf: IVFIndex, query_batch: int, *, kappa: float = IVF_KAPPA):
    """The index a serving loop should dispatch to at ``query_batch``: the
    IVF probe up to the crossover, the flat scan past it.  Returns
    ``(index, crossover_batch)``.  The dtype does not move the crossover:
    both first passes read the same representation (int8_res scans its
    primary codes on either side)."""
    cross = ivf_crossover_batch(ivf, kappa=kappa)
    return (ivf if query_batch <= cross else flat), cross
