"""IVF (inverted-file) clustered ANN index over the flat store's shards.

Counterpart of ``vietnamese_qa_system_tpu/engine/ivf.py``:

- **Build.**  Spherical k-means over a seeded sample of the flat store
  (the same numpy draws, in the same order, as the JAX package, so the
  sample and the initial centroids are equal; drawn ids are gathered from
  their shards), then a nearest-centroid assignment of every row on its
  shard's device.  Both are f32 products of bf16-rounded inputs; ties go
  to the first centroid; the centroid sums are one-hot products (no
  atomics), so a build repeats bit for bit on one card.
- **Fixed-shape buckets, per shard.**  Every (shard, cluster) is a
  ``cap``-row slab of the shard's ``(C, cap, D)`` tensor (``cap`` from the
  mean cluster size of a shard), padded with ``gid = -1`` rows; rows past
  a full bucket land in the shard's spill region, which every query
  scans.  Quantized codes move from the store verbatim (no
  requantization), scales beside them; int8_res carries its residual
  level in parallel slabs for the rerank.
- **Query.**  Centroid scores pick ``nprobe`` clusters (once: the
  centroids are shared); on every shard kernel K5 (``ops/ivf_probe.py``)
  scores the probed buckets, the spill region is one product, and a
  stable descending sort selects (where the JAX package calls
  ``lax.top_k``: ties to the lowest position).  ``rerank`` re-scores the
  candidates exactly in f32 (residual level on int8_res), shard-locally.
  The shards' top-k merge as the flat store's do (ties to the lower
  shard).
- **Files.**  ``save`` / ``load`` use the JAX package's layout (leading
  shard axis, bf16 slabs as f32, ``gid_loc.npy``), so an index saved by
  either package loads in the other, at the shard count it was built
  with.

Whether the IVF probe or the flat scan answers a query batch faster is a
property of the card: :func:`select_serving_index` encodes the crossover
measured on an H100 (``IVF_KAPPA``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.mesh import Mesh
from ..ops.ivf_probe import ivf_probe_scores
from ..ops.quant import quantize_int8, quantize_int8_residual
from ..parallel.collectives import all_gather
from .store import VectorStore, shard_devices

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


def assign_rows(store: VectorStore, shard: int, cents: torch.Tensor) -> np.ndarray:
    """Nearest centroid of each row of one shard of the store (slot order),
    dequantized chunk by chunk on the shard's device (no f32 copy of the
    corpus).  Returns (valid rows,) int64 on the host."""
    slab = store.slabs[shard]
    cents_t = cents.to(slab.device).to(torch.bfloat16).float().T
    scales = slab.scales if store.dtype in ("int8", "int8_res") else None
    n = store.valid_rows(shard)
    out = torch.empty(n, dtype=torch.long, device=slab.device)
    for lo in range(0, n, KMEANS_CHUNK):
        hi = min(lo + KMEANS_CHUNK, n)
        x = _dequant(slab.vectors[lo:hi], None if scales is None else scales[lo:hi], store.global_scale)
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


def _pad_ids(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` padded with -1 to ``n`` entries."""
    return np.concatenate([a, np.full(n - len(a), -1, np.int64)])


def shard_layouts(assign_by_shard: list, n_clusters: int, cap: int, spill_headroom: int) -> list[dict]:
    """:func:`bucket_layout` of every shard (each over its own slots, in
    slot == id order), with one spill capacity for all: the largest
    shard's spill plus ``spill_headroom``, rounded to 128 (ivf.py:147-163).
    The slots of the returned ``gids`` / ``spill_gids`` are shard-local."""
    lays = [bucket_layout(a, n_clusters, cap, 0) for a in assign_by_shard]
    spill_cap = _round_up(max(lay["spill_count"] for lay in lays) + spill_headroom, 128)
    for lay in lays:
        lay["spill_gids"] = _pad_ids(lay["spill_gids"][: lay["spill_count"]], spill_cap)
        lay["spill_cap"] = spill_cap
    return lays


@dataclasses.dataclass
class _Shard:
    """One shard's slabs on its device (``None`` where the dtype has no
    such level)."""

    device: torch.device
    buckets: torch.Tensor = None            # (C, cap, D) bf16 | int8
    bucket_scales: torch.Tensor = None      # (C, cap) f32 (int8, int8_res)
    bucket_gids: torch.Tensor = None        # (C, cap) int32 global ids, -1 pad
    spill_vecs: torch.Tensor = None         # (spill_cap, D)
    spill_scales: torch.Tensor = None       # (spill_cap,) f32 (int8, int8_res)
    spill_gids: torch.Tensor = None         # (spill_cap,) int32, -1 pad
    # int8_res: the residual level, read only by the rerank
    res_buckets: torch.Tensor = None
    res_bucket_scales: torch.Tensor = None
    res_spill_vecs: torch.Tensor = None
    res_spill_scales: torch.Tensor = None


class IVFIndex:
    """Clustered ANN index over a :class:`VectorStore`'s rows, made by
    :meth:`build` or :meth:`load`, with the store's shards: every shard
    keeps its own rows' buckets and spill region under the shared
    centroids.  Exposes the store's query surface (``topk`` / ``size`` /
    ``dim`` / ``get_vectors`` / ``save``), so the Retriever and the
    serving layer take either."""

    def __init__(self, device="cuda", mesh: Mesh | None = None):
        self.devices = shard_devices(mesh, device)
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        self.dtype = "bf16"
        self.dim = 0
        self.size = 0
        self.n_clusters = 0
        self.cap = 0
        self.spill_cap = 0
        self.nprobe = 8
        self.global_scale: float | None = None
        self.centroids = None         # (C, D) f32 on the lead device
        self.shards = [_Shard(d) for d in self.devices]
        self.spill_counts = np.zeros(self.n_shards, np.int64)
        self._gid_loc: np.ndarray = None  # (size, 3) host: [shard, cluster | -1, slot]


    @property
    def spill_count(self) -> int:
        """Rows in the spill regions, over every shard."""
        return int(self.spill_counts.sum())

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, store: VectorStore, *, n_clusters: Optional[int] = None, nprobe: int = 8,
              cap_mult: float = 1.6, kmeans_iters: int = 10, sample_n: int = 131072, seed: int = 0,
              spill_headroom: int = 1024) -> "IVFIndex":
        """Cluster a populated store into an IVF index on the store's
        shards.

        ``n_clusters`` defaults to ~4*sqrt(N) rounded to 128; ``cap_mult``
        sets the bucket capacity as a multiple of the mean cluster size of
        a shard, rounded to 128 rows; rows past a full bucket spill."""
        if store.size <= 0:
            raise ValueError("cannot build an IVF index over an empty store")
        idx = cls(store.device, store.mesh)
        s = idx.n_shards
        n = idx.size = store.size
        idx.dtype, idx.dim, idx.nprobe, idx.global_scale = store.dtype, store.dim, nprobe, store.global_scale
        if n_clusters is None:
            n_clusters = max(128, _round_up(int(4 * np.sqrt(n)), 128))
        n_clusters = idx.n_clusters = min(n_clusters, _round_up(max(n // 8, 1), 8))
        has_scales = store.dtype in ("int8", "int8_res")

        # the k-means sample: the drawn ids, gathered from their shards
        rows, init = kmeans_draws(n, n_clusters, sample_n, seed)
        lead = store.device
        sample = torch.empty((len(rows), store.dim), dtype=torch.float32, device=lead)
        for sh, slab in enumerate(store.slabs):
            sel = np.flatnonzero(rows % s == sh)
            if sel.size:
                slot = torch.as_tensor(rows[sel] // s, device=slab.device)
                x = _dequant(slab.vectors[slot], slab.scales[slot] if has_scales else None, store.global_scale)
                sample[torch.as_tensor(sel, device=lead)] = x.to(lead)
        idx.centroids = kmeans(sample, init, kmeans_iters)
        del sample

        idx.cap = _round_up(max(int(np.ceil(cap_mult * max(n / (s * n_clusters), 1.0))), 8), 128)
        lays = shard_layouts([assign_rows(store, sh, idx.centroids) for sh in range(s)], n_clusters, idx.cap,
                             spill_headroom)
        idx.spill_cap = lays[0]["spill_cap"]
        idx.spill_counts = np.asarray([lay["spill_count"] for lay in lays], np.int64)
        loc = np.zeros((n, 3), np.int64)
        for sh, (slab, lay, shard) in enumerate(zip(store.slabs, lays, idx.shards)):
            dev = slab.device
            # pad slots gather row 0, as in the JAX package (their gid masks them)
            gi = torch.as_tensor(lay["gids"], device=dev).clamp_min(0)
            si = torch.as_tensor(lay["spill_gids"], device=dev).clamp_min(0)

            def slabs(vectors, scales):
                # one device gather a slab: codes and scales move verbatim
                b = vectors.index_select(0, gi).view(n_clusters, idx.cap, -1)
                sp = vectors.index_select(0, si)
                if scales is None:
                    return b, sp, None, None
                return b, sp, scales.index_select(0, gi).view(n_clusters, idx.cap), scales.index_select(0, si)

            shard.buckets, shard.spill_vecs, shard.bucket_scales, shard.spill_scales = slabs(
                slab.vectors, slab.scales if has_scales else None)
            if store.dtype == "int8_res":
                shard.res_buckets, shard.res_spill_vecs, shard.res_bucket_scales, shard.res_spill_scales = slabs(
                    slab.res_vectors, slab.res_scales)
            gids = np.where(lay["gids"] >= 0, lay["gids"] * s + sh, -1)
            spill = np.where(lay["spill_gids"] >= 0, lay["spill_gids"] * s + sh, -1)
            shard.bucket_gids = torch.as_tensor(gids.reshape(n_clusters, idx.cap), dtype=torch.int32, device=dev)
            shard.spill_gids = torch.as_tensor(spill, dtype=torch.int32, device=dev)
            _gid_locations(loc, sh, gids, spill, idx.cap)
        idx._gid_loc = loc
        return idx

    # ------------------------------------------------------------- query

    def topk(self, queries, k: int = 10, *, mode: str = "fast", nprobe: Optional[int] = None,
             rerank: Optional[int] = None):
        """(B, D) queries -> (scores (B, k) f32, global ids (B, k) int32).

        ``nprobe`` overrides the build-time default; ``mode="exact"`` probes
        every cluster.  ``rerank=K'`` keeps K' >= k candidates a shard and
        re-scores them exactly in f32 (with the residual level on int8_res)
        before the final top-k; ``None`` means ``4 * k`` on int8_res and
        off otherwise, ``0`` switches it off.  Every shard probes the same
        clusters; the shards' candidates merge as the flat store's do.
        Fewer than k probed rows leave id -1 and score 0 in the tail."""
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
        if k > p * self.cap + self.spill_cap:
            raise ValueError(f"k={k} exceeds probed rows {p}*{self.cap}+{self.spill_cap}; raise nprobe")
        q = torch.as_tensor(queries, device=self.device).float()
        # the probed clusters, once: every shard holds the same centroids
        _, probe = _stable_topk(q.to(torch.bfloat16).float() @ self.centroids.to(torch.bfloat16).float().T, p)
        probe = probe.to(torch.int32)
        vals, ids = [], []
        for shard in self.shards:
            v, i = self._shard_topk(shard, q.to(shard.device), probe.to(shard.device), k, rerank)
            # a shard's unfilled tail: id -1, score 0 (ivf.py:409-410)
            vals.append(torch.where(torch.isfinite(v), v, 0.0))
            ids.append(torch.where(torch.isfinite(v), i, -1))
        if self.n_shards == 1:
            return vals[0].contiguous(), ids[0].to(torch.int32).contiguous()
        all_s = all_gather(vals, self.device, dim=1)
        all_g = all_gather(ids, self.device, dim=1)
        mvals, pos = _stable_topk(torch.where(all_g >= 0, all_s, float("-inf")), k)
        mids = torch.gather(all_g, 1, pos)
        return torch.where(mids >= 0, mvals, 0.0).contiguous(), mids.to(torch.int32).contiguous()

    def _shard_topk(self, shard: _Shard, q, probe, k: int, rerank: Optional[int]):
        """One shard's (scores, ids) (B, k): K5 over its probed buckets, a
        product over its spill region, then the top k (or the rerank)."""
        p, cap, spill_cap = probe.shape[1], self.cap, self.spill_cap
        bsz = q.shape[0]
        is_int8 = self.dtype in ("int8", "int8_res")
        g_scale = None
        if self.dtype == "int8_global":
            g_scale = torch.tensor(self.global_scale, dtype=torch.float32, device=shard.device)
        # K5, with a global scale folded into the query before its bf16
        # rounding, as the JAX package's kernel route does (ivf.py:474-480)
        sc, g = ivf_probe_scores(q if g_scale is None else q * g_scale, probe, shard.buckets, shard.bucket_scales,
                                 shard.bucket_gids)
        # the spill region: an always-scanned flat mini-index
        ssc = q.to(torch.bfloat16).float() @ shard.spill_vecs.float().T
        if is_int8:
            ssc = ssc * shard.spill_scales[None, :]
        elif g_scale is not None:
            ssc = ssc * g_scale
        ssc = torch.where(shard.spill_gids[None, :] >= 0, ssc, float("-inf"))
        sc = torch.cat([sc.reshape(bsz, -1), ssc], dim=1)
        g = torch.cat([g.reshape(bsz, -1), shard.spill_gids[None, :].expand(bsz, -1)], dim=1)
        if rerank is None:
            vals, pos = _stable_topk(sc, k)
            return vals, torch.gather(g, 1, pos)
        return self._rerank(shard, q, probe, sc, g, k, min(rerank, p * cap + spill_cap), g_scale)

    def _rerank(self, shard: _Shard, q, probe, sc, g, k: int, kp: int, g_scale):
        """Exact f32 re-score of the best ``kp`` probe-score candidates
        (+ the residual level on int8_res), then the top k.  Candidate
        position ``pos`` is a bucket row in probe order below ``p * cap``,
        else a spill row."""
        p, cap, spill_cap = probe.shape[1], self.cap, self.spill_cap
        _, pos = _stable_topk(sc, kp)
        cg = torch.gather(g, 1, pos)
        in_bucket = pos < p * cap
        cl = torch.gather(probe.long(), 1, (pos // cap).clamp(0, p - 1))
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

        rs = torch.einsum("bd,bkd->bk", q, gather(shard.buckets, shard.spill_vecs).float())
        if self.dtype in ("int8", "int8_res"):
            rs = rs * gather_scales(shard.bucket_scales, shard.spill_scales)
        elif g_scale is not None:
            rs = rs * g_scale
        if self.dtype == "int8_res":
            rv = gather(shard.res_buckets, shard.res_spill_vecs).float()
            rs = rs + torch.einsum("bd,bkd->bk", q, rv) * gather_scales(shard.res_bucket_scales,
                                                                         shard.res_spill_scales)
        rs = torch.where(cg >= 0, rs, float("-inf"))
        vals, pos2 = _stable_topk(rs, k)
        return vals, torch.gather(cg, 1, pos2)

    # --------------------------------------------------------------- add

    def add(self, vectors) -> np.ndarray:
        """Streaming adds land in the spill regions, the emptiest shard
        first, in contiguous runs (scanned by every query, so they are
        searchable at once); rebuild from a flat store when the spill
        grows.  Returns the assigned global ids."""
        new = torch.as_tensor(vectors, device=self.device).float()
        if new.ndim != 2 or new.shape[1] != self.dim:
            raise ValueError(f"expected (E, {self.dim}) vectors, got {tuple(new.shape)}")
        e = new.shape[0]
        room = self.spill_cap * self.n_shards - self.spill_count
        if e > room:
            raise ValueError(f"spill region full ({room} slots left, adding {e}); "
                             "rebuild the IVF index from the flat store")
        ids = np.arange(self.size, self.size + e, dtype=np.int64)
        loc = np.zeros((e, 3), np.int64)
        offset = 0
        for sh in np.argsort(self.spill_counts, kind="stable"):
            if offset >= e:
                break
            take = min(self.spill_cap - int(self.spill_counts[sh]), e - offset)
            if take <= 0:
                continue
            shard = self.shards[sh]
            base = int(self.spill_counts[sh])
            rows = slice(base, base + take)
            x = new[offset: offset + take].to(shard.device)
            if self.dtype == "int8":
                shard.spill_vecs[rows], shard.spill_scales[rows] = quantize_int8(x)
            elif self.dtype == "int8_res":
                q1, s1, q2, s2 = quantize_int8_residual(x)
                shard.spill_vecs[rows], shard.spill_scales[rows] = q1, s1
                shard.res_spill_vecs[rows], shard.res_spill_scales[rows] = q2, s2
            elif self.dtype == "int8_global":
                # a 0-d tensor: a true division on the card too (ops/quant.py div127)
                gs = torch.tensor(self.global_scale, dtype=torch.float32, device=shard.device)
                shard.spill_vecs[rows] = torch.round(x / gs).clamp(-127, 127).to(torch.int8)
            else:
                shard.spill_vecs[rows] = x.to(torch.bfloat16)
            shard.spill_gids[rows] = torch.as_tensor(ids[offset: offset + take], dtype=torch.int32,
                                                     device=shard.device)
            loc[offset: offset + take] = np.stack([np.full(take, sh), np.full(take, -1),
                                                   np.arange(base, base + take)], axis=1)
            self.spill_counts[sh] += take
            offset += take
        self._gid_loc = np.concatenate([self._gid_loc, loc], axis=0)
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
        for sh, shard in enumerate(self.shards):
            mine = loc[:, 0] == sh
            for rows, at, planes in (
                (mine & ~spill, lambda m: (loc[m, 1], loc[m, 2]),
                 (shard.buckets, shard.bucket_scales, shard.res_buckets, shard.res_bucket_scales)),
                (mine & spill, lambda m: (loc[m, 2],),
                 (shard.spill_vecs, shard.spill_scales, shard.res_spill_vecs, shard.res_spill_scales)),
            ):
                if rows.any():
                    at = tuple(torch.as_tensor(a, device=shard.device) for a in at(rows))
                    codes, scales, res, res_scales = (None if t is None else t[at].float().cpu().numpy()
                                                      for t in planes)
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
        a slab, each with a leading shard axis (bf16 slabs as f32)."""
        os.makedirs(path, exist_ok=True)
        meta = {
            "type": "ivf", "dim": self.dim, "dtype": self.dtype, "size": self.size, "n_shards": self.n_shards,
            "n_clusters": self.n_clusters, "cap": self.cap, "spill_cap": self.spill_cap,
            "nprobe": self.nprobe, "global_scale": self.global_scale, "spill_counts": self.spill_counts.tolist(),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

        def host(t):
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

        np.save(os.path.join(path, "centroids.npy"), host(self.centroids))
        for name in _SLABS:
            if getattr(self.shards[0], name) is not None:
                np.save(os.path.join(path, f"{name}.npy"), np.stack([host(getattr(sh, name)) for sh in self.shards]))
        np.save(os.path.join(path, "gid_loc.npy"), self._gid_loc)

    @classmethod
    def load(cls, path: str, *, device="cuda", mesh: Mesh | None = None) -> "IVFIndex":
        """Restore an IVF directory onto ``mesh``'s shards (one shard on
        ``device`` without a mesh); the shard count must be the build's."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        idx = cls(device, mesh)
        if idx.n_shards != meta["n_shards"]:
            raise ValueError(f"IVF index was built over {meta['n_shards']} shards; load mesh has {idx.n_shards} "
                             "-- rebuild from the flat store to reshard")
        for key in ("dim", "dtype", "size", "n_clusters", "cap", "spill_cap", "nprobe", "global_scale"):
            setattr(idx, key, meta[key])
        idx.spill_counts = np.asarray(meta["spill_counts"], np.int64)
        vec_dt = torch.bfloat16 if idx.dtype == "bf16" else torch.int8
        idx.centroids = torch.as_tensor(np.load(os.path.join(path, "centroids.npy")), device=idx.device)
        for name in _SLABS:
            file = os.path.join(path, f"{name}.npy")
            if os.path.exists(file):
                arr = np.load(file)
                for sh, shard in enumerate(idx.shards):
                    t = torch.as_tensor(arr[sh], device=shard.device)
                    setattr(shard, name, t.to(vec_dt) if name in ("buckets", "spill_vecs")
                            else t.to(torch.int8) if name in ("res_buckets", "res_spill_vecs") else t)
        idx._gid_loc = np.load(os.path.join(path, "gid_loc.npy"))
        return idx


# slabs saved one file each, in the JAX package's names
_SLABS = ("buckets", "bucket_gids", "spill_vecs", "spill_gids", "bucket_scales", "spill_scales",
          "res_buckets", "res_bucket_scales", "res_spill_vecs", "res_spill_scales")


def _gid_locations(loc: np.ndarray, shard: int, bucket_gids: np.ndarray, spill_gids: np.ndarray, cap: int) -> None:
    """Fill the host map id -> [shard, cluster | -1 for the spill, slot]
    with one shard's global ids."""
    at = np.flatnonzero(bucket_gids >= 0)
    loc[bucket_gids[at]] = np.stack([np.full(len(at), shard), at // cap, at % cap], axis=1)
    at = np.flatnonzero(spill_gids >= 0)
    loc[spill_gids[at]] = np.stack([np.full(len(at), shard), np.full(len(at), -1), at], axis=1)


def load_index(path: str, *, capacity: Optional[int] = None, device="cuda", mesh: Mesh | None = None):
    """Open a saved index directory by its ``meta.json`` type: an IVF
    directory as :class:`IVFIndex`, a flat one as :class:`VectorStore`."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("type") == "ivf":
        return IVFIndex.load(path, device=device, mesh=mesh)
    return VectorStore.load(path, capacity=capacity, device=device, mesh=mesh)


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
