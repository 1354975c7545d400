"""Device-resident vector store on one GPU -- the index half of retrieval.

Counterpart of ``vietnamese_qa_system_tpu/engine/store.py`` for one device
(``n_shards == 1``; sharding over several GPUs is not ported yet):

- dtypes ``bf16``, ``int8`` (per-vector scales), ``int8_global`` (one
  scale, calibrated on the first add) and ``int8_res`` (primary and
  residual int8 codes; the scan reads the primary slab only and a re-rank
  of ``4 * k`` candidates restores the precision);
- the same capacity rounding and the same on-disk layout (``meta.json``,
  ``vectors.npy`` as float32 even for int8 codes, ``scales.npy``,
  ``res_*.npy``, ``tail.npy``), so an index saved by either package loads
  in the other.

With one shard every vector lands on shard 0 at slot == id, so no row is
ever left pending on the host: ``tail.npy`` is written empty, and a saved
index with more shards is re-added in id order on load, as the JAX store
does across mesh sizes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.quant import quantize_int8, quantize_int8_residual
from ..ops.topk import MAX_K, matmul_topk


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class VectorStore:
    """Fixed-capacity inner-product index on one device.

    ``capacity`` is rounded up to a multiple of ``tile_n`` (kept for the
    capacity rounding and ``meta.json``; the kernels tile on their own)."""

    n_shards = 1

    def __init__(self, capacity: int, dim: int, *, dtype: str = "bf16", tile_n: int | None = None,
                 device="cuda"):
        if dtype not in ("bf16", "int8", "int8_global", "int8_res"):
            raise ValueError(f"dtype must be bf16, int8, int8_global or int8_res, got {dtype!r}")
        if tile_n is None:
            tile_n = 4096 if dtype.startswith("int8") else 2048
        self.device = resolve_device(device)
        self.dim = dim
        self.dtype = dtype
        self.capacity = _round_up(max(capacity, tile_n), tile_n)
        self.tile_n = min(tile_n, self.capacity)
        self.size = 0
        # int8_global: one scalar scale for the whole index (ops/quant.py)
        self.global_scale: float | None = None
        vec_dt = torch.bfloat16 if dtype == "bf16" else torch.int8
        self.vectors = torch.zeros((self.capacity, dim), dtype=vec_dt, device=self.device)
        has_scales = dtype in ("int8", "int8_res")
        self.scales = torch.zeros(self.capacity, device=self.device) if has_scales else None
        is_res = dtype == "int8_res"
        self.res_vectors = torch.zeros((self.capacity, dim), dtype=torch.int8, device=self.device) if is_res else None
        self.res_scales = torch.zeros(self.capacity, device=self.device) if is_res else None

    # ------------------------------------------------------------------ add

    def add(self, vectors) -> np.ndarray:
        """Append (E, D) float vectors (array or tensor).  Returns the
        assigned global ids ``size .. size + E - 1``."""
        new = torch.as_tensor(vectors, device=self.device).float()
        if new.ndim != 2 or new.shape[1] != self.dim:
            raise ValueError(f"expected (E, {self.dim}) vectors, got {tuple(new.shape)}")
        e = new.shape[0]
        if self.size + e > self.capacity:
            raise ValueError(f"store full: size={self.size} + {e} > capacity={self.capacity}")
        rows = slice(self.size, self.size + e)
        if self.dtype == "int8":
            self.vectors[rows], self.scales[rows] = quantize_int8(new)
        elif self.dtype == "int8_res":
            q1, s1, q2, s2 = quantize_int8_residual(new)
            self.vectors[rows], self.scales[rows] = q1, s1
            self.res_vectors[rows], self.res_scales[rows] = q2, s2
        elif self.dtype == "int8_global":
            if self.global_scale is None:
                absmax = float(new.abs().max()) if e else 0.0
                self.global_scale = max(absmax, 1e-12) * 1.25 / 127.0
            gs = torch.tensor(self.global_scale, dtype=torch.float32, device=self.device)
            self.vectors[rows] = torch.round(new / gs).clamp(-127, 127).to(torch.int8)
        else:
            self.vectors[rows] = new.to(torch.bfloat16)
        ids = np.arange(self.size, self.size + e, dtype=np.int64)
        self.size += e
        return ids

    # ---------------------------------------------------------------- query

    def topk(self, queries, k: int = 10, *, mode: str = "fast", rerank: int | None = None):
        """(B, D) queries -> (scores (B, k) f32, ids (B, k) int32) tensors.

        ``rerank=K'`` keeps ``K' >= k`` scan candidates and re-scores them
        exactly against the stored representation (f32, with the residual
        on ``int8_res``) before the final top-k.  ``None`` means ``4 * k``
        on ``int8_res`` (clamped to ``MAX_K``) and off otherwise; ``0``
        switches it off; an explicit value above ``MAX_K`` raises."""
        if self.size < k:
            raise ValueError(f"store has {self.size} < k={k} vectors")
        explicit = rerank is not None
        if rerank == 0:
            rerank = None
        elif rerank is None and self.dtype == "int8_res":
            rerank = 4 * k
        if rerank is not None:
            if rerank < k:
                raise ValueError(f"rerank={rerank} must be >= k={k}")
            if explicit and rerank > MAX_K:
                raise ValueError(f"rerank={rerank} exceeds the kernel limit {MAX_K}")
            rerank = max(min(rerank, MAX_K), k)
        q = torch.as_tensor(queries, device=self.device).float()
        if self.dtype == "int8_global":
            sc = torch.tensor(self.global_scale, dtype=torch.float32, device=self.device)
        else:
            sc = self.scales
        scores, slots = matmul_topk(q, self.vectors, k if rerank is None else rerank,
                                    corpus_scales=sc, valid_n=self.size, mode=mode)
        if rerank is None:
            return scores, slots
        # exact re-score of the K' candidates against the stored codes
        ok = (slots >= 0) & (slots < self.size)
        safe = slots.clamp_min(0).long()
        rs = torch.einsum("bd,bkd->bk", q, self.vectors[safe].float())
        if self.dtype == "int8_global":
            rs = rs * sc
        elif self.scales is not None:
            rs = rs * self.scales[safe]
        if self.dtype == "int8_res":
            rs = rs + torch.einsum("bd,bkd->bk", q, self.res_vectors[safe].float()) * self.res_scales[safe]
        rs = torch.where(ok, rs, float("-inf"))
        slots = torch.where(ok, slots, -1)
        s, pos = torch.sort(rs, dim=1, descending=True, stable=True)
        return s[:, :k].contiguous(), torch.gather(slots, 1, pos[:, :k]).contiguous()

    def get_vectors(self, ids) -> np.ndarray:
        """Global ids -> (n, D) dequantized f32 vectors on the host."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise ValueError(f"ids out of range [0, {self.size})")
        idx = torch.as_tensor(ids, device=self.device)
        vecs = self.vectors[idx].float()
        if self.dtype in ("int8", "int8_res"):
            vecs = vecs * self.scales[idx][:, None]
        if self.dtype == "int8_res":
            vecs = vecs + self.res_vectors[idx].float() * self.res_scales[idx][:, None]
        elif self.dtype == "int8_global":
            vecs = vecs * self.global_scale
        return vecs.cpu().numpy()

    # ------------------------------------------------------------ persist

    def save(self, path: str) -> None:
        """Host checkpoint in the JAX store's layout; only rows holding data
        are written, and ``capacity`` is recorded for ingest headroom."""
        os.makedirs(path, exist_ok=True)
        n = self.size
        meta = {
            "capacity": self.capacity,
            "dim": self.dim,
            "dtype": self.dtype,
            "size": n,
            "n_shards": self.n_shards,
            "tile_n": self.tile_n,
            "global_scale": self.global_scale,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

        def host(t):
            return t[:n].cpu().numpy()[None]

        np.save(os.path.join(path, "vectors.npy"), host(self.vectors.float()))
        if self.scales is not None:
            np.save(os.path.join(path, "scales.npy"), host(self.scales))
        if self.dtype == "int8_res":
            np.save(os.path.join(path, "res_vectors.npy"), host(self.res_vectors))
            np.save(os.path.join(path, "res_scales.npy"), host(self.res_scales))
        np.save(os.path.join(path, "tail.npy"), np.zeros((0, self.dim), np.float32))

    @classmethod
    def load(cls, path: str, *, capacity: int | None = None, device="cuda") -> "VectorStore":
        """Restore a saved index.  ``capacity=None`` keeps the build-time
        capacity; an int resizes to ``max(capacity, size)`` (``0`` is
        shrink-to-fit, which serving uses)."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("type", "flat") != "flat":
            raise ValueError(f"{path} is a {meta['type']} index, not a flat store; open it with engine.load_index")
        size, n_old, dim = meta["size"], meta["n_shards"], meta["dim"]
        cap = meta["capacity"] if capacity is None else max(capacity, size)
        store = cls(cap, dim, dtype=meta["dtype"], tile_n=meta["tile_n"], device=device)
        store.global_scale = meta.get("global_scale")
        if size == 0:
            return store

        used = -(-size // n_old)

        def load(name):
            arr = np.load(os.path.join(path, name))
            return arr.reshape(n_old, -1, *arr.shape[2:])[:, :used]

        vecs = load("vectors.npy")
        if n_old != 1:
            # round-robin ids (g lives at shard g % S, slot g // S): re-add
            # in id order, dequantized -- vectors.npy holds int8 codes for
            # the int8 dtypes; the restored global scale re-quantizes
            # int8_global codes bit-identically
            g = np.arange(size)
            flat = vecs[g % n_old, g // n_old]
            if meta["dtype"] in ("int8", "int8_res"):
                flat = flat * load("scales.npy")[g % n_old, g // n_old][:, None]
            if meta["dtype"] == "int8_res":
                flat = flat + (load("res_vectors.npy")[g % n_old, g // n_old].astype(np.float32)
                               * load("res_scales.npy")[g % n_old, g // n_old][:, None])
            elif meta["dtype"] == "int8_global":
                flat = flat * meta["global_scale"]
            store.add(flat)
            return store
        dev = store.device
        store.vectors[:size] = torch.as_tensor(vecs[0], device=dev).to(store.vectors.dtype)
        if store.scales is not None:
            store.scales[:size] = torch.as_tensor(load("scales.npy")[0], device=dev)
        if meta["dtype"] == "int8_res":
            store.res_vectors[:size] = torch.as_tensor(load("res_vectors.npy")[0], device=dev).to(torch.int8)
            store.res_scales[:size] = torch.as_tensor(load("res_scales.npy")[0], device=dev)
        store.size = size
        return store
