"""Device-resident vector store, one slab per device of a ``shard`` mesh
axis -- the index half of retrieval.

Counterpart of ``vietnamese_qa_system_tpu/engine/store.py``:

- dtypes ``bf16``, ``int8`` (per-vector scales), ``int8_global`` (one
  scale, calibrated on the first add) and ``int8_res`` (primary and
  residual int8 codes; the scan reads the primary slab only and a re-rank
  of ``4 * k`` candidates restores the precision);
- S shards (``mesh``'s ``shard`` axis; one shard on ``device`` without a
  mesh): global id ``g`` lives on shard ``g % S`` at slot ``g // S``
  (round-robin, so shards stay balanced under streaming ingest).  A
  trailing partial row of fewer than S vectors is written AND kept on the
  lead device as ``_tail``, and the next add re-writes it, so every slab
  is complete up to ``size``;
- a query runs the scan kernels (K1 / K2 / K3 through ``matmul_topk``) on
  every shard over its ``valid = ceil((size - shard) / S)`` rows, the
  optional exact re-rank shard-locally, maps slots to global ids, and
  merges the gathered (B, S * k) candidates, shard-major, with a stable
  descending top-k -- ``lax.top_k`` over ``all_gather``: a cross-shard
  tie goes to the LOWER SHARD, not to the lower id.  A shard shorter than
  k (or than the re-rank's K') returns its rows padded with -inf and id
  -1; a shard with no row launches nothing;
- the same capacity rounding and the same on-disk layout (``meta.json``
  with ``n_shards``, ``vectors.npy`` as float32 (S, used, D) even for
  int8 codes, ``scales.npy``, ``res_*.npy``, ``tail.npy``), so an index
  saved by either package loads in the other; a different S re-adds the
  rows in id order.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.mesh import SHARD_AXIS, Mesh
from ..ops.quant import quantize_int8, quantize_int8_residual
from ..ops.topk import MAX_K, matmul_topk
from ..parallel.collectives import all_gather


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shard_devices(mesh: Mesh | None, device) -> list[torch.device]:
    """The devices of a store's shards: the mesh's ``shard`` axis, or the
    one ``device``."""
    if mesh is None:
        return [resolve_device(device)]
    if SHARD_AXIS not in mesh.shape:
        raise ValueError(f"mesh must have a '{SHARD_AXIS}' axis")
    return [resolve_device(d) for d in mesh.axis_devices(SHARD_AXIS)]


def merge_topk(scores: list[torch.Tensor], ids: list[torch.Tensor], k: int, dst: torch.device):
    """The cross-shard merge: per-shard (B, k) candidates gathered on
    ``dst`` shard-major into (B, S * k), then a stable descending top-k
    (ties to the lower shard, as ``lax.top_k`` over the all-gather)."""
    all_s = all_gather(scores, dst, dim=1)
    all_g = all_gather(ids, dst, dim=1)
    vals, pos = torch.sort(all_s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), torch.gather(all_g, 1, pos[:, :k]).contiguous()


def pad_candidates(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Pad (B, k') candidates to (B, k) with score -inf and id -1."""
    short = k - scores.shape[1]
    if short <= 0:
        return scores, ids
    b = scores.shape[0]
    return (torch.cat([scores, scores.new_full((b, short), float("-inf"))], dim=1),
            torch.cat([ids, ids.new_full((b, short), -1)], dim=1))


@dataclasses.dataclass
class _Slab:
    """One shard's slabs on its device."""

    device: torch.device
    vectors: torch.Tensor
    scales: torch.Tensor | None
    res_vectors: torch.Tensor | None
    res_scales: torch.Tensor | None


class VectorStore:
    """Fixed-capacity inner-product index over S shards.

    ``capacity`` is rounded up so every shard's slab is a multiple of
    ``tile_n`` rows (kept for the capacity rounding and ``meta.json``; the
    kernels tile on their own)."""

    def __init__(self, capacity: int, dim: int, *, dtype: str = "bf16", tile_n: int | None = None,
                 device="cuda", mesh: Mesh | None = None):
        if dtype not in ("bf16", "int8", "int8_global", "int8_res"):
            raise ValueError(f"dtype must be bf16, int8, int8_global or int8_res, got {dtype!r}")
        if tile_n is None:
            tile_n = 4096 if dtype.startswith("int8") else 2048
        self.devices = shard_devices(mesh, device)
        self.device = self.devices[0]  # the lead: queries arrive and results merge here
        self.mesh = mesh
        s = self.n_shards = len(self.devices)
        self.dim = dim
        self.dtype = dtype
        self.cap_per_shard = _round_up(max(_round_up(capacity, s) // s, tile_n), tile_n)
        self.capacity = self.cap_per_shard * s
        self.tile_n = min(tile_n, self.cap_per_shard)
        self.size = 0
        # int8_global: one scalar scale for the whole index (ops/quant.py)
        self.global_scale: float | None = None
        self._tail = torch.zeros((0, dim), dtype=torch.float32, device=self.device)  # < S pending rows
        vec_dt = torch.bfloat16 if dtype == "bf16" else torch.int8
        has_scales = dtype in ("int8", "int8_res")
        is_res = dtype == "int8_res"
        cap = self.cap_per_shard
        self.slabs = [
            _Slab(dev, torch.zeros((cap, dim), dtype=vec_dt, device=dev),
                  torch.zeros(cap, device=dev) if has_scales else None,
                  torch.zeros((cap, dim), dtype=torch.int8, device=dev) if is_res else None,
                  torch.zeros(cap, device=dev) if is_res else None)
            for dev in self.devices
        ]

    def valid_rows(self, shard: int) -> int:
        """Rows of ``shard`` that hold data (the tail's included)."""
        return (self.size - shard + self.n_shards - 1) // self.n_shards

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
        s = self.n_shards
        row_base = (self.size - self._tail.shape[0]) // s
        combined = torch.cat([self._tail, new]) if self._tail.shape[0] else new
        n_total = combined.shape[0]
        rows = -(-n_total // s)
        if self.dtype == "int8_global" and self.global_scale is None:
            absmax = float(combined.abs().max()) if n_total else 0.0
            self.global_scale = max(absmax, 1e-12) * 1.25 / 127.0
        # the partial last row is written with zeros past the data, as the
        # JAX store pads its block (the next add re-writes the row)
        block = combined if n_total == rows * s else torch.cat([combined, combined.new_zeros((rows * s - n_total,
                                                                                             self.dim))])
        at = slice(row_base, row_base + rows)
        for sh, slab in enumerate(self.slabs):
            part = block[sh::s].to(slab.device).contiguous() if s > 1 else block
            if self.dtype == "int8":
                slab.vectors[at], slab.scales[at] = quantize_int8(part)
            elif self.dtype == "int8_res":
                q1, s1, q2, s2 = quantize_int8_residual(part)
                slab.vectors[at], slab.scales[at] = q1, s1
                slab.res_vectors[at], slab.res_scales[at] = q2, s2
            elif self.dtype == "int8_global":
                gs = torch.tensor(self.global_scale, dtype=torch.float32, device=slab.device)
                slab.vectors[at] = torch.round(part / gs).clamp(-127, 127).to(torch.int8)
            else:
                slab.vectors[at] = part.to(torch.bfloat16)
        ids = np.arange(self.size, self.size + e, dtype=np.int64)
        self.size += e
        rem = n_total % s
        self._tail = combined[n_total - rem:].clone() if rem else combined.new_zeros((0, self.dim))
        return ids

    # ---------------------------------------------------------------- query

    def topk(self, queries, k: int = 10, *, mode: str = "fast", rerank: int | None = None):
        """(B, D) queries -> (scores (B, k) f32, global ids (B, k) int32)
        tensors on the lead device.

        ``rerank=K'`` keeps ``K' >= k`` scan candidates a shard and
        re-scores them exactly against the stored representation (f32,
        with the residual on ``int8_res``) before the final top-k.
        ``None`` means ``4 * k`` on ``int8_res`` (clamped to ``MAX_K``) and
        off otherwise; ``0`` switches it off; an explicit value above
        ``MAX_K`` raises."""
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
        parts = [self._shard_topk(sh, q.to(slab.device), k, mode, rerank) for sh, slab in enumerate(self.slabs)]
        if self.n_shards == 1:
            return parts[0]
        return merge_topk([p[0] for p in parts], [p[1] for p in parts], k, self.device)

    def _shard_topk(self, sh: int, q: torch.Tensor, k: int, mode: str, rerank: int | None):
        """One shard's (scores, global ids) (B, k), padded past its rows."""
        slab, s = self.slabs[sh], self.n_shards
        valid = self.valid_rows(sh)
        b = q.shape[0]
        kp = k if rerank is None else rerank
        if valid == 0:
            return (torch.full((b, k), float("-inf"), device=slab.device),
                    torch.full((b, k), -1, dtype=torch.int32, device=slab.device))
        if self.dtype == "int8_global":
            sc = torch.tensor(self.global_scale, dtype=torch.float32, device=slab.device)
        else:
            sc = slab.scales
        scores, slots = matmul_topk(q, slab.vectors, min(kp, valid), corpus_scales=sc, valid_n=valid, mode=mode)
        if rerank is not None:
            # exact re-score of the K' candidates against the stored codes;
            # every gather is shard-local
            ok = (slots >= 0) & (slots < valid)
            safe = slots.clamp_min(0).long()
            rs = torch.einsum("bd,bkd->bk", q, slab.vectors[safe].float())
            if self.dtype == "int8_global":
                rs = rs * sc
            elif slab.scales is not None:
                rs = rs * slab.scales[safe]
            if self.dtype == "int8_res":
                rs = rs + torch.einsum("bd,bkd->bk", q, slab.res_vectors[safe].float()) * slab.res_scales[safe]
            rs = torch.where(ok, rs, float("-inf"))
            slots = torch.where(ok, slots, -1)
            srt, pos = torch.sort(rs, dim=1, descending=True, stable=True)
            scores, slots = srt[:, :k], torch.gather(slots, 1, pos[:, :k])
        if s > 1:
            slots = torch.where(slots >= 0, slots * s + sh, -1).to(torch.int32)
        scores, slots = pad_candidates(scores, slots, k)
        return scores.contiguous(), slots.contiguous()

    def get_vectors(self, ids) -> np.ndarray:
        """Global ids -> (n, D) dequantized f32 vectors on the host."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.size):
            raise ValueError(f"ids out of range [0, {self.size})")
        out = np.zeros((len(ids), self.dim), np.float32)
        for sh, slab in enumerate(self.slabs):
            at = ids % self.n_shards == sh
            if not at.any():
                continue
            idx = torch.as_tensor(ids[at] // self.n_shards, device=slab.device)
            vecs = slab.vectors[idx].float()
            if self.dtype in ("int8", "int8_res"):
                vecs = vecs * slab.scales[idx][:, None]
            if self.dtype == "int8_res":
                vecs = vecs + slab.res_vectors[idx].float() * slab.res_scales[idx][:, None]
            elif self.dtype == "int8_global":
                vecs = vecs * self.global_scale
            out[at] = vecs.cpu().numpy()
        return out

    # ------------------------------------------------------------ persist

    def save(self, path: str) -> None:
        """Host checkpoint in the JAX store's layout: the ``ceil(size / S)``
        rows of each shard that hold data, and ``capacity`` for ingest
        headroom."""
        os.makedirs(path, exist_ok=True)
        used = -(-self.size // self.n_shards)
        meta = {
            "capacity": self.capacity,
            "dim": self.dim,
            "dtype": self.dtype,
            "size": self.size,
            "n_shards": self.n_shards,
            "tile_n": self.tile_n,
            "global_scale": self.global_scale,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

        def host(name, f32=False):
            return np.stack([(getattr(sl, name)[:used].float() if f32 else getattr(sl, name)[:used]).cpu().numpy()
                             for sl in self.slabs])

        np.save(os.path.join(path, "vectors.npy"), host("vectors", f32=True))
        if self.dtype in ("int8", "int8_res"):
            np.save(os.path.join(path, "scales.npy"), host("scales"))
        if self.dtype == "int8_res":
            np.save(os.path.join(path, "res_vectors.npy"), host("res_vectors"))
            np.save(os.path.join(path, "res_scales.npy"), host("res_scales"))
        np.save(os.path.join(path, "tail.npy"), self._tail.cpu().numpy())

    @classmethod
    def load(cls, path: str, *, capacity: int | None = None, device="cuda", mesh: Mesh | None = None) -> "VectorStore":
        """Restore a saved index onto ``mesh``'s shards (one shard on
        ``device`` without a mesh).  ``capacity=None`` keeps the build-time
        capacity; an int resizes to ``max(capacity, size)`` (``0`` is
        shrink-to-fit, which serving uses).  A file of another shard count
        is re-added in id order."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("type", "flat") != "flat":
            raise ValueError(f"{path} is a {meta['type']} index, not a flat store; open it with engine.load_index")
        size, n_old, dim = meta["size"], meta["n_shards"], meta["dim"]
        cap = meta["capacity"] if capacity is None else max(capacity, size)
        store = cls(cap, dim, dtype=meta["dtype"], tile_n=meta["tile_n"], device=device, mesh=mesh)
        store.global_scale = meta.get("global_scale")

        def tail():
            return torch.as_tensor(np.load(os.path.join(path, "tail.npy")), device=store.device).float()

        if size == 0:
            store._tail = tail()
            return store

        used = -(-size // n_old)

        def load(name):
            arr = np.load(os.path.join(path, name))
            return arr.reshape(n_old, -1, *arr.shape[2:])[:, :used]

        vecs = load("vectors.npy")
        if n_old != store.n_shards:
            # round-robin ids depend on S: re-add in id order, dequantized
            # -- vectors.npy holds int8 codes for the int8 dtypes; the
            # restored global scale re-quantizes int8_global codes
            # bit-identically
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
        planes = {"vectors": vecs}
        if meta["dtype"] in ("int8", "int8_res"):
            planes["scales"] = load("scales.npy")
        if meta["dtype"] == "int8_res":
            planes["res_vectors"] = load("res_vectors.npy")
            planes["res_scales"] = load("res_scales.npy")
        for sh, slab in enumerate(store.slabs):
            for name, arr in planes.items():
                buf = getattr(slab, name)
                buf[:used] = torch.as_tensor(arr[sh], device=slab.device).to(buf.dtype)
        store.size = size
        store._tail = tail()
        return store
