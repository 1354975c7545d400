"""Fused matmul + exact top-k over a corpus: the retrieval scan.

Counterpart of ``vietnamese_qa_system_tpu/ops/topk.py:631-766``.  On a CUDA
tensor the scan runs the hand-written kernels of ``csrc/topk.cu``:

- K1 bf16 corpus, f32 scores (replaces ``_fast_kernel_bf16`` and
  ``_exact_kernel_bf16``);
- K2 int8 corpus with per-row scales: ``raw * scale[row]`` is selected on
  (replaces ``_fast_kernel_int8``);
- K3 int8 corpus with one global scale: raw int32 scores are selected on
  (replaces ``_fast_kernel_int8_global``).

Every mode is exact (``fast``, ``turbo`` and ``exact`` are validated for API
parity): the TPU's lossy lane-bucket selection existed only because of how
its vector unit selects.  Ties resolve to the lowest index everywhere.

Each takes one of three kernel forms by a pure shape rule
(:func:`bf16_route`, :func:`int8_route`, :func:`int8_global_route`): the
cluster scan (TMA multicast of the corpus across a cluster of 1-4 CTAs,
wgmma products, selection from registers; one template over the three
element forms) with sorted lists in shared memory (``"cluster"``: k <= 64
where at least 4 ring stages fit beside the queries and the lists, k <= 60
for bf16 at D 768); the same scan with per-query pools in global scratch
(``"large"``: k <= 256, e.g. an explicit rerank or ``int8_res``'s 4 k);
and the tile scan (``"scan"``) where neither fits, e.g. D % 64 != 0.
Every form ends in one merge, a radix select of the k-th candidate key
(:func:`merge_key`) a query.

On a CPU tensor each kernel's plain PyTorch version runs instead; the plain
versions also serve as the references the kernels are checked against on
the card.  The int8 ``mode="exact"`` path is plain PyTorch on every device:
in the JAX package too it is XLA (topk.py:703-722), not a kernel -- a full
(B, N) int32 score matrix for the recall gate, not the serving path.
"""

from __future__ import annotations

import functools

import torch

from .cuda_kernels import (TOPK_BF16, TOPK_BF16_LARGE, TOPK_BF16_SCAN, TOPK_INT8, TOPK_INT8_GLOBAL,
                           TOPK_INT8_GLOBAL_SCAN, TOPK_INT8_SCAN, on_card, query, stream_of)
from .quant import div127

# Largest k of the kernels (the pools' and the tile scan's lists).
MAX_K = 256
_SPLIT_ROWS = 128  # corpus rows per kernel tile (csrc/topk.cu NB)
_QUERY_TILE = 64   # queries per kernel block (csrc/topk.cu QB)

# The cluster scan (csrc/topk.cu namespace clus): 64 queries a CTA, at most
# 4 CTAs (256 queries) a cluster, 128-row corpus tiles in panels of 128-byte
# rows (64 bf16 or 128 int8 columns, 16 KB) through a ring of 4-8 stages
# (K2: and a tile's 512 B of row scales a stage; K3 reads none), then the
# selection's state: two warpgroups' (64, k) lists and 8 winner queues of
# 64 entries (lists; int8 at k > 16 also the floors' state), or the
# floors' state alone -- 2 x 64 rows' counts, thresholds, floors and 8
# published maxima, and 8 histograms of 256 bins (pools, whose
# POOL_CAP-entry pools live in global scratch)
CLUSTER_MAX_CTAS = 4
CLUSTER_MAX_K = 64   # the list form's largest k
POOL_CAP = 512
_POOL_SLOTS = 8  # published maxima a (warpgroup, query): csrc/topk.cu MAX_SLOTS
_ROW_BYTES = 128
_STAGE_BYTES = 128 * _ROW_BYTES
_SCALE_BYTES = 128 * 4
_CLUSTER_STAGES = (4, 8)
_SMEM_LIMIT = 232_448  # shared memory of an H100 block
_FORMS = {"cluster": 1, "large": 2}
# the element forms (csrc/topk.cu Elem): K1 bf16, K2 int8 with row scales,
# K3 int8 selected on its raw sums
ELEMS = {"bf16": 0, "int8": 1, "int8_global": 2}


def cluster_size(b: int) -> int:
    """CTAs of a cluster for a batch of b queries: the power of two that
    holds its 64-query tiles, at most 4 (more queries are more groups of
    256)."""
    tiles = min(CLUSTER_MAX_CTAS, -(-b // _QUERY_TILE))
    return 1 << (tiles - 1).bit_length()


def _elem_code(elem: str) -> int:
    if elem not in ELEMS:
        raise ValueError(f"element form must be one of {sorted(ELEMS)}, got {elem!r}")
    return ELEMS[elem]


def cluster_stages(k: int, d: int, *, elem: str = "bf16", pools: bool = False) -> int:
    """Ring stages of the cluster scan beside the (64, d) queries, the
    selection's state (lists, for int8 at k > 16 with their floors; or
    pools) and the barriers (csrc/topk.cu clus::stages_for): 16 KB a stage,
    and 512 B more for K2's row scales."""
    panels = -(-d * (2 if _elem_code(elem) == ELEMS["bf16"] else 1) // _ROW_BYTES)
    floors = 2 * 64 * (16 + 4 * _POOL_SLOTS) + 8 * 256 * 4  # the pools' and the int8 lists' floors
    select = floors if pools else 1024 * k + 8 * 64 * 12 + (floors if _has_floors(k, elem, pools) else 0)
    fixed = 64 * _ROW_BYTES * panels + select + 8 * (1 + 3 * _CLUSTER_STAGES[1])
    stage = _STAGE_BYTES + (_SCALE_BYTES if elem == "int8" else 0)
    return min(_CLUSTER_STAGES[1], (_SMEM_LIMIT - fixed) // stage)


def _has_floors(k: int, elem: str, pools: bool) -> bool:
    """Whether the form publishes per-split maxima for a floor: the pools,
    and the int8 forms' lists of more than 16 entries (csrc/topk.cu
    has_floors)."""
    return pools or (_elem_code(elem) != ELEMS["bf16"] and k > 16)


def _route(k: int, d: int, elem: str) -> str:
    if d < 64 or d % 64 or not 1 <= k <= MAX_K or (_elem_code(elem) != ELEMS["bf16"] and d > 1024):
        return "scan"
    if k <= CLUSTER_MAX_K and cluster_stages(k, d, elem=elem) >= _CLUSTER_STAGES[0]:
        return "cluster"
    return "large" if cluster_stages(k, d, elem=elem, pools=True) >= _CLUSTER_STAGES[0] else "scan"


def bf16_route(k: int, d: int) -> str:
    """K1's kernel for top-k at feature width d: ``"cluster"`` (the list
    form) where d is a multiple of 64, k <= 64 and its shared memory holds
    at least 4 ring stages; else ``"large"`` (the pool form) where k <= 256
    and at least 4 stages fit beside the queries; else ``"scan"``."""
    return _route(k, d, "bf16")


def int8_route(k: int, d: int) -> str:
    """K2's kernel, by the rule of :func:`bf16_route` over int8 panels
    (queries of d bytes a row, 512 B of scales a stage) and d <= 1024."""
    return _route(k, d, "int8")


def int8_global_route(k: int, d: int) -> str:
    """K3's kernel, by the rule of :func:`int8_route` over 16 KB stages
    (no scales): as many ring stages as the shared memory left holds."""
    return _route(k, d, "int8_global")


def merge_key(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The merge's 64-bit key of (score, id) (csrc/topk.cu merge_key), with
    its top bit flipped so that int64 order is the key's unsigned order:
    smaller ranks first -- higher score, then lower id; -0.0 ranks as +0.0."""
    u = scores.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where((u & 0x7FFFFFFF) == 0, torch.zeros_like(u), u)
    h = torch.where(u >= 1 << 31, u, u ^ 0x7FFFFFFF)
    return (h - (1 << 31)) * (1 << 32) + (ids.long() & 0xFFFFFFFF)


@functools.lru_cache(maxsize=None)
def _cluster_capacity(device_index: int, elem: str, ctas: int, k: int, d: int) -> int:
    """Clusters of ``ctas`` CTAs the card holds at once at this shape."""
    with torch.cuda.device(device_index):
        n = cluster_info(ctas, k, d, elem=elem)["max_clusters"]
    if n < 1:
        raise RuntimeError(f"matmul_topk: no cluster of {ctas} CTAs fits the card (k={k}, D={d}, {elem})")
    return n


def cluster_info(ctas: int, k: int, d: int, *, elem: str = "bf16") -> dict:
    """The cluster scan's occupancy and resources on the current device, in
    the form that runs (k, d) for the element form ``elem``."""
    n, regs, smem, local, stages, form = query(TOPK_BF16.file, "vqa_topk_cluster_info", _elem_code(elem),
                                               ctas, k, d)[:6]
    return {"max_clusters": n, "registers": regs, "shared_bytes": smem, "local_bytes": local, "stages": stages,
            "form": {v: r for r, v in _FORMS.items()}[form]}


def cluster_plan(b: int, k: int, d: int, valid_n: int, device, *, elem: str = "bf16") -> tuple[int, int]:
    """(CTAs a cluster, clusters) of a cluster-scan call: as many clusters
    as the card holds at once, each with a contiguous range of the
    ceil(valid_n / 128) corpus tiles (cluster c of G takes tiles
    [c T / G, (c + 1) T / G))."""
    ctas = cluster_size(b)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return ctas, min(_cluster_capacity(index, elem, ctas, k, d), -(-valid_n // 128))


def _topk_rows(scores: torch.Tensor, k: int):
    """Top-k per row ordered by (score desc, index asc), like lax.top_k."""
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32).contiguous()


def quantize_queries(queries: torch.Tensor):
    """Per-row symmetric int8 query codes and (B, 1) scales (topk.py:698-701)."""
    qf = queries.float()
    qscale = div127(qf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12))
    q_i8 = torch.round(qf / qscale).clamp(-127, 127).to(torch.int8)
    return q_i8, qscale


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the references for the kernels on the card)
# ---------------------------------------------------------------------------


def topk_bf16_plain(q: torch.Tensor, corpus: torch.Tensor, valid_n: int, k: int):
    """bf16 queries x bf16 corpus rows [0, valid_n), f32 products."""
    return _topk_rows(q.float() @ corpus[:valid_n].float().T, k)


def _int8_raw(q_i8: torch.Tensor, corpus: torch.Tensor, valid_n: int):
    # exact in f32: every partial sum of a D <= 1024 dot of +-127 codes is
    # an integer below 2^24, so the order of the additions cannot matter
    return q_i8.float() @ corpus[:valid_n].float().T


def topk_int8_plain(q_i8, corpus, scales, valid_n: int, k: int):
    """K2 semantics: select on ``raw * scale[row]``; returns those scores."""
    return _topk_rows(_int8_raw(q_i8, corpus, valid_n) * scales[:valid_n], k)


def topk_int8_global_plain(q_i8, corpus, valid_n: int, k: int):
    """K3 semantics: select on the raw integer scores; returns them as f32."""
    return _topk_rows(_int8_raw(q_i8, corpus, valid_n), k)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(q, corpus):
    b, d = q.shape
    if not (q.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("matmul_topk kernels need contiguous queries and corpus")
    if corpus.device != q.device or corpus.shape[1] != d:
        raise ValueError(f"corpus {tuple(corpus.shape)} on {corpus.device} does not match queries {tuple(q.shape)} on {q.device}")
    if d % 16:
        raise ValueError(f"matmul_topk kernels need D % 16 == 0, got D={d}")


# each cluster-scan kernel's element form
_CLUSTER_ELEM = {TOPK_BF16: "bf16", TOPK_BF16_LARGE: "bf16", TOPK_INT8: "int8", TOPK_INT8_GLOBAL: "int8_global"}


def _cluster_cuda(kernel, q, corpus, scales, valid_n: int, k: int, route: str, *, what: int = 3, scratch=None):
    """The cluster scan in the form of ``route`` and the element form of
    ``kernel``, then the merge of its per-(cluster, warpgroup) candidates;
    returns (scores, ids, scratch).  ``what`` 1 / 2 runs the scan / the
    merge alone over ``scratch`` (the timing of the two apart)."""
    elem = _CLUSTER_ELEM[kernel]
    if q.dtype != (torch.bfloat16 if elem == "bf16" else torch.int8) or (scales is not None) != (elem == "int8"):
        raise ValueError(f"{kernel.name} takes {'bf16' if elem == 'bf16' else 'int8'} queries and "
                         f"{'row scales' if elem == 'int8' else 'no scales'}, got {q.dtype} and "
                         f"{'scales' if scales is not None else 'none'}")
    _check_operands(q, corpus)
    if corpus.data_ptr() % 16 or (scales is not None and scales.data_ptr() % 16):
        raise ValueError("matmul_topk's cluster scan needs a 16-byte aligned corpus and scales (TMA)")
    if q.data_ptr() % 16:
        q = q.clone()
    b, d = q.shape
    ctas, clusters = cluster_plan(b, k, d, valid_n, q.device, elem=elem)
    pools = route == "large"
    floors = _has_floors(k, elem, pools)  # the published maxima (and the pools' candidate counts) start at zero
    if scratch is None:
        dev = q.device
        pool = (b, 2 * clusters, POOL_CAP) if pools else (0,)
        scratch = (torch.empty(pool, dtype=torch.float32, device=dev), torch.empty(pool, dtype=torch.int32, device=dev),
                   torch.zeros((b * (POOL_CAP + 1) if floors else 0,), dtype=torch.int32, device=dev),
                   torch.empty((b, 2 * clusters, k), dtype=torch.float32, device=dev),
                   torch.empty((b, 2 * clusters, k), dtype=torch.int32, device=dev),
                   torch.empty((b, k), dtype=torch.float32, device=dev), torch.empty((b, k), dtype=torch.int32, device=dev))
    elif floors and what & 1:
        scratch[2].zero_()
    ptrs = [t.data_ptr() if t.numel() else None for t in scratch]
    kernel.launch(ELEMS[elem], q.data_ptr(), corpus.data_ptr(), None if scales is None else scales.data_ptr(),
                  b, d, valid_n, k, _FORMS[route], ctas, clusters, *ptrs, what, stream_of(q), device=q.device)
    return scratch[5], scratch[6], scratch


def _check_scales(scales, corpus):
    if scales is not None and (scales.dtype != torch.float32 or not scales.is_contiguous()
                               or scales.shape != (corpus.shape[0],) or scales.device != corpus.device):
        raise ValueError("corpus_scales must be a contiguous (N,) float32 tensor on the corpus device")


def _scan_cuda(kernel, kind: int, q, corpus, scales, valid_n: int, k: int):
    _check_operands(q, corpus)
    b, d = q.shape
    if kind != 0 and d > 1024:
        raise ValueError(f"int8 kernels need D <= 1024 (exact f32 scores), got D={d}")
    _check_scales(scales, corpus)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    q_tiles = -(-b // _QUERY_TILE)
    splits = max(1, min(-(-valid_n // _SPLIT_ROWS), -(-2 * sms // q_tiles)))
    dev = q.device
    cand_s = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    kernel.launch(
        kind, q.data_ptr(), corpus.data_ptr(), None if scales is None else scales.data_ptr(),
        b, d, valid_n, k, splits, cand_s.data_ptr(), cand_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), stream_of(q), device=q.device,
    )
    return out_s, out_i


def topk_bf16(q, corpus, valid_n: int, k: int):
    """K1: (scores f32, ids int32) of bf16 queries over a bf16 corpus."""
    if on_card(q):
        if q.dtype != torch.bfloat16 or corpus.dtype != torch.bfloat16:
            raise ValueError("matmul_topk_bf16 needs bf16 queries and corpus")
        route = bf16_route(k, q.shape[1])
        if route == "scan":
            return _scan_cuda(TOPK_BF16_SCAN, ELEMS["bf16"], q, corpus, None, valid_n, k)
        kernel = TOPK_BF16 if route == "cluster" else TOPK_BF16_LARGE
        return _cluster_cuda(kernel, q, corpus, None, valid_n, k, route)[:2]
    return topk_bf16_plain(q, corpus, valid_n, k)


def topk_int8(q_i8, corpus, scales, valid_n: int, k: int):
    """K2: scores ``raw * scale[row]`` of int8 query codes over an int8 corpus."""
    if on_card(q_i8):
        if q_i8.dtype != torch.int8 or corpus.dtype != torch.int8:
            raise ValueError("matmul_topk_int8 needs int8 queries and corpus")
        route = int8_route(k, q_i8.shape[1])
        if scales is None:
            raise ValueError("matmul_topk_int8 needs the corpus row scales")
        if route == "scan":
            return _scan_cuda(TOPK_INT8_SCAN, ELEMS["int8"], q_i8, corpus, scales, valid_n, k)
        _check_scales(scales, corpus)
        return _cluster_cuda(TOPK_INT8, q_i8, corpus, scales, valid_n, k, route)[:2]
    return topk_int8_plain(q_i8, corpus, scales, valid_n, k)


def topk_int8_global(q_i8, corpus, valid_n: int, k: int):
    """K3: raw integer scores (as f32) of int8 query codes over an int8 corpus."""
    if on_card(q_i8):
        if q_i8.dtype != torch.int8 or corpus.dtype != torch.int8:
            raise ValueError("matmul_topk_int8_global needs int8 queries and corpus")
        route = int8_global_route(k, q_i8.shape[1])
        if route == "scan":
            return _scan_cuda(TOPK_INT8_GLOBAL_SCAN, ELEMS["int8_global"], q_i8, corpus, None, valid_n, k)
        return _cluster_cuda(TOPK_INT8_GLOBAL, q_i8, corpus, None, valid_n, k, route)[:2]
    return topk_int8_global_plain(q_i8, corpus, valid_n, k)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def matmul_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int = 10,
    *,
    corpus_scales: torch.Tensor | None = None,
    valid_n: int | None = None,
    mode: str = "fast",
):
    """Top-k inner products of ``queries`` (B, D) against ``corpus`` (N, D).

    Returns ``(scores (B, k) f32, indices (B, k) int32)`` sorted descending,
    ties broken toward the lowest index.

    - bf16/f32 corpus: bf16 inputs, f32 scores (K1).
    - int8 corpus with ``corpus_scales`` (N,): queries are quantized per
      row on the fly; selection on ``raw * scale[row]`` (K2), and the query
      scale multiplies the (B, k) output.
    - int8 corpus with a 0-d ``corpus_scales`` (global scale): selection on
      the raw integer scores (K3); ``(raw * scale) * query_scale`` is
      applied to the (B, k) output, in the order of the JAX exact mode.

    ``valid_n`` masks trailing rows (the kernels never read them).  Every
    mode is exact; ``k <= MAX_K`` and at least k valid rows are required.
    """
    if mode not in ("fast", "exact", "turbo"):
        raise ValueError(f"mode must be 'fast', 'exact' or 'turbo', got {mode!r}")
    b, d = queries.shape
    n = corpus.shape[0]
    valid_n = n if valid_n is None else int(valid_n)
    if valid_n < k:
        raise ValueError(f"need at least k={k} valid rows, got {valid_n}")
    if valid_n > n:
        raise ValueError(f"valid_n={valid_n} exceeds the corpus size {n}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if corpus.dtype == torch.int8:
        if corpus_scales is None:
            raise ValueError("int8 corpus requires corpus_scales")
        cs = corpus_scales.to(device=corpus.device, dtype=torch.float32)
        q_i8, qscale = quantize_queries(queries)
        if mode == "exact":
            raw = _int8_raw(q_i8, corpus, valid_n)
            s, i = _topk_rows(raw * (cs if cs.ndim == 0 else cs[:valid_n]) * qscale, k)
            return s, i
        if cs.ndim == 0:
            s_raw, i = topk_int8_global(q_i8, corpus, valid_n, k)
            return s_raw * cs * qscale, i
        s_raw, i = topk_int8(q_i8, corpus, cs.contiguous(), valid_n, k)
        return s_raw * qscale, i
    q = queries.to(torch.bfloat16).contiguous()
    c = corpus if corpus.dtype == torch.bfloat16 else corpus.to(torch.bfloat16)
    return topk_bf16(q, c, valid_n, k)


def matmul_topk_reference(queries, corpus, k: int = 10, *, valid_n: int | None = None):
    """Plain f32 oracle: the full (B, N) score matrix, then a stable top-k."""
    scores = queries.float() @ corpus.float().T
    if valid_n is not None and valid_n < corpus.shape[0]:
        scores[:, valid_n:] = float("-inf")
    return _topk_rows(scores, k)
