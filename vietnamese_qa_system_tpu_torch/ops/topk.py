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

On a CPU tensor each kernel's plain PyTorch version runs instead; the plain
versions also serve as the references the kernels are checked against on
the card.  The int8 ``mode="exact"`` path is plain PyTorch on every device:
in the JAX package too it is XLA (topk.py:703-722), not a kernel -- a full
(B, N) int32 score matrix for the recall gate, not the serving path.
"""

from __future__ import annotations

import torch

from .cuda_kernels import TOPK_BF16, TOPK_INT8, TOPK_INT8_GLOBAL, on_card, stream_of
from .quant import div127

# Largest k of the kernels (one shared-memory list per query of the block).
MAX_K = 256
_SPLIT_ROWS = 128  # corpus rows per kernel tile (csrc/topk.cu NB)
_QUERY_TILE = 64   # queries per kernel block (csrc/topk.cu QB)


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


def _scan_cuda(kernel, kind: int, q, corpus, scales, valid_n: int, k: int):
    b, d = q.shape
    if not (q.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("matmul_topk kernels need contiguous queries and corpus")
    if corpus.device != q.device or corpus.shape[1] != d:
        raise ValueError(f"corpus {tuple(corpus.shape)} on {corpus.device} does not match queries {tuple(q.shape)} on {q.device}")
    if d % 16:
        raise ValueError(f"matmul_topk kernels need D % 16 == 0, got D={d}")
    if kind != 0 and d > 1024:
        raise ValueError(f"int8 kernels need D <= 1024 (exact f32 scores), got D={d}")
    if scales is not None and (scales.dtype != torch.float32 or not scales.is_contiguous()
                               or scales.shape != (corpus.shape[0],) or scales.device != q.device):
        raise ValueError("corpus_scales must be a contiguous (N,) float32 tensor on the corpus device")
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
        out_s.data_ptr(), out_i.data_ptr(), stream_of(q),
    )
    return out_s, out_i


def topk_bf16(q, corpus, valid_n: int, k: int):
    """K1: (scores f32, ids int32) of bf16 queries over a bf16 corpus."""
    if on_card(q):
        if q.dtype != torch.bfloat16 or corpus.dtype != torch.bfloat16:
            raise ValueError("matmul_topk_bf16 needs bf16 queries and corpus")
        return _scan_cuda(TOPK_BF16, 0, q, corpus, None, valid_n, k)
    return topk_bf16_plain(q, corpus, valid_n, k)


def topk_int8(q_i8, corpus, scales, valid_n: int, k: int):
    """K2: scores ``raw * scale[row]`` of int8 query codes over an int8 corpus."""
    if on_card(q_i8):
        if q_i8.dtype != torch.int8 or corpus.dtype != torch.int8:
            raise ValueError("matmul_topk_int8 needs int8 queries and corpus")
        return _scan_cuda(TOPK_INT8, 1, q_i8, corpus, scales, valid_n, k)
    return topk_int8_plain(q_i8, corpus, scales, valid_n, k)


def topk_int8_global(q_i8, corpus, valid_n: int, k: int):
    """K3: raw integer scores (as f32) of int8 query codes over an int8 corpus."""
    if on_card(q_i8):
        if q_i8.dtype != torch.int8 or corpus.dtype != torch.int8:
            raise ValueError("matmul_topk_int8_global needs int8 queries and corpus")
        return _scan_cuda(TOPK_INT8_GLOBAL, 2, q_i8, corpus, None, valid_n, k)
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
