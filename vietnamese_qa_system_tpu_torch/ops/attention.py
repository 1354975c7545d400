"""Flash attention, forward and backward.

Counterpart of ``vietnamese_qa_system_tpu/ops/attention.py``.  On CUDA
tensors the forward runs the hand-written kernel K4 of
``csrc/flash_fwd.cu`` (replaces the Pallas ``_fa_kernel``) and the backward
the two kernels K7 of ``csrc/flash_bwd.cu`` (replace ``_fa_bwd_fused_kernel``,
``_fa_bwd_kv_kernel`` and ``_fa_bwd_q_kernel``); on CPU tensors their plain
PyTorch versions :func:`flash_fwd_plain` and :func:`flash_bwd_plain` run
instead.

Every form of the TPU kernel is ported: bidirectional (the sentence
encoder) or causal (the causal LM's cache-less forward, i.e. training),
per-row key lengths (``kv_lens``), a causal sliding window (GPT-Neo's local
layers), and an additive score bias, full (H, Tq, Tk) (MPNet relative
positions) or key-only (H, 1, Tk) (ALiBi).  :func:`flash_attention` is
differentiable in q, k and v through a ``torch.autograd.Function`` whose
residuals are q, k, v, o and lse, as ``_flash_core_fwd`` keeps them; the
bias gets a zero cotangent, as in the JAX package (exact for ALiBi's
constant bias and for frozen relative-bias tables).

The forward is also registered as the operator ``vqa_torch::flash_fwd`` so
that the selective remat policies of models/layers.py can save its outputs
(``flash_out`` / ``flash_lse`` in the JAX package) instead of re-running the
kernel in the backward.

The kernels read their operands by TMA: q, k, v, dO and lse must be
16-byte aligned, and the bias, lse and dd are handed over with their rows
padded to a multiple of 4 floats (TMA strides and the starts of its 1-D
boxes are 16-byte multiples).  Which key tiles a query tile visits (and
which query tiles a key tile meets in the backward) is
:func:`key_tile_range` / :func:`query_tile_range`, the kernels' rule
written out so the CPU tests can hold it against the plain mask.
"""

from __future__ import annotations

import torch

from .cuda_kernels import FLASH_BWD_DKDV, FLASH_BWD_DQ, FLASH_FWD, FLASH_FWD_CAUSAL, on_card, stream_of

NEG_INF = -1e30  # finite, as in the reference: a row with no valid key averages V


def _keep(tq: int, tk: int, kv_lens, causal: bool, window, device):
    """(BH, Tq, Tk) bool: the kernels' mask -- k < kv_len, and k <= q when
    causal, and k > q - window with a window."""
    keys = torch.arange(tk, device=device)[None, None, :]
    qs = torch.arange(tq, device=device)[None, :, None]
    keep = keys < kv_lens.reshape(-1)[:, None, None]
    if causal:
        keep = keep & (keys <= qs)
    if window:
        keep = keep & (keys > qs - window)
    return keep


def key_tile_range(r0: int, rows: int, bk: int, tq: int, tk: int, kv_len: int, causal: bool, window,
                   all_if_empty: bool = True) -> tuple[int, int]:
    """The key tiles ``[lo, hi]`` (of ``bk`` keys) that query rows ``[r0, r0
    + rows)`` below ``tq`` visit in K4 (and, with ``all_if_empty=False``, in
    K7's dQ kernel); ``lo > hi``: none.  A tile is skipped only if it holds
    no key that any of these rows keeps: tiles wholly past ``kv_len``, above
    the causal diagonal or below the window band.  A row that keeps no key
    at all (``kv_len == 0``, or a windowed row at or past ``kv_len + window -
    1``) averages V over every key in the forward (the finite NEG_INF), so
    with ``all_if_empty`` such a row makes the range every tile.  The same
    rule as ``key_tile_range`` in ``csrc/hopper.cuh``."""
    window = window or 0
    r1 = min(r0 + rows, tq) - 1
    if r1 < r0:
        return 0, -1
    empty_row = kv_len <= 0 or (causal and window > 0 and r1 >= kv_len + window - 1)
    if empty_row and all_if_empty:
        return 0, -(-tk // bk) - 1
    last = min(kv_len, tk) - 1
    if causal:
        last = min(last, r1)
    if last < 0:
        return 0, -1
    lo = (r0 - window + 1) // bk if causal and window > 0 and r0 - window + 1 > 0 else 0
    return lo, last // bk


def query_tile_range(k0: int, keys: int, bq: int, tq: int, tk: int, kv_len: int, causal: bool,
                     window) -> tuple[int, int]:
    """The query tiles ``[lo, hi]`` (of ``bq`` rows) that keys ``[k0, k0 +
    keys)`` meet in a kept pair: K7's dK/dV loop (``lo > hi``: none, the
    keys' gradients are zero).  ``query_tile_range`` in ``csrc/hopper.cuh``."""
    window = window or 0
    k1 = min(k0 + keys, kv_len, tk) - 1
    if k1 < k0:
        return 0, -1
    first, last = (k0 if causal else 0), tq - 1
    if causal and window > 0:
        last = min(last, k1 + window - 1)
    if first > last:
        return 0, -1
    return first // bq, last // bq


def _scores(qb, kb, bias, n_heads: int):
    s = torch.bmm(qb.float(), kb.float().transpose(1, 2))
    if bias is not None:
        s = s + bias.float().repeat(qb.shape[0] // n_heads, 1, 1)  # (BH, Tq|1, Tk)
    return s


def flash_fwd_plain(qb, kb, vb, kv_lens, bias, n_heads: int, causal: bool = False, window: int | None = None):
    """Plain version of K4 on (BH, T, D) bf16 slabs -> (o bf16, lse f32).

    Same arithmetic as the kernel without the blocking: f32 scores, the
    bias added before the mask, probabilities rounded to bf16 for the P V
    product; the row sum adds the bf16 probabilities at D % 128 != 0 and
    the f32 ones at D = 128, as the TPU kernel does."""
    bh, tq, d = qb.shape
    s = _scores(qb, kb, bias, n_heads)
    s = torch.where(_keep(tq, kb.shape[1], kv_lens, causal, window, qb.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e.to(torch.bfloat16).float()
    l = (e if d % 128 == 0 else p).sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (torch.bmm(p, vb.float()) / l).to(torch.bfloat16)
    return o, (m + torch.log(l)).squeeze(-1)


def _check(qb, kb, vb, kv_lens, bias, n_heads: int, causal: bool, window) -> int:
    """Validate the kernels' operands; returns the bias row count."""
    bh, tq, d = qb.shape
    tk = kb.shape[1]
    for name, t in (("q", qb), ("k", kb), ("v", vb)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != qb.device:
            raise ValueError(f"flash: {name} must be a contiguous bf16 tensor on {qb.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash: {name} must be 16-byte aligned (the kernels read it by TMA)")
    if kb.shape != (bh, tk, d) or vb.shape != (bh, tk, d):
        raise ValueError(f"flash: k {tuple(kb.shape)} / v {tuple(vb.shape)} do not match q {tuple(qb.shape)}")
    if d not in (32, 64, 128):
        raise ValueError(f"flash kernels support head dims 32, 64 and 128, got {d}")
    if kv_lens.dtype != torch.int32 or kv_lens.shape != (bh,) or not kv_lens.is_contiguous() or kv_lens.device != qb.device:
        raise ValueError("flash: kv_lens must be a contiguous (BH,) int32 tensor on the q device")
    if bh % n_heads:
        raise ValueError(f"flash: BH={bh} is not a multiple of n_heads={n_heads}")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if bias is None:
        return 0
    if (bias.dtype != torch.float32 or not bias.is_contiguous() or bias.device != qb.device
            or bias.shape not in ((n_heads, tq, tk), (n_heads, 1, tk))):
        raise ValueError(f"flash: bias must be a contiguous ({n_heads}, {tq} or 1, {tk}) float32 tensor")
    return bias.shape[1]


def _f32_rows(x):
    """An f32 operand as the kernels read it (the bias, lse, dd): rows
    padded to a multiple of 4 floats, 16-byte aligned (TMA strides,
    addresses and the starts of its 1-D boxes are 16-byte multiples); the
    padding lies past Tk (bias) or Tq (lse, dd) and is masked."""
    if x is None:
        return None
    pad = -x.shape[-1] % 4
    if pad or x.data_ptr() % 16:
        x = torch.nn.functional.pad(x, (0, pad)).contiguous()
    return x


def flash_fwd(qb, kb, vb, kv_lens, bias, n_heads: int, causal: bool = False, window: int | None = None):
    """K4 on (BH, T, D) bf16 slabs (q pre-scaled), ``kv_lens`` (BH,) int32,
    ``bias`` (H, Tq, Tk) or (H, 1, Tk) f32 or None, ``causal``, ``window``
    (causal only) -> (o (BH, Tq, D) bf16, lse (BH, Tq) f32)."""
    if not on_card(qb):
        return flash_fwd_plain(qb, kb, vb, kv_lens, bias, n_heads, causal, window)
    bias_rows = _check(qb, kb, vb, kv_lens, bias, n_heads, causal, window)
    bias = _f32_rows(bias)
    bh, tq, d = qb.shape
    o = torch.empty((bh, tq, d), dtype=torch.bfloat16, device=qb.device)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=qb.device)
    (FLASH_FWD_CAUSAL if causal else FLASH_FWD).launch(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), kv_lens.data_ptr(),
        None if bias is None else bias.data_ptr(), bias_rows, bh, n_heads, tq, kb.shape[1], d,
        int(causal), int(window or 0), o.data_ptr(), lse.data_ptr(), stream_of(qb), device=qb.device,
    )
    return o, lse


def flash_bwd_plain(qb, kb, vb, o, lse, do, kv_lens, bias, n_heads: int, causal: bool = False,
                    window: int | None = None):
    """Plain version of K7 -> (dq, dk, dv) bf16: P recomputed from lse
    under the forward's mask (0 where masked), dS = P * (dP - rowsum(dO *
    O)), products of bf16-rounded P and dS with f32 accumulation."""
    dd = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    s = _scores(qb, kb, bias, n_heads)
    keep = _keep(qb.shape[1], kb.shape[1], kv_lens, causal, window, qb.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.bmm(do.float(), vb.float().transpose(1, 2)) - dd)
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dv = torch.bmm(pb.transpose(1, 2), do.float())
    dk = torch.bmm(dsb.transpose(1, 2), qb.float())
    dq = torch.bmm(dsb, kb.float())
    return dq.to(torch.bfloat16), dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def flash_bwd(qb, kb, vb, o, lse, do, kv_lens, bias, n_heads: int, causal: bool = False,
              window: int | None = None):
    """K7: the forward's residuals (q, k, v, o (BH, T, D) bf16, lse (BH, Tq)
    f32) and dO (BH, Tq, D) bf16 -> (dq, dk, dv) bf16.  ``dd = rowsum(dO *
    O)`` is plain torch, as it is XLA in the JAX package."""
    if not on_card(qb):
        return flash_bwd_plain(qb, kb, vb, o, lse, do, kv_lens, bias, n_heads, causal, window)
    bias_rows = _check(qb, kb, vb, kv_lens, bias, n_heads, causal, window)
    bh, tq, d = qb.shape
    tk = kb.shape[1]
    for name, t, shape, dtype in (("o", o, (bh, tq, d), torch.bfloat16), ("do", do, (bh, tq, d), torch.bfloat16),
                                  ("lse", lse, (bh, tq), torch.float32)):
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous() or t.device != qb.device:
            raise ValueError(f"flash_bwd: {name} must be a contiguous {shape} {dtype} tensor on {qb.device}")
        if name != "o" and t.data_ptr() % 16:  # o feeds only dd, in torch
            raise ValueError(f"flash_bwd: {name} must be 16-byte aligned (the kernels read it by TMA)")
    bias = _f32_rows(bias)
    lse, dd = _f32_rows(lse), _f32_rows((do.float() * o.float()).sum(dim=-1))
    dq = torch.empty_like(qb)
    dk = torch.empty_like(kb)
    dv = torch.empty_like(vb)
    common = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
              kv_lens.data_ptr(), None if bias is None else bias.data_ptr(), bias_rows, bh, n_heads, tq, tk, d,
              int(causal), int(window or 0))
    FLASH_BWD_DKDV.launch(*common, dk.data_ptr(), dv.data_ptr(), stream_of(qb), device=qb.device)
    FLASH_BWD_DQ.launch(*common, dq.data_ptr(), stream_of(qb), device=qb.device)
    return dq, dk, dv


@torch.library.custom_op(
    "vqa_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor kv_lens, Tensor? bias, int n_heads, bool causal, int window)"
           " -> (Tensor, Tensor)",
)
def _flash_fwd_op(qb, kb, vb, kv_lens, bias, n_heads, causal, window):
    return flash_fwd(qb, kb, vb, kv_lens, bias, n_heads, causal, window or None)


class FlashAttention(torch.autograd.Function):
    """K4 forward, K7 backward on (BH, T, D) bf16 slabs.  Residuals q, k, v,
    o, lse; the bias cotangent is zero."""

    @staticmethod
    def forward(ctx, qb, kb, vb, kv_lens, bias, n_heads: int, causal: bool, window: int):
        o, lse = torch.ops.vqa_torch.flash_fwd(qb, kb, vb, kv_lens, bias, n_heads, causal, window)
        ctx.save_for_backward(qb, kb, vb, o, lse, kv_lens, bias)
        ctx.cfg = (n_heads, causal, window or None)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qb, kb, vb, o, lse, kv_lens, bias = ctx.saved_tensors
        n_heads, causal, window = ctx.cfg
        dq, dk, dv = flash_bwd(qb, kb, vb, o, lse, do.to(torch.bfloat16).contiguous(), kv_lens, bias, n_heads,
                               causal, window)
        dbias = torch.zeros_like(bias) if bias is not None and ctx.needs_input_grad[4] else None
        return dq, dk, dv, None, dbias, None, None, None


def flash_attention(q, k, v, *, kv_lens=None, causal: bool = True, scale: float | None = None,
                    bias=None, window: int | None = None):
    """Fused attention over (B, T, H, D) tensors -> (B, Tq, H, D) bf16,
    differentiable in q, k and v.

    - ``kv_lens`` (B,) int: valid key length per row (right padding);
      defaults to the full length.
    - ``bias``: optional (H, Tq, Tk) -- or (H, 1, Tk), broadcast over the
      queries (ALiBi's key-only form) -- additive score bias shared across
      the batch, added after the scaling; its cotangent is zero.
    - ``window``: optional sliding window (causal only): a query attends to
      at most ``window`` keys ending at itself.
    """
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        window = int(window)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d).to(torch.bfloat16).contiguous()

    # the softmax scale is folded into q before the bf16 cast, as the
    # reference does (attention.py:1043); autograd through the multiply
    # restores it on dq
    qb = to_bh(q * scale if scale != 1.0 else q)
    if kv_lens is None:
        lens = torch.full((b * h,), tk, dtype=torch.int32, device=q.device)
    else:
        lens = torch.as_tensor(kv_lens, device=q.device).to(torch.int32).repeat_interleave(h).contiguous()
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    o, _ = FlashAttention.apply(qb, to_bh(k), to_bh(v), lens, bias, h, causal, window or 0)
    return o.reshape(b, h, tq, d).permute(0, 2, 1, 3)


def flash_attention_reference(q, k, v, *, kv_lens=None, causal: bool = True, scale=None, window=None):
    """(B, T, H, D) oracle with the reference's masking semantics, all f32."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lens = torch.full((b,), tk, device=q.device) if kv_lens is None else torch.as_tensor(kv_lens, device=q.device)
    k_pos = torch.arange(tk, device=q.device)[None, None, None, :]
    q_pos = torch.arange(tq, device=q.device)[None, None, :, None]
    mask = k_pos < lens.reshape(b, 1, 1, 1)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
