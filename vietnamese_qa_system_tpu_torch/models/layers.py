"""Transformer building blocks of the encoder and the causal LM, as
``nn.Module``s.

Counterpart of ``vietnamese_qa_system_tpu/models/layers.py``: ``Dense``
(float, or int8 / int8c / nf4 / nf4-dq leaves, with LoRA factors attached
by models/lora.py, per row for an adapter bank), ``LayerNorm`` (RMSNorm
when it has no bias), RoPE (partial rotary), ALiBi slopes and the key-only bias, ``kv_quantize`` /
``kv_dequantize`` (the int8 KV cache), ``Attention`` (a bf16 or int8 KV
cache written at a scalar ``cache_index`` or at per-row cursors, GQA,
``clip_qkv``, cross-attention over an encoder output or its precomputed
K/V (``cross_attention_kv``), the masked-softmax path
(``masked_attention``; on the card, kernel K9 over a bf16 cache), and the flash
path: the encoder's bidirectional form and the causal LM's causal /
sliding-window forms, differentiable through kernels K4 and K7),
``MLP`` (plain or gated), ``Block`` (pre-LN, post-LN, parallel residual;
with ``cross=True`` the encoder-decoder's cross-attention sublayer),
``remat_wrap`` (the remat policies, through ``torch.utils.checkpoint``),
``causal_mask`` and ``padding_mask``; and the tensor-parallel forms
(``split_dense``, ``head_groups``, ``TPAttention`` with its
cross-attention, ``TPMLP``, ``tp_block``, ``SplitVocab``) that
``parallel/sharding.py`` places over a mesh's ``model`` axis.

Parameter names and layouts follow the JAX pytree (dense weights are
(d_in, d_out) and applied as ``x @ w``), so a JAX parameter tree maps onto
``state_dict`` keys by joining its path with dots (models/params.py).

Numerics follow the JAX package's cast points: every product rounds its
inputs to bf16 and accumulates in f32 (``_matmul``, layers.py:37-42);
norms and softmax run in f32; with the bf16 activation policy the residual
stream and the norm outputs are rounded to bf16.  The product is a float32
matmul of bf16-rounded inputs on every device (an exact emulation of
``preferred_element_type=float32``; TF32 is off, see core/device.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import functools
import math
import re

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..core import tracing
from ..ops.attention import flash_attention
from ..ops.decode_attention import decode_attention
from ..ops.decode_attention import supports as decode_attn_supports
from ..ops.quant import div127
from ..ops.w8_matmul import supports as w8_supports
from ..ops.w8_matmul import w8_matmul
from ..parallel.collectives import all_gather, all_reduce_sum

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30  # finite, as in the reference
# the counter of cached-attention calls on the card that kept the einsum
# (core/tracing.py); those that took K9 are its launches
CACHED_EINSUM = "attention.cached_einsum"

# set by remat_wrap("proj_bf16") while the wrapped layer runs (its forward
# and its recompute in the backward): Dense rounds its output to bf16
# through the operator below, which the policy saves (layers.py:22-34)
_TAG_PROJ_BF16 = contextvars.ContextVar("tag_proj_bf16", default=False)


@torch.library.custom_op("vqa_torch::proj_bf16", mutates_args=(), schema="(Tensor x) -> Tensor")
def _proj_bf16(x):
    return x.to(torch.bfloat16, copy=True)


def _proj_bf16_context(ctx, inputs, output):
    ctx.dtype = inputs[0].dtype


_proj_bf16.register_autograd(lambda ctx, grad: grad.to(ctx.dtype), setup_context=_proj_bf16_context)


def _maybe_tag_proj(y):
    return torch.ops.vqa_torch.proj_bf16(y) if _TAG_PROJ_BF16.get() else y


def _policy(saved) -> functools.partial:
    """A selective-checkpoint context: the outputs of the ``saved``
    operators are kept from the forward, everything else is recomputed."""
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_wrap(fn, policy_name: str):
    """Wrap a layer body per ``ModelConfig.remat_policy``
    (layers.py:45-107), through non-reentrant ``torch.utils.checkpoint``:

    - ``"full"``: save only the layer's inputs; the backward re-runs the
      whole layer forward, the flash kernel K4 included.
    - ``"dots"``: save every matrix product's output (``aten.mm`` /
      ``aten.addmm``, the projections) and the flash forward's o and lse
      (the ``vqa_torch::flash_fwd`` operator); the rest is recomputed.
    - ``"proj_bf16"``: every dense output (LoRA correction included) is
      rounded to bf16 -- in the forward too, which is why the losses of
      this policy differ from the others' -- and saved, with the flash
      forward's o and lse; the rest is recomputed.
    - ``"none"``: no remat.

    PyTorch's eager checkpoint recomputes every operator it does not save,
    including the inputs of saved ones (XLA drops the dead ones), so
    ``dots`` and ``proj_bf16`` re-run the base dequantization and, in
    ``proj_bf16``, the projections' products.  Without autograd (eval) the
    layer runs plainly; ``proj_bf16`` still rounds."""
    if policy_name == "none":
        return fn
    if policy_name not in ("full", "dots", "proj_bf16"):
        raise ValueError(f"unknown remat_policy {policy_name!r}; want full | dots | proj_bf16 | none")
    flash = torch.ops.vqa_torch.flash_fwd.default
    context_fn = None
    body = fn
    if policy_name == "dots":
        context_fn = _policy({torch.ops.aten.mm.default, torch.ops.aten.addmm.default, flash})
    elif policy_name == "proj_bf16":
        context_fn = _policy({torch.ops.vqa_torch.proj_bf16.default, flash})

        def body(*a, **k):
            tok = _TAG_PROJ_BF16.set(True)
            try:
                return fn(*a, **k)
            finally:
                _TAG_PROJ_BF16.reset(tok)

    def wrapped(*a, **k):
        if not torch.is_grad_enabled():
            return body(*a, **k)
        if context_fn is None:
            return checkpoint(body, *a, use_reentrant=False, **k)
        return checkpoint(body, *a, use_reentrant=False, context_fn=context_fn, **k)

    return wrapped


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE).float() @ w.to(COMPUTE_DTYPE).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32."""
    return x.to(COMPUTE_DTYPE).float()


# 16-level normal-float codebook of nf4 (quantize.py:34-58 of the JAX
# package): quantiles of a standard normal renormalized to [-1, 1]
NF4_LEVELS = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453, -0.28444138169288635,
    -0.18477343022823334, -0.09105003625154495, 0.0, 0.07958029955625534, 0.16093020141124725,
    0.24611230194568634, 0.33791524171829224, 0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
)


@functools.lru_cache(maxsize=None)
def _nf4_levels(device: str) -> torch.Tensor:
    """:data:`NF4_LEVELS` as an f32 tensor on ``device``, made once per
    device (a host copy at every dequantization would stall a decode
    step); never written to."""
    return torch.tensor(NF4_LEVELS, dtype=torch.float32).to(device)


def dequantize_weight(w_q: torch.Tensor, w_s: torch.Tensor | None, dtype=torch.bfloat16, *, s_q=None, s_s=None,
                      s_m=None) -> torch.Tensor:
    """Reconstruct the (d_in, d_out) weight of a quantized leaf
    (quantize.py:207-238): int8 codes ``w_q`` (d_in, d_out), or packed nf4
    codes (uint8 (d_in / 2, d_out), even row in the low nibble) looked up
    in :data:`NF4_LEVELS`, times the f32 scales of each block of d_in / nb
    input rows: ``w_s`` (nb, d_out), or nf4-dq's absmax plane ``s_q * s_s
    + s_m`` (quantize.py:_leaf_scales)."""
    s = w_s if w_s is not None else s_q.float() * s_s + s_m
    nb, d_out = s.shape
    if w_q.dtype == torch.uint8:
        codes = torch.stack([w_q & 0xF, w_q >> 4], dim=1).reshape(2 * w_q.shape[0], d_out)
        w = _nf4_levels(str(w_q.device))[codes.long()]
    else:
        w = w_q.float()
    d_in = w.shape[0]
    w = w.reshape(nb, d_in // nb, d_out) * s[:, None, :]
    return w.reshape(d_in, d_out).to(dtype)


# per-row LoRA factors of an adapter bank (models/lora.py select_adapters):
# {Dense: (a (B, d_in, r), b (B, r, d_out))}, set by ``row_adapters`` for
# the thread that runs the forward, so a model shared by several serving
# threads carries each one's factors apart
_ROW_LORA = contextvars.ContextVar("row_lora", default=None)


@contextlib.contextmanager
def row_adapters(factors: dict):
    """Apply ``factors`` ({Dense: (a, b)}) in every forward this thread
    runs inside the block; they take the place of factors attached by
    ``merge_lora``.  A row-split part of a tensor-parallel layer holds
    (a, None) and its layer (a ``TPAttention`` / ``TPMLP``) holds (None,
    b): see :class:`_RowParallel`."""
    tok = _ROW_LORA.set(factors)
    try:
        yield
    finally:
        _ROW_LORA.reset(tok)


# the rank-r products x @ A of the row-split parts of a tensor-parallel
# layer under an adapter bank, {Dense: xa}, collected by that layer
_ROW_XA = contextvars.ContextVar("row_xa", default=None)


_QUANT_KEYS = ("w_q", "w_s", "s_q", "s_s", "s_m")


class Dense(nn.Module):
    """``x @ w (+ b)``.  A quantized layer (models/quantize.py) holds codes
    ``w_q`` in place of ``w`` -- int8 (d_in, d_out), or two nf4 codes a
    byte, uint8 (d_in / 2, d_out) -- and the f32 scales ``w_s`` (nb,
    d_out), or for nf4-dq their int8 codes ``s_q`` (nb, d_out) with one f32
    offset ``s_m`` and step ``s_s`` (nb, 1) a block row; all are buffers,
    frozen under autograd, and dequantized at the point of use, except
    that int8c (one scale row) runs kernel K6 at the row counts it takes.

    LoRA (models/lora.py ``merge_lora``): on a quantized layer the factors
    ``lora_a`` (d_in, r) and ``lora_b`` (r, d_out, carrying alpha/r) apply
    lazily, ``y += (x @ A) @ B`` in bf16 with f32 accumulation; on a float
    layer ``w_merged`` = W + scale * A @ B stands in for ``w``.  An adapter
    bank's per-row factors (a (B, d_in, r), b (B, r, d_out); set by
    :func:`row_adapters`) apply lazily on either base, each batch row its
    own.  ``w_dequant`` (quantize.py ``dequantize_tree``, the trainer's
    "once" placements) is a float weight that stands in for the codes;
    with ``lora_folded`` it holds the attached factors too, which then do
    not apply again.  These are plain attributes, set per forward by
    their callers."""

    def __init__(self, d_in: int, d_out: int, *, use_bias: bool = True, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, device=device))
        for key in _QUANT_KEYS:
            self.register_buffer(key, None)
        self.b = nn.Parameter(torch.empty(d_out, device=device)) if use_bias else None
        self.lora_a = self.lora_b = self.w_merged = self.w_dequant = None
        self.lora_folded = False

    def set_quantized(self, w_q: torch.Tensor, w_s: torch.Tensor | None = None, *, s_q=None, s_s=None,
                      s_m=None) -> None:
        """Replace the float weight by codes and their scales."""
        self.w = None
        self.w_q, self.w_s, self.s_q, self.s_s, self.s_m = w_q, w_s, s_q, s_s, s_m

    @property
    def shape(self) -> tuple[int, int]:
        """(d_in, d_out), whatever the leaf's storage (quantize.py:dense_shape)."""
        if self.w_q is None:
            return tuple(self.w.shape)
        if self.w_q.dtype == torch.uint8:
            return 2 * self.w_q.shape[0], self.w_q.shape[1]
        return tuple(self.w_q.shape)

    def dequantized(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The weight of a quantized layer, reconstructed in ``dtype``."""
        return dequantize_weight(self.w_q, self.w_s, dtype, s_q=self.s_q, s_s=self.s_s, s_m=self.s_m)

    def forward(self, x):
        if self.w_dequant is not None:
            y = _matmul(x, self.w_dequant)
        elif self.w_q is None:
            y = _matmul(x, self.w if self.w_merged is None else self.w_merged)
        else:
            d_in, d_out = self.shape
            rows = x.numel() // d_in
            if (self.w_q.dtype == torch.int8 and self.w_s is not None and self.w_s.shape[0] == 1
                    and w8_supports(rows, d_in, d_out)):
                # int8c at decode row counts: kernel K6 streams the int8
                # weight and folds the column scale after the K sum
                y = w8_matmul(x.reshape(rows, d_in).to(COMPUTE_DTYPE), self.w_q, self.w_s,
                              out_dtype=torch.float32)
                y = y.reshape(*x.shape[:-1], d_out)
            else:
                # dequantize at the point of use: a transient bf16 weight
                y = _matmul(x, self.dequantized(COMPUTE_DTYPE))
        if self.b is not None:
            y = y + self.b
        lora_a, lora_b = (None, None) if self.lora_folded else (self.lora_a, self.lora_b)
        rows = _ROW_LORA.get()
        if rows is not None and self in rows:
            lora_a, lora_b = rows[self]
        if lora_a is not None:
            per_row = lora_a.dim() == 3
            if per_row:
                # per-row factors: one rank-r correction a batch row, as
                # f32 products of bf16-rounded inputs (layers.py:161-177)
                xa = torch.bmm(_bf16(x).reshape(x.shape[0], -1, x.shape[-1]), _bf16(lora_a))
            else:
                xa = _matmul(x, lora_a)
            if lora_b is None or (getattr(self, "tp_rows", None) is not None and _ROW_XA.get() is not None):
                # a row-split part: its layer sums the parts' x @ A first
                _ROW_XA.get()[self] = xa
            else:
                y = y + _lora_out(xa, lora_b, per_row, x.shape)
        return _maybe_tag_proj(y)


def _lora_out(xa, lora_b, per_row: bool, shape):
    """The correction ``bf16(xa) @ bf16(B)`` of an input of ``shape``."""
    if per_row:
        return torch.bmm(_bf16(xa), _bf16(lora_b)).reshape(*shape[:-1], -1)
    return _matmul(xa, lora_b)


class LayerNorm(nn.Module):
    """f32 layer norm; without a bias it is RMSNorm (llama family), as the
    JAX package selects the norm by the param dict's shape.  ``out_dtype``
    optionally rounds the result."""

    def __init__(self, d: int, eps: float, *, bias: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(d, device=device))
        self.bias = nn.Parameter(torch.empty(d, device=device)) if bias else None

    def forward(self, x, out_dtype=None):
        x = x.float()
        if self.bias is None:
            out = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps) * self.scale
        else:
            mu = x.mean(dim=-1, keepdim=True)
            var = (x - mu).square().mean(dim=-1, keepdim=True)
            out = (x - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return out if out_dtype is None else out.to(out_dtype)


# ---------------------------------------------------------------- positions


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0, device=None):
    """(max_len, head_dim/2) f32 cos/sin tables."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, positions):
    """x (B, T, H, Dh), positions (B, T): rotates the first ``2 *
    cos.shape[-1]`` features (partial rotary); the rest pass through."""
    rot = 2 * cos.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    cos_t = cos[positions][:, :, None, :]
    sin_t = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos_t - x2 * sin_t, x2 * cos_t + x1 * sin_t], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def alibi_slopes(n_heads: int, mode: str = "bloom", bias_max: float = 8.0, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (f32).  ``"bloom"``: HF ``build_alibi_tensor``
    (closest lower power of two, extended by odd terms); ``"mpt"``: HF
    ``build_mpt_alibi_tensor`` (next higher power of two, odd-index terms
    ahead of the even ones, truncated).  Computed on the host and copied
    without waiting for the device: a decode step builds them every call."""
    if mode == "mpt":
        n2 = 2 ** math.ceil(math.log2(n_heads))
        slopes = [2.0 ** (-bias_max * i / n2) for i in range(1, n2 + 1)]
        if n2 != n_heads:
            slopes = (slopes[1::2] + slopes[0::2])[:n_heads]
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
        slopes = [base ** i for i in range(1, closest + 1)]
        if closest != n_heads:
            extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
            slopes += [extra_base ** i for i in range(1, 2 * (n_heads - closest) + 1, 2)]
    host = torch.tensor(slopes, dtype=torch.float32)
    return host if device is None else host.to(device, non_blocking=True)


def alibi_bias(n_heads: int, n_keys: int, mode: str = "bloom", bias_max: float = 8.0, device=None):
    """(1, H, 1, K) key-only score bias ``slope_h * key_position``: the
    relative form differs by a per-query constant, which softmax ignores."""
    slopes = alibi_slopes(n_heads, mode, bias_max, device)
    k = torch.arange(n_keys, dtype=torch.float32, device=device)
    return slopes[None, :, None, None] * k[None, None, None, :]


# ---------------------------------------------------------- KV quantization

# absmax scales below this are clamped (all-zero K/V rows: pad columns, a
# fresh cache), so no code divides by zero (layers.py:316)
KV_SCALE_EPS = 1e-8


def kv_quantize(x):
    """Per-(token, head) symmetric int8 quantization of a K/V slab
    (layers.py:319): ``x`` (..., T, H, D) -> (codes int8, scales f32
    (..., T, H, 1)) with ``codes * scales ~ x``.  ``absmax / 127`` is a
    true division on every device (``div127``) and the codes round half to
    even, as the JAX function does; the scales keep a trailing singleton,
    so every cache leaf has its token axis at -3."""
    x = x.float()
    s = div127(x.abs().amax(dim=-1, keepdim=True)).clamp_min(KV_SCALE_EPS)
    return torch.round(x / s).to(torch.int8), s


def kv_dequantize(codes, scales, dtype=torch.float32):
    """Inverse of :func:`kv_quantize` (exact given the stored scales)."""
    return (codes.float() * scales).to(dtype)


# ---------------------------------------------------------------- attention


class Attention(nn.Module):
    """``qkv_bias`` / ``o_bias``: the JAX ``use_bias`` True (both), False
    (neither) or "qkv" (q/k/v only).  ``kv_dim`` < ``q_dim`` is grouped-query
    attention; ``q_dim`` (default d_model) is heads x head_dim where the
    head dim is decoupled from d_model (Gemma's ``d_kv``)."""

    def __init__(self, d_model: int, *, q_dim: int | None = None, kv_dim: int | None = None, qkv_bias: bool = True,
                 o_bias: bool = True, device=None):
        super().__init__()
        q_dim = q_dim or d_model
        kv_dim = kv_dim or q_dim
        self.wq = Dense(d_model, q_dim, use_bias=qkv_bias, device=device)
        self.wk = Dense(d_model, kv_dim, use_bias=qkv_bias, device=device)
        self.wv = Dense(d_model, kv_dim, use_bias=qkv_bias, device=device)
        self.wo = Dense(q_dim, d_model, use_bias=o_bias, device=device)

    def forward(self, x, *, n_heads: int, mask=None, flash=None, bias=None, scale=None, n_kv_heads=None,
                rope=None, positions=None, cache=None, cache_index=None, clip=None, kv_x=None, static_kv=None):
        """``mask`` (B|1, Tq, Tk) bool, True = attend; ``bias`` (1|B, H,
        Tq|1, Tk) added after the scaling; ``flash`` = {"kv_lens", "causal",
        "window"} takes the fused kernels (self-attention without a cache;
        the bias reaches them as (H, Tq|1, Tk)).

        Cross-attention (layers.py:384-445): ``kv_x`` (B, Tk, D) is the
        encoder output the keys and values are projected from, or
        ``static_kv`` {"k", "v"} (B, Tk, H, Dh) holds them precomputed
        (:func:`cross_attention_kv`); keys of ``kv_x`` take positions
        ``arange(Tk)`` under ``rope``.

        ``cache`` {"k", "v"} (B, L, kv heads, Dh) bf16, or int8 codes with
        f32 scales "k_s", "v_s" (B, L, kv heads, 1) (:func:`kv_quantize`),
        is written IN PLACE: at slots ``cache_index + arange(t)`` for a
        scalar ``cache_index``, or at ``cache_index[b] + arange(t)`` for a
        (B,) tensor of per-row cursors (layers.py:455-467).  Attention then
        runs over the first ``mask.shape[-1]`` cache columns.  Per-row
        slots past the buffer's end clamp to its last column, so a buffer
        one column wider than the mask (the decode state's guard column)
        takes the writes that JAX drops as out of bounds, and no query
        ever attends them.  An int8 cache is never dequantized: the
        products run on its codes and the scales fold into the logits and
        the probabilities (layers.py:486-494, :537-547).  On the card a
        bf16 cache with a ``mask`` goes to kernel K9 (ops/decode_attention.py
        ``supports``: at most 16 query positions), which reads it in place;
        every other call runs :func:`masked_attention`."""
        b, t, _ = x.shape
        kv_h = n_kv_heads or n_heads
        cross = kv_x is not None or static_kv is not None

        def proj(dense, src, heads):
            y = dense(src)
            if clip is not None:
                y = y.clamp(-clip, clip)
            return y.reshape(b, src.shape[1], heads, -1)

        q = proj(self.wq, x, n_heads)
        if static_kv is not None:
            k, v = static_kv["k"], static_kv["v"]
        else:
            src = x if kv_x is None else kv_x
            k, v = proj(self.wk, src, kv_h), proj(self.wv, src, kv_h)
        if rope is not None:
            cos, sin = rope
            q = apply_rope(q, cos, sin, positions)
            kpos = positions if not cross else torch.arange(k.shape[1], device=x.device)[None, :].expand(b, -1)
            k = apply_rope(k, cos, sin, kpos)
        k_fold = v_fold = None
        if cache is not None:
            quant = "k_s" in cache
            if quant:
                (k_w, k_s), (v_w, v_s) = kv_quantize(k), kv_quantize(v)
                new = {"k": k_w, "v": v_w, "k_s": k_s, "v_s": v_s}
            else:
                new = {"k": k, "v": v}
            if isinstance(cache_index, torch.Tensor):
                width = cache["k"].shape[1]
                rows = torch.arange(b, device=x.device)[:, None]
                slots = (cache_index[:, None] + torch.arange(t, device=x.device)).clamp_max(width - 1)
                for name, val in new.items():
                    cache[name][rows, slots] = val.to(cache[name].dtype)
            else:
                for name, val in new.items():
                    cache[name][:, cache_index: cache_index + t] = val.to(cache[name].dtype)
            n_keys = cache["k"].shape[1] if mask is None else mask.shape[-1]
            if not quant and not cross and mask is not None and decode_attn_supports(q, cache["k"], cache["v"]):
                # K9 reads the bf16 cache in place: no f32 copy of it, no repeat of grouped heads
                out = decode_attention(q, cache["k"], cache["v"], mask, bias, scale=scale)
                return self.wo(out.reshape(b, t, -1))
            if q.is_cuda:
                tracing.count(CACHED_EINSUM)
            k, v = cache["k"][:, :n_keys], cache["v"][:, :n_keys]
            if quant:
                k_fold, v_fold = cache["k_s"][:, :n_keys], cache["v_s"][:, :n_keys]
        if kv_h != n_heads:
            # repeat after the cache write: query head h reads kv head h // rep
            rep = n_heads // kv_h
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
            if k_fold is not None:
                k_fold = k_fold.repeat_interleave(rep, dim=2)
                v_fold = v_fold.repeat_interleave(rep, dim=2)
        if flash is not None and cache is None and not cross:
            out = flash_attention(
                q, k, v, kv_lens=flash.get("kv_lens"), causal=flash.get("causal", True),
                scale=scale, bias=None if bias is None else bias[0], window=flash.get("window"),
            )
            return self.wo(out.reshape(b, t, -1))
        out = masked_attention(q, k, v, mask=mask, bias=bias, scale=scale, k_fold=k_fold, v_fold=v_fold)
        return self.wo(out.reshape(b, t, -1))

    def cross_kv(self, enc_out, n_heads: int) -> dict:
        """This cross-attention's K/V of ``enc_out`` (:func:`cross_attention_kv`)."""
        return cross_attention_kv(self, enc_out, n_heads)


def masked_attention(q, k, v, *, mask=None, bias=None, scale=None, k_fold=None, v_fold=None):
    """The einsum path of :class:`Attention` (layers.py:528-553): q (B, Tq,
    H, D) over k, v (B, Tk, H, D), products of bf16-rounded inputs summed
    in f32, ``scale`` (default D^-0.5) then ``bias`` (1|B, H, Tq|1, Tk),
    masked keys at NEG_INF, an f32 softmax, probabilities rounded to bf16;
    an int8 cache's per-(token, head) scales ``k_fold``, ``v_fold`` (B, Tk,
    H, 1) fold into the logits and the probabilities.  (B, Tq, H, D) f32."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", _bf16(q), _bf16(k)) * scale
    if k_fold is not None:
        logits = logits * k_fold[..., 0].transpose(1, 2)[:, :, None, :]
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = torch.where(mask[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_fold is not None:
        probs = probs * v_fold[..., 0].transpose(1, 2)[:, :, None, :]
    return torch.einsum("bhqk,bkhd->bqhd", _bf16(probs), _bf16(v))


def cross_attention_kv(attn: Attention, enc_out, n_heads: int) -> dict:
    """The head-split cross-attention K/V of ``enc_out`` (B, Tk, D), f32
    {"k", "v"} (B, Tk, H, Dh): projected once a sequence and passed as
    ``Attention(static_kv=...)`` at every decoder step (layers.py:371)."""
    b, tk, _ = enc_out.shape
    return {"k": attn.wk(enc_out).reshape(b, tk, n_heads, -1), "v": attn.wv(enc_out).reshape(b, tk, n_heads, -1)}


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, gated: bool = False, use_bias: bool = True, device=None):
        super().__init__()
        self.wi = Dense(d_model, d_ff, use_bias=use_bias, device=device)
        self.wo = Dense(d_ff, d_model, use_bias=use_bias, device=device)
        self.wg = Dense(d_model, d_ff, use_bias=use_bias, device=device) if gated else None

    def forward(self, x, activation: str = "gelu"):
        if self.wg is not None:
            # gated: silu (SwiGLU) unless the config asks for the tanh-GELU
            # gate ("gelu_new", GeGLU)
            g = self.wg(x)
            a = F.gelu(g, approximate="tanh") if activation == "gelu_new" else F.silu(g)
            return self.wo(a * self.wi(x))
        # "gelu" = exact (erf); "gelu_new" = tanh approximation
        approx = "tanh" if activation == "gelu_new" else "none"
        return self.wo(F.gelu(self.wi(x), approximate=approx))


class Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, eps: float, *, n_kv_heads: int | None = None,
                 norm: str = "layernorm", gated_mlp: bool = False, use_bias: bool | str = True,
                 head_dim: int | None = None, cross: bool = False, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        rms = norm == "rmsnorm"
        head_dim = head_dim or d_model // n_heads
        kv_dim = None if n_kv_heads is None else head_dim * n_kv_heads
        self.ln1 = LayerNorm(d_model, eps, bias=not rms, device=device)
        self.attn = Attention(d_model, q_dim=head_dim * n_heads, kv_dim=kv_dim, qkv_bias=use_bias in (True, "qkv"),
                              o_bias=use_bias is True, device=device)
        self.ln2 = LayerNorm(d_model, eps, bias=not rms, device=device)
        self.mlp = MLP(d_model, d_ff, gated=gated_mlp, use_bias=use_bias is True, device=device)
        if cross:
            # the encoder-decoder's cross-attention (layers.py:600-706): a
            # biased d_model attention of the stack's own norm kind
            self.ln_cross = LayerNorm(d_model, eps, bias=not rms, device=device)
            self.cross_attn = Attention(d_model, device=device)

    def forward(self, x, *, mask=None, flash=None, norm_position: str = "pre", bias=None, scale=None,
                activation: str = "gelu", activation_dtype=None, parallel_residual: bool = False, rope=None,
                positions=None, cache=None, cache_index=None, clip=None, enc_out=None, enc_mask=None,
                cross_kv=None):
        """``activation_dtype`` (bf16) keeps the residual stream and norm
        outputs in that dtype; None keeps f32 activations.  A ``cross``
        block attends ``enc_out`` (or its precomputed ``cross_kv``) under
        ``enc_mask`` (B, Tq, Tk) after its self-attention."""
        adt = activation_dtype

        def cast(h):
            return h if adt is None else h.to(adt)

        attn_kw = dict(n_heads=self.n_heads, mask=mask, flash=flash, bias=bias, scale=scale,
                       n_kv_heads=self.n_kv_heads, rope=rope, positions=positions, cache=cache,
                       cache_index=cache_index, clip=clip)
        if norm_position == "post":
            # BERT layout: LN after each residual add
            x = self.ln1(x + cast(self.attn(x, **attn_kw)), out_dtype=adt)
            return self.ln2(x + cast(self.mlp(x, activation)), out_dtype=adt)
        h = self.attn(self.ln1(x, out_dtype=adt), **attn_kw)
        if parallel_residual:
            # GPT-NeoX: x + attn(ln1(x)) + mlp(ln2(x))
            m = self.mlp(self.ln2(x, out_dtype=adt), activation)
            return x + cast(h) + cast(m)
        x = x + cast(h)
        if enc_out is not None or cross_kv is not None:
            h = self.cross_attn(self.ln_cross(x, out_dtype=adt), n_heads=self.n_heads, mask=enc_mask, kv_x=enc_out,
                                static_kv=cross_kv)
            x = x + cast(h)
        return x + cast(self.mlp(self.ln2(x, out_dtype=adt), activation))


# -------------------------------------------------------------------- masks


def causal_mask(t: int, device=None) -> torch.Tensor:
    """(1, T, T) boolean lower-triangular mask."""
    return torch.tril(torch.ones((1, t, t), dtype=torch.bool, device=device))


def padding_mask(attn_mask: torch.Tensor) -> torch.Tensor:
    """attn_mask (B, T) {0,1} -> (B, 1, T) key-side mask."""
    return attn_mask[:, None, :].bool()


# ------------------------------------------------------- tensor parallelism
#
# The tensor-parallel forms over the mesh's ``model`` axis (one controller
# drives every device; parallel/sharding.py decides what splits).  Each
# device holds a plain ``Attention`` / ``MLP`` over its share; the
# column-parallel projections (wq / wk / wv, wi / wg) keep their outputs
# on their devices, and the row-parallel ones (both wo) leave partial
# products that ``all_reduce_sum`` adds in f32 on the lead device, where
# the bias is added once.  Every product rounds its inputs to bf16 as the
# unsharded layer does; only the order of the f32 additions of a
# row-parallel sum differs.


def split_dense(dense: Dense, device, *, cols: slice | None = None, rows: slice | None = None,
                bias: bool = True) -> Dense:
    """A Dense over ``dense``'s columns ``cols`` (column-parallel: its bias
    slice too) or rows ``rows`` (row-parallel: no bias, the sum adds it),
    copied to ``device``.  Float weights (a LoRA merge included) or
    quantized codes (quantize.py:78-173): the scales follow the codes'
    columns, and a row part takes the scale rows of the blocks it spans (or
    of the one block it lies in), as the sharding rules split ``w_s`` and
    ``s_q`` like ``w``.  nf4 codes pack two rows a byte, so a row part takes
    the packed rows ``lo/2 : hi/2`` and may not cut a byte; nf4-dq's
    per-block-row ``s_s`` and ``s_m`` (nb, 1) stay whole in a column part
    and follow the scale rows in a row part.  The part's ``tp_index`` maps
    each of its leaves to the index of the whole leaf it holds, and
    ``tp_whole`` is the whole layer's (d_in, d_out)."""
    if dense.w_dequant is not None or dense.lora_a is not None:
        raise ValueError("tensor parallelism splits the base; attach LoRA factors to the parts")
    quant = dense.w_q is not None
    if quant:
        leaves = {k: getattr(dense, k) for k in _QUANT_KEYS if getattr(dense, k) is not None}
    else:
        leaves = {"w": dense.w if dense.w_merged is None else dense.w_merged}
    b = dense.b if bias and rows is None else None
    d_in, d_out = dense.shape
    packed = 2 if quant and dense.w_q.dtype == torch.uint8 else 1  # rows of d_in a row of w_q
    index = {name: (slice(0, t.shape[0]), slice(0, t.shape[1])) for name, t in leaves.items()}
    per_block_row = {"s_s", "s_m"}  # (nb, 1): every column of a block row
    if cols is not None:
        index = {name: ix if name in per_block_row else (ix[0], cols) for name, ix in index.items()}
        b_index = cols
    if rows is not None:
        lo, hi = rows.start, rows.stop
        if lo % packed or hi % packed:
            raise ValueError(f"rows {lo}:{hi} cut a byte of packed nf4 codes (two rows a byte)")
        index["w_q" if quant else "w"] = (slice(lo // packed, hi // packed), slice(0, d_out))
        if quant:
            nb = (dense.w_s if dense.w_s is not None else dense.s_q).shape[0]
            size = d_in // nb  # rows a scale block
            if lo % size == 0 and hi % size == 0:
                blocks = slice(lo // size, hi // size)
            elif lo // size == (hi - 1) // size:
                blocks = slice(lo // size, lo // size + 1)
            else:
                raise ValueError(f"rows {lo}:{hi} straddle quantization scale blocks of {size} rows")
            for name in leaves:
                if name != "w_q":
                    index[name] = (blocks, index[name][1])
    parts = {name: leaves[name][index[name]] for name in leaves}
    if b is not None and cols is not None:
        b = b[cols]
    shape = ((parts["w_q"].shape[0] * packed, parts["w_q"].shape[1]) if quant else parts["w"].shape)
    part = Dense(*shape, use_bias=b is not None, device="meta")
    if quant:
        own = {name: owned_copy(t, device) for name, t in parts.items()}
        part.set_quantized(own.pop("w_q"), own.pop("w_s", None), **own)
    else:
        part.w = nn.Parameter(owned_copy(parts["w"], device), requires_grad=False)
    if b is not None:
        part.b = nn.Parameter(owned_copy(b, device), requires_grad=False)
        index["b"] = (b_index if cols is not None else slice(0, d_out),)
    part.tp_index = index
    part.tp_cols, part.tp_rows, part.tp_whole = cols, rows, (d_in, d_out)
    return part


def owned_copy(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` with storage of its own:
    a part never keeps its source weight alive, even on the source's
    device, where ``.to()`` of a slice would return a view."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t.detach())


def clone_module(module: nn.Module, device) -> nn.Module:
    """A copy of ``module``'s structure on ``device`` whose parameters and
    buffers are ``t.to(device)``: the same tensors where they already live
    there (a repeated-device mesh keeps one copy of a frozen weight), copies
    elsewhere."""
    memo = {}
    for t in [*module.parameters(), *module.buffers()]:
        moved = t.to(device)
        if isinstance(t, nn.Parameter) and not isinstance(moved, nn.Parameter):
            moved = nn.Parameter(moved, requires_grad=t.requires_grad)
        memo[id(t)] = moved
    return copy.deepcopy(module, memo)


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def head_groups(n_heads: int, kv_heads: int, n: int) -> list[tuple[int, int, int, int]] | None:
    """Device j's query heads [q0, q1) and the kv heads [k0, k1) they read,
    for a head split over ``n`` devices; None where the heads do not
    split: ``n`` must divide the query heads, and a device's query heads
    must cover whole kv groups or sit inside one (with more devices than kv
    heads, each device keeps a copy of the kv head its queries read)."""
    if n_heads % n:
        return None
    hq, rep = n_heads // n, n_heads // kv_heads
    if hq % rep and rep % hq:
        return None
    return [(j * hq, (j + 1) * hq, j * hq // rep, ((j + 1) * hq - 1) // rep + 1) for j in range(n)]


class _RowParallel(nn.Module):
    """A tensor-parallel layer whose parts end in a row-parallel ``wo``:
    their partial products are summed in f32 on the lead device, where
    wo's bias is added once.  Under an adapter bank (``models/lora.py``
    ``place_bank``) each part's ``wo`` holds its rows of A and this layer
    holds B: the parts' f32 products x @ A are summed before the bf16
    rounding the unsharded layer applies to x @ A, then multiplied by B on
    the lead, so the correction differs from the unsharded one only in the
    order of f32 additions.  A trainer's lazy factors (a quantized base:
    each part's ``wo`` holds A's rows and the whole B, ``lora.
    attach_factors``) are summed the same way, with part 0's copy of B."""

    parts: nn.ModuleList
    lead: torch.device
    wo_b: nn.Parameter | None

    def _sum(self, run):
        factors = _ROW_LORA.get()
        bank = factors is not None and self in factors
        lazy = not bank and self.parts[0].wo.lora_a is not None and not self.parts[0].wo.lora_folded
        tok = _ROW_XA.set({}) if bank or lazy else None
        try:
            outs = run()
            xas = _ROW_XA.get()
        finally:
            if tok is not None:
                _ROW_XA.reset(tok)
        y = all_reduce_sum(outs, self.lead)
        if self.wo_b is not None:
            y = y + self.wo_b
        if bank or lazy:
            xa = all_reduce_sum([xas[part.wo] for part in self.parts], self.lead)
            b = factors[self][1] if bank else self.parts[0].wo.lora_b.to(self.lead)
            y = y + _lora_out(xa, b, b.dim() == 3, y.shape)
        return y


class TPAttention(_RowParallel):
    """Head-parallel attention: device j holds the query heads
    ``groups[j][0:2]``, the kv heads they read, their KV cache (a layer's
    ``cache`` is the list of the devices' dicts) and their share of wo's
    rows.  A score bias (ALiBi, T5's relative bias) arrives for all heads
    and is sliced by head offset, never recomputed for the share.  As
    cross-attention, each device projects the encoder output ``kv_x`` onto
    its own heads, or reads their precomputed K/V: ``static_kv`` is the
    list of the devices' dicts (:meth:`cross_kv`)."""

    def __init__(self, attn: Attention, groups, head_dim: int, devices, lead):
        super().__init__()
        self.groups, self.devices, self.lead = groups, list(devices), lead
        self.parts = nn.ModuleList()
        for (q0, q1, k0, k1), dev in zip(groups, devices):
            part = Attention.__new__(Attention)
            nn.Module.__init__(part)
            part.wq = split_dense(attn.wq, dev, cols=slice(q0 * head_dim, q1 * head_dim))
            part.wk = split_dense(attn.wk, dev, cols=slice(k0 * head_dim, k1 * head_dim))
            part.wv = split_dense(attn.wv, dev, cols=slice(k0 * head_dim, k1 * head_dim))
            part.wo = split_dense(attn.wo, dev, rows=slice(q0 * head_dim, q1 * head_dim))
            self.parts.append(part)
        self.wo_b = None if attn.wo.b is None else nn.Parameter(attn.wo.b.detach().to(lead), requires_grad=False)

    def forward(self, x, *, n_heads: int, mask=None, flash=None, bias=None, scale=None, n_kv_heads=None, rope=None,
                positions=None, cache=None, cache_index=None, clip=None, kv_x=None, static_kv=None):
        def run():
            return [part(x.to(dev), n_heads=q1 - q0, n_kv_heads=k1 - k0, mask=_to(mask, dev),
                         flash=None if flash is None else {key: _to(v, dev) for key, v in flash.items()},
                         bias=None if bias is None else bias[:, q0:q1].to(dev), scale=scale,
                         rope=None if rope is None else tuple(r.to(dev) for r in rope), positions=_to(positions, dev),
                         cache=None if cache is None else cache[j], cache_index=_to(cache_index, dev), clip=clip,
                         kv_x=_to(kv_x, dev), static_kv=None if static_kv is None else static_kv[j])
                    for j, ((q0, q1, k0, k1), part, dev) in enumerate(zip(self.groups, self.parts, self.devices))]

        return self._sum(run)

    def cross_kv(self, enc_out, n_heads: int | None = None) -> list[dict]:
        """Each device's cross-attention K/V of ``enc_out`` over its own
        heads, on its device (:func:`cross_attention_kv` a part; the head
        counts are the parts')."""
        return [cross_attention_kv(part, enc_out.to(dev), q1 - q0)
                for (q0, q1, _, _), part, dev in zip(self.groups, self.parts, self.devices)]


class TPMLP(_RowParallel):
    """The MLP with its hidden split over the devices: wi / wg
    column-parallel, wo row-parallel (summed on the lead device).  Each
    part is of the source's class, so a family's own feed-forward
    (``models/t5.py`` ``T5FFN``) keeps its activation."""

    def __init__(self, mlp: MLP, devices, lead):
        super().__init__()
        self.devices, self.lead = list(devices), lead
        d_ff = mlp.wi.shape[1]
        step = d_ff // len(self.devices)
        self.parts = nn.ModuleList()
        for j, dev in enumerate(self.devices):
            cols = slice(j * step, (j + 1) * step)
            part = mlp.__class__.__new__(mlp.__class__)
            nn.Module.__init__(part)
            part.wi = split_dense(mlp.wi, dev, cols=cols)
            part.wg = None if mlp.wg is None else split_dense(mlp.wg, dev, cols=cols)
            part.wo = split_dense(mlp.wo, dev, rows=cols)
            self.parts.append(part)
        self.wo_b = None if mlp.wo.b is None else nn.Parameter(mlp.wo.b.detach().to(lead), requires_grad=False)

    def forward(self, x, activation: str = "gelu"):
        return self._sum(lambda: [part(x.to(dev), activation) for part, dev in zip(self.parts, self.devices)])


def tp_block(blk: nn.Module, groups, head_dim: int, devices, lead, *, split_mlp: bool) -> nn.Module:
    """A layer of a tensor-parallel reader, of ``blk``'s class (a ``Block``
    or a family's block, whose forward it keeps): its self- and
    cross-attention head-parallel where ``groups`` split the heads, its
    MLP hidden split with ``split_mlp``, every other module (the norms)
    replicated on the lead device."""
    tp = blk.__class__.__new__(blk.__class__)
    nn.Module.__init__(tp)
    for key, val in vars(blk).items():
        if not key.startswith("_") and key != "training":
            setattr(tp, key, val)  # plain settings: a Block's head counts
    for name, child in blk.named_children():
        if name in ("attn", "cross_attn") and groups:
            child = TPAttention(child, groups, head_dim, devices, lead)
        elif name == "mlp" and split_mlp:
            child = TPMLP(child, devices, lead)
        else:
            child = clone_module(child, lead)
        setattr(tp, name, child)
    return tp


# a leaf of a split part: (layer.sublayer).parts.(position).(dense).(leaf)
_PART_LEAF = re.compile(r"((?:blocks|enc_blocks|dec_blocks)\.\d+\.(?:attn|cross_attn|mlp))\.parts\.(\d+)\.(\w+)\.(\w+)")


class SplitVocab:
    """The vocabulary of a tensor-parallel reader (mixed into
    ``causal_lm.TPCausalLM`` and ``families.TPEncoderDecoder``, which set
    ``devices`` and ``lead``): the embedding table split by vocabulary
    rows where the vocabulary divides (``embed_parts``: a device looks up
    the ids in its range and the parts sum on the lead device, one
    non-zero addend, exact), else whole on the lead (``tok_embed``); the
    classifier -- the table's transpose when tied, else ``lm_head``, split
    by columns (``head_parts``) or whole -- computes each device's
    vocabulary slice, gathered on the lead device."""

    devices: list
    lead: torch.device

    def place_vocab(self, model: nn.Module, split_vocab: bool, split_head: bool) -> None:
        n, vocab = len(self.devices), model.cfg.vocab_size
        step = vocab // n
        self.tok_embed = self.embed_parts = None
        if split_vocab:
            self.embed_parts = nn.ParameterList(
                nn.Parameter(owned_copy(model.tok_embed[j * step:(j + 1) * step], dev), requires_grad=False)
                for j, dev in enumerate(self.devices))
        else:
            self.tok_embed = nn.Parameter(model.tok_embed.detach().to(self.lead), requires_grad=False)
        self.lm_head = self.head_parts = None
        head = getattr(model, "lm_head", None)
        if head is not None and split_head:
            self.head_parts = nn.ModuleList(split_dense(head, dev, cols=slice(j * step, (j + 1) * step))
                                            for j, dev in enumerate(self.devices))
        elif head is not None:
            self.lm_head = clone_module(head, self.lead)

    @property
    def device(self) -> torch.device:
        return self.lead

    def embed(self, ids):
        """Token embeddings (B, T, D) on the lead device."""
        if self.embed_parts is None:
            return self.tok_embed[ids.long()]
        parts = []
        lo = 0
        for table, dev in zip(self.embed_parts, self.devices):
            local = ids.to(dev).long() - lo
            hit = (local >= 0) & (local < table.shape[0])
            parts.append(table[local.clamp(0, table.shape[0] - 1)] * hit[..., None])
            lo += table.shape[0]
        return all_reduce_sum(parts, self.lead).to(self.embed_parts[0].dtype)

    def leaf_index(self) -> dict:
        """{name of each tensor of this model: (the name of the unsharded
        model's leaf it holds, the index of that leaf it holds, its model
        position)}: ``blocks.0.attn.parts.1.wq.w`` (or ``enc_blocks`` /
        ``dec_blocks``, ``cross_attn``, ``mlp``) holds columns of
        ``blocks.0.attn.wq.w`` at position 1 (each leaf of a quantized
        part by its ``tp_index``), ``embed_parts.2`` rows of ``tok_embed``,
        ``head_parts.2`` columns of ``lm_head``; replicated leaves (norms,
        position and relative-bias tables, a logits bias, a row-parallel
        layer's ``wo_b``) hold the whole at position 0."""
        out = {}
        mods = dict(self.named_modules())
        for name, t in self.state_dict(keep_vars=True).items():
            whole = tuple(slice(0, d) for d in t.shape)
            m = _PART_LEAF.fullmatch(name)
            if m:
                part = mods[name.rsplit(".", 1)[0]]
                out[name] = (f"{m.group(1)}.{m.group(3)}.{m.group(4)}", part.tp_index[m.group(4)], int(m.group(2)))
                continue
            m = re.fullmatch(r"head_parts\.(\d+)\.(\w+)", name)
            if m:
                part = mods[name.rsplit(".", 1)[0]]
                out[name] = (f"lm_head.{m.group(2)}", part.tp_index[m.group(2)], int(m.group(1)))
                continue
            m = re.fullmatch(r"embed_parts\.(\d+)", name)
            if m:
                j, rows = int(m.group(1)), t.shape[0]
                out[name] = ("tok_embed", (slice(j * rows, (j + 1) * rows), whole[1]), j)
                continue
            out[name] = (re.sub(r"\.wo_b$", ".wo.b", name), whole, 0)
        return out

    def classifier_parts(self) -> list:
        """Each device's (D, V / n) vocabulary slice of the classifier where
        it splits (the chunked loss streams every slice on its device,
        ops/xent.py), else the whole classifier."""
        if self.head_parts is not None:
            return [p.w for p in self.head_parts]
        if self.lm_head is not None:
            return [self.lm_head.w]
        if self.embed_parts is not None:
            return [t.T for t in self.embed_parts]
        return [self.tok_embed.T]

    def head_weight(self):
        """The whole (D, V) classifier on the lead device (its parts
        gathered; differentiable in them)."""
        return all_gather(self.classifier_parts(), self.lead, dim=1)

    def vocab_logits(self, x):
        """(…, D) -> (…, V) f32 logits of the classifier, on the lead."""
        if self.head_parts is not None:
            return all_gather([p(x.to(dev)) for p, dev in zip(self.head_parts, self.devices)], self.lead, dim=-1)
        if self.embed_parts is None or self.lm_head is not None:
            return _matmul(x, self.classifier_parts()[0])
        return all_gather([_matmul(x.to(dev), t.T) for t, dev in zip(self.embed_parts, self.devices)], self.lead,
                          dim=-1)
