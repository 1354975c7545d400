"""Transformer building blocks of the sentence encoder, as ``nn.Module``s.

Counterpart of the encoder subset of ``vietnamese_qa_system_tpu/models/
layers.py``: ``Dense`` (no int8 weights, no LoRA), ``LayerNorm``,
``Attention`` (no cache, RoPE or GQA), ``MLP`` (gelu / gelu_new), ``Block``
(pre- and post-LN), ``padding_mask`` and the bf16 activation policy.

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

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention

COMPUTE_DTYPE = torch.bfloat16


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE).float() @ w.to(COMPUTE_DTYPE).float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32."""
    return x.to(COMPUTE_DTYPE).float()


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, use_bias: bool = True, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.b = nn.Parameter(torch.empty(d_out, device=device)) if use_bias else None

    def forward(self, x):
        y = _matmul(x, self.w)
        return y if self.b is None else y + self.b


class LayerNorm(nn.Module):
    """f32 layer norm; ``out_dtype`` optionally rounds the result."""

    def __init__(self, d: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(d, device=device))
        self.bias = nn.Parameter(torch.empty(d, device=device))

    def forward(self, x, out_dtype=None):
        x = x.float()
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        out = (x - mu) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        return out if out_dtype is None else out.to(out_dtype)


class Attention(nn.Module):
    def __init__(self, d_model: int, *, device=None):
        super().__init__()
        self.wq = Dense(d_model, d_model, device=device)
        self.wk = Dense(d_model, d_model, device=device)
        self.wv = Dense(d_model, d_model, device=device)
        self.wo = Dense(d_model, d_model, device=device)

    def forward(self, x, *, n_heads: int, mask=None, flash=None, bias=None, scale=None):
        """``mask`` (B, Tq, Tk) bool, True = attend; ``bias`` (1, H, Tq, Tk);
        ``flash`` = {"kv_lens": (B,), "causal": bool} takes the fused kernel."""
        b, t, d = x.shape

        def heads(y):
            return y.reshape(b, t, n_heads, d // n_heads)

        q, k, v = heads(self.wq(x)), heads(self.wk(x)), heads(self.wv(x))
        if flash is not None:
            out = flash_attention(
                q, k, v, kv_lens=flash.get("kv_lens"), causal=flash.get("causal", True),
                scale=scale, bias=None if bias is None else bias[0],
            )
            return self.wo(out.reshape(b, t, -1))
        if scale is None:
            scale = 1.0 / float(d // n_heads) ** 0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", _bf16(q), _bf16(k)) * scale
        if bias is not None:
            logits = logits + bias
        if mask is not None:
            logits = torch.where(mask[:, None, :, :], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", _bf16(probs), _bf16(v))
        return self.wo(out.reshape(b, t, -1))


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device=None):
        super().__init__()
        self.wi = Dense(d_model, d_ff, device=device)
        self.wo = Dense(d_ff, d_model, device=device)

    def forward(self, x, activation: str = "gelu"):
        # "gelu" = exact (erf); "gelu_new" = tanh approximation
        approx = "tanh" if activation == "gelu_new" else "none"
        return self.wo(F.gelu(self.wi(x), approximate=approx))


class Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, eps: float, *, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.ln1 = LayerNorm(d_model, eps, device=device)
        self.attn = Attention(d_model, device=device)
        self.ln2 = LayerNorm(d_model, eps, device=device)
        self.mlp = MLP(d_model, d_ff, device=device)

    def forward(self, x, *, mask=None, flash=None, norm_position: str = "pre", bias=None,
                scale=None, activation: str = "gelu", activation_dtype=None):
        """``activation_dtype`` (bf16) keeps the residual stream and norm
        outputs in that dtype; None keeps f32 activations."""
        adt = activation_dtype

        def cast(h):
            return h if adt is None else h.to(adt)

        attn_kw = dict(n_heads=self.n_heads, mask=mask, flash=flash, bias=bias, scale=scale)
        if norm_position == "post":
            # BERT layout: LN after each residual add
            x = self.ln1(x + cast(self.attn(x, **attn_kw)), out_dtype=adt)
            return self.ln2(x + cast(self.mlp(x, activation)), out_dtype=adt)
        x = x + cast(self.attn(self.ln1(x, out_dtype=adt), **attn_kw))
        return x + cast(self.mlp(self.ln2(x, out_dtype=adt), activation))


def padding_mask(attn_mask: torch.Tensor) -> torch.Tensor:
    """attn_mask (B, T) {0,1} -> (B, 1, T) key-side mask."""
    return attn_mask[:, None, :].bool()
