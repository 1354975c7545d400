"""The mpnet-base sentence encoder in plain float32 PyTorch.

MPNet as ``paraphrase-mpnet-base-v2`` publishes it: token and position
embeddings (RoBERTa positions: the i-th real token at ``i + 2``, padding
at 1), an embedding LayerNorm, post-LN blocks of biased attention with a
shared bucketed relative-position bias (32 buckets, distance 128) and an
exact-GELU MLP, then the masked mean over real tokens and an L2 norm.
The bucket arithmetic follows the JAX package's float32 form (a 1e-9
inside the log), which the port keeps.

``mode="fp8"`` is the control: every product's inputs rounded to float8
e4m3 (activations scaled per row, weights per column) before a float32
product.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def relative_bucket(rel: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    n = -rel
    half = num_buckets // 2
    ret = (n < 0).astype(np.int64) * half
    n = np.abs(n)
    max_exact = half // 2
    f32 = np.float32
    scaled = np.log(n.astype(f32) / f32(max_exact) + f32(1e-9)) / np.log(f32(max_distance / max_exact))
    large = np.minimum(max_exact + (scaled * f32(half - max_exact)).astype(np.int32), half - 1)
    return ret + np.where(n < max_exact, n, large)


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = (x.abs().amax(dim=dim, keepdim=True) / FP8_MAX).clamp_min(1e-30)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, mode: str | None) -> torch.Tensor:
    if mode == "fp8":
        x, w = fake_fp8(x, -1), fake_fp8(w, 0)
    y = x @ w
    return y if b is None else y + b


def encode(w: dict, c: dict, ids: torch.Tensor, mask: torch.Tensor, *, mode: str | None = None,
           block: int = 64) -> torch.Tensor:
    """(B, T) ids and mask -> (B, D) unit vectors, ``block`` rows at a time."""
    return torch.cat([_encode(w, c, ids[i: i + block], mask[i: i + block], mode)
                      for i in range(0, ids.shape[0], block)])


def _encode(w: dict, c: dict, ids, mask, mode):
    b, t = ids.shape
    d, h = c["hidden_size"], c["num_attention_heads"]
    hd = d // h
    eps = c["layer_norm_eps"]
    mask = mask.long()
    pos = torch.cumsum(mask, dim=1) * mask + c["pad_token_id"]
    x = w["tok_embed"][ids] + w["pos_embed"][pos]
    x = F.layer_norm(x, (d,), w["emb_ln.scale"], w["emb_ln.bias"], eps)
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    buckets = torch.from_numpy(relative_bucket(rel, c["relative_attention_num_buckets"], 128)).to(ids.device)
    bias = w["rel_bias"][buckets].permute(2, 0, 1)[None]  # (1, H, T, T)
    keymask = mask[:, None, None, :].bool()
    for i in range(c["num_hidden_layers"]):
        p = f"blocks.{i}."

        def heads(y):
            return y.reshape(b, t, h, hd).transpose(1, 2)

        q, k, v = (heads(linear(x, w[p + f"attn.{n}.w"], w[p + f"attn.{n}.b"], mode)) for n in ("wq", "wk", "wv"))
        s = q @ k.transpose(-1, -2) / math.sqrt(hd) + bias
        s = s.masked_fill(~keymask, float("-inf"))
        a = torch.softmax(s, dim=-1) @ v
        a = linear(a.transpose(1, 2).reshape(b, t, d), w[p + "attn.wo.w"], w[p + "attn.wo.b"], mode)
        x = F.layer_norm(x + a, (d,), w[p + "ln1.scale"], w[p + "ln1.bias"], eps)
        m = linear(F.gelu(linear(x, w[p + "mlp.wi.w"], w[p + "mlp.wi.b"], mode)), w[p + "mlp.wo.w"],
                   w[p + "mlp.wo.b"], mode)
        x = F.layer_norm(x + m, (d,), w[p + "ln2.scale"], w[p + "ln2.bias"], eps)
    mf = mask[:, :, None].float()
    pooled = (x * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)
