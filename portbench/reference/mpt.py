"""The MPT (PhoGPT-4B) forward pass in plain float32 PyTorch.

MPT as ``vinai/PhoGPT-4B`` publishes it: token embeddings tied to the
head, pre-LN blocks without biases, multi-head causal attention with ALiBi
(MPT's slopes: those of the next power of two of the head count, odd
ones first), an exact-GELU MLP of expansion 4, a final LayerNorm.  Whole
sequences, teacher-forced: no cache.

The dense weights are used as a deployment quantizes them, worked out
again here from the float weights: ``int8c`` is one absmax scale per
output column (``absmax / 127``, codes rounded half to even and clipped to
+-127); ``int4c``, the control, the same at +-7.  Layer by layer, so that
one float layer at a time is held.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DENSE = ("attn.wq.w", "attn.wk.w", "attn.wv.w", "attn.wo.w", "mlp.wi.w", "mlp.wo.w")
LEVELS = {"int8c": 127.0, "int4c": 7.0}


def alibi_slopes(n_heads: int, bias_max: float = 8.0) -> torch.Tensor:
    n2 = 2 ** math.ceil(math.log2(n_heads))
    s = [2.0 ** (-bias_max * i / n2) for i in range(1, n2 + 1)]
    if n2 != n_heads:
        s = (s[1::2] + s[0::2])[:n_heads]
    return torch.tensor(s, dtype=torch.float32)


def per_column(w: torch.Tensor, mode: str) -> torch.Tensor:
    """``w`` (d_in, d_out) as its per-column codes times their scale."""
    top = LEVELS[mode]
    amax = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12)
    s = amax / torch.full_like(amax, top)  # a true division (a scalar divisor may become a reciprocal product)
    return torch.round(w / s).clamp(-top, top) * s


def _layer(x: torch.Tensor, w: dict, c: dict, slopes: torch.Tensor) -> torch.Tensor:
    t, d = x.shape
    h = c["n_heads"]
    hd = d // h
    eps = c["layer_norm_eps"]
    y = F.layer_norm(x, (d,), w["ln1.scale"], w["ln1.bias"], eps)
    q, k, v = ((y @ w[f"attn.{n}.w"]).reshape(t, h, hd).transpose(0, 1) for n in ("wq", "wk", "wv"))
    s = q @ k.transpose(-1, -2) / math.sqrt(hd)
    pos = torch.arange(t, device=x.device, dtype=torch.float32)
    s = s + slopes.to(x.device)[:, None, None] * (pos[None, None, :] - pos[None, :, None])
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    a = (torch.softmax(s, dim=-1) @ v).transpose(0, 1).reshape(t, d)
    x = x + a @ w["attn.wo.w"]
    y = F.layer_norm(x, (d,), w["ln2.scale"], w["ln2.bias"], eps)
    return x + F.gelu(y @ w["mlp.wi.w"]) @ w["mlp.wo.w"]


def final_hidden(c: dict, outer: dict, layer_weights, seqs: list, modes=("int8c",)) -> dict:
    """The final-norm hidden states (T, D) of each token sequence in
    ``seqs``, for each weight mode in ``modes``.  ``layer_weights(i)``
    returns layer i's float weights (names of ``inputs.mpt_layer``)."""
    slopes = alibi_slopes(c["n_heads"], c["attn_config"]["alibi_bias_max"])
    dev = outer["tok_embed"].device
    xs = {m: [outer["tok_embed"][torch.as_tensor(s, device=dev)] for s in seqs] for m in modes}
    for i in range(c["n_layers"]):
        w = layer_weights(i)
        for m in modes:
            wm = {k: (per_column(v, m) if k in DENSE else v) for k, v in w.items()}
            xs[m] = [_layer(x, wm, c, slopes) for x in xs[m]]
            del wm
        del w
    d = c["d_model"]
    return {m: [F.layer_norm(x, (d,), outer["ln_f.scale"], outer["ln_f.bias"], c["layer_norm_eps"]) for x in xs[m]]
            for m in modes}


def logits(outer: dict, h: torch.Tensor) -> torch.Tensor:
    return h @ outer["tok_embed"].T
