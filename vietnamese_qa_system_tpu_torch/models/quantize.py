"""Quantized dense weights for serving (int8 blockwise and int8c).

Counterpart of the serving half of ``vietnamese_qa_system_tpu/models/
quantize.py``: ``quantize_weight`` in modes ``int8`` (one f32 absmax scale
per ``block`` input rows) and ``int8c`` (one scale per output column, the
layout kernel K6 reads), ``dequantize_weight`` for int8 leaves (defined
in models/layers.py, where ``Dense`` uses it), and
``quantize_dense_tree``, which quantizes every dense layer of a module in
place except the LM head (embeddings are not dense layers).  Codes and
scales are bit-identical to the JAX package: ``absmax / 127`` and
``w / scale`` are true f32 divisions, ``torch.round`` rounds half to even
like ``jnp.round``.

nf4 and nf4-dq are training formats (QLoRA) and are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.quant import div127
from .layers import Dense, dequantize_weight

__all__ = ["MODES", "dequantize_weight", "quantize_dense_tree", "quantize_weight"]

MODES = ("int8", "int8c")


def _pick_block(d_in: int, block: int) -> int:
    """Largest power-of-two block <= requested that divides d_in (>= 2)."""
    b = 1 << max(block.bit_length() - 1, 1)
    while b > 2 and d_in % b:
        b //= 2
    if b < 2 or d_in % b:
        raise ValueError(f"no even power-of-two block divides d_in={d_in}")
    return b


def quantize_weight(w: torch.Tensor, mode: str = "int8c", block: int = 64) -> dict:
    """(d_in, d_out) float weight -> {"w_q" int8 (d_in, d_out), "w_s" f32
    (d_in / block, d_out)} with ``w ~= w_q * w_s`` per block; ``int8c`` is
    one block spanning all of d_in (``w_s`` is (1, d_out))."""
    if mode in ("nf4", "nf4-dq"):
        raise NotImplementedError(f"{mode} quantization is not ported yet (it comes with training)")
    if mode not in MODES:
        raise ValueError(f"mode must be int8, int8c, nf4 or nf4-dq, got {mode!r}")
    w = w.float().contiguous()  # a transposed view would give strided codes, which K6 refuses
    d_in, d_out = w.shape
    block = d_in if mode == "int8c" else _pick_block(d_in, block)
    nb = d_in // block
    wb = w.reshape(nb, block, d_out)
    absmax = wb.abs().amax(dim=1).clamp_min(1e-12)
    scale = div127(absmax)
    q = torch.round(wb / scale[:, None, :]).clamp(-127, 127)
    return {"w_q": q.reshape(d_in, d_out).to(torch.int8), "w_s": scale}


def quantize_dense_tree(model: nn.Module, mode: str = "int8c", block: int = 64) -> nn.Module:
    """Quantize every float dense layer of ``model`` in place, except the
    LM head (kept float for logit accuracy, like bitsandbytes'
    ``llm_int8_skip_modules`` default).  Biases and norms stay float."""
    for name, mod in model.named_modules():
        if isinstance(mod, Dense) and mod.w is not None and name.split(".")[-1] != "lm_head":
            leaf = quantize_weight(mod.w.detach(), mode, block)
            mod.set_quantized(leaf["w_q"], leaf["w_s"])
    return model
