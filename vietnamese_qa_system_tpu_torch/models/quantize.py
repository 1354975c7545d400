"""Quantized dense weights: int8 blockwise, int8c, nf4 and nf4-dq.

Counterpart of ``vietnamese_qa_system_tpu/models/quantize.py``:
``quantize_weight`` in modes ``int8`` (one f32 absmax scale per ``block``
input rows), ``int8c`` (one scale per output column, the layout kernel K6
reads), ``nf4`` (two 4-bit normal-float codes a byte along d_in, even row
in the low nibble, with the blockwise absmax) and ``nf4-dq`` (nf4 whose
absmax plane is itself quantized to int8 codes ``s_q`` with one f32 offset
``s_m`` and step ``s_s`` a block row); ``dequantize_weight`` (defined in
models/layers.py, where ``Dense`` uses it at the point of use);
``quantize_dense_tree``, which quantizes every dense layer of a module in
place except the LM head (embeddings are not dense layers);
``dequantize_tree``, the float weights of a quantized model (the
trainer's "once" placements) and ``tree_bytes``.  A dense layer's
(d_in, d_out) whatever its storage (``dense_shape``) is ``Dense.shape``.

Codes and scales are bit-identical to the JAX package's eager
``quantize_weight``: ``absmax / 127`` and ``w / scale`` are true f32
divisions, ``torch.round`` rounds half to even like ``jnp.round``, and the
nf4 code of a value is the number of level midpoints below it
(``searchsorted``, left side, as ``jnp.searchsorted``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.quant import div127
from .layers import NF4_LEVELS, Dense, dequantize_weight

__all__ = ["MODES", "NF4_LEVELS", "dequantize_tree", "dequantize_weight", "quantize_dense_tree", "quantize_weight",
           "tree_bytes"]

MODES = ("int8", "int8c", "nf4", "nf4-dq")


def _pick_block(d_in: int, block: int) -> int:
    """Largest power-of-two block <= requested that divides d_in (>= 2)."""
    b = 1 << max(block.bit_length() - 1, 1)
    while b > 2 and d_in % b:
        b //= 2
    if b < 2 or d_in % b:
        raise ValueError(f"no even power-of-two block divides d_in={d_in}")
    return b


def _nf4_mids(device) -> torch.Tensor:
    """The 15 midpoints between adjacent levels, in f32 as the JAX package
    computes them from its f32 codebook."""
    levels = torch.tensor(NF4_LEVELS, dtype=torch.float32)
    return ((levels[1:] + levels[:-1]) / 2.0).to(device)


def quantize_weight(w: torch.Tensor, mode: str = "int8c", block: int = 64) -> dict:
    """(d_in, d_out) float weight -> a quantized leaf.

    int8 / int8c: {"w_q" int8 (d_in, d_out), "w_s" f32 (d_in / block,
    d_out)} with ``w ~= w_q * w_s`` per block; ``int8c`` is one block
    spanning all of d_in (``w_s`` is (1, d_out)).  nf4: {"w_q" uint8
    (d_in / 2, d_out), "w_s" the f32 blockwise absmax}.  nf4-dq: {"w_q",
    "s_q" int8 (nb, d_out), "s_s" f32 (nb, 1), "s_m" f32 (nb, 1)} with the
    absmax ~= s_q * s_s + s_m."""
    if mode not in MODES:
        raise ValueError(f"mode must be int8, int8c, nf4 or nf4-dq, got {mode!r}")
    w = w.float().contiguous()  # a transposed view would give strided codes, which K6 refuses
    d_in, d_out = w.shape
    block = d_in if mode == "int8c" else _pick_block(d_in, block)
    nb = d_in // block
    wb = w.reshape(nb, block, d_out)
    absmax = wb.abs().amax(dim=1).clamp_min(1e-12)
    if mode in ("int8", "int8c"):
        scale = div127(absmax)
        q = torch.round(wb / scale[:, None, :]).clamp(-127, 127)
        return {"w_q": q.reshape(d_in, d_out).to(torch.int8), "w_s": scale}
    normed = wb / absmax[:, None, :]
    codes = torch.searchsorted(_nf4_mids(w.device), normed.contiguous()).to(torch.uint8)
    pairs = codes.reshape(d_in // 2, 2, d_out)
    packed = pairs[:, 0] | (pairs[:, 1] << 4)
    if mode == "nf4":
        return {"w_q": packed, "w_s": absmax}
    # double quantization of the (nb, d_out) absmax plane, one (offset,
    # step) pair a block row (quantize.py:139-150)
    # the mean as XLA computes it, sum x (1 / n), of a sum accumulated in
    # f64: the same f32 value on every device (XLA's own f32 summation
    # order puts its mean within a few ulps of it)
    s_m = absmax.double().sum(dim=1, keepdim=True).float() * (1.0 / d_out)
    c = absmax - s_m
    s_s = div127(c.abs().amax(dim=1, keepdim=True).clamp_min(1e-12))
    s_q = torch.round(c / s_s).clamp(-127, 127).to(torch.int8)
    return {"w_q": packed, "s_q": s_q, "s_s": s_s, "s_m": s_m}


def quantize_dense_tree(model: nn.Module, mode: str = "int8c", block: int = 64) -> nn.Module:
    """Quantize every float dense layer of ``model`` in place, except the
    LM head (kept float for logit accuracy, like bitsandbytes'
    ``llm_int8_skip_modules`` default).  Biases and norms stay float."""
    for name, mod in model.named_modules():
        if isinstance(mod, Dense) and mod.w is not None and name.split(".")[-1] != "lm_head":
            mod.set_quantized(**quantize_weight(mod.w.detach(), mode, block))
    return model


def dequantize_tree(model: nn.Module, dtype=torch.float32, *, fold_lora: bool = True) -> nn.Module:
    """Give every quantized dense layer of ``model`` its float weight
    (``w_dequant``, in ``dtype``), in place; returns the model
    (quantize.py:241-298).  With ``fold_lora`` the LoRA factors that
    ``merge_lora`` attached are folded into it (``W + A @ B`` in f32, then
    cast: export semantics) and no longer apply lazily (``lora_folded``);
    without, only the frozen base is dequantized and the factors apply
    lazily.  The "once" placement of the trainer uses ``fold_lora=False``:
    the weight is then constant in the adapter and autograd forms no
    full-size weight gradient; "once_folded" folds, and autograd forms a
    (d_in, d_out) f32 gradient of every layer before contracting it to
    the factors'.  ``models/lora.py:clear_lora`` takes the weights off
    again."""
    for mod in model.modules():
        if isinstance(mod, Dense) and mod.w_q is not None:
            mod.lora_folded = fold_lora and mod.lora_a is not None
            mod.w_dequant = dequantized_weight(mod, fold_lora).to(dtype)
    return model


def dequantized_weight(dense: Dense, fold_lora: bool = True) -> torch.Tensor:
    """A quantized dense layer's f32 weight from its codes, with its
    attached LoRA factors folded in when ``fold_lora`` (``W + A @ B`` in
    f32: the export semantics of :func:`dequantize_tree`)."""
    w = dense.dequantized(torch.float32)
    if fold_lora and dense.lora_a is not None:
        w = w + dense.lora_a @ dense.lora_b  # lora_b carries alpha / r
    return w


def tree_bytes(model: nn.Module) -> int:
    """Bytes of every tensor of ``model`` (parameters and buffers)."""
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())
