"""LoRA adapters.

Counterpart of ``vietnamese_qa_system_tpu/models/lora.py:26-142``: an
adapter is a tree mirroring the targeted dense layers of a model --
``{"blocks": [{"attn": {"wq": {"a", "b"}, ...}, "mlp": {...}}, ...]}``, the
JAX package's nesting, so adapters and checkpoints move between the
packages (models/params.py, train/checkpoint.py).  ``merge_lora`` attaches
the factors to the model's ``Dense`` layers: a quantized base gets them
lazily (``y += (x @ A) @ (scale * B)``), a float base the merged weight
``W + scale * A @ B`` (f32, cast back to W's type).  Gradients reach the
adapter through whatever the attached tensors were made from, and the base
never trains (a quantized base's codes are buffers; a float base is used
detached).

Multi-LoRA serving (lora.py:145-234): ``stack_adapters`` stacks same-shaped
adapters into a bank (index 0 the zero adapter, ``b`` pre-scaled by
alpha / r), ``place_bank`` lays it onto the dense layers that apply it
(a tensor-parallel reader's split parts each take their slice, on their
device) and ``select_adapters`` gathers per-row factors from it at a
(B,) index for ``layers.row_adapters``; ``load_adapter`` reads the
``adapter.npz`` that either package's ``train --use-lora
--checkpoint-dir`` writes.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import torch
from torch import nn

from ..utils.tree import flatten_paths, nest, tree_leaves, tree_map
from .layers import Dense

# the dense leaves eligible for adaptation: q/k/v/o and the MLP in/out
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "wi")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    alpha: int = 16
    targets: Sequence[str] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def _targets(model: nn.Module, cfg: LoraConfig) -> dict[str, tuple[int, int]]:
    """{name: (d_in, d_out)} of every targeted dense layer of ``model``; a
    tensor-parallel reader's split parts stand for their whole layer, under
    its unsharded name (``blocks.0.attn.parts.1.wq`` is ``blocks.0.attn.wq``)."""
    return {re.sub(r"\.parts\.\d+", "", name): getattr(mod, "tp_whole", mod.shape)
            for name, mod in model.named_modules() if isinstance(mod, Dense) and name.split(".")[-1] in cfg.targets}


def init_lora(generator: torch.Generator, model: nn.Module, cfg: LoraConfig) -> dict:
    """An adapter for every targeted dense layer of ``model`` (float or
    quantized; of a tensor-parallel reader, its whole layers): A ~ N(0,
    1/r^2) drawn from ``generator`` (on its device), B = 0, so the adapted
    model starts equal to the base.  Leaves are f32 and require grad."""
    flat = {}
    for name, (d_in, d_out) in sorted(_targets(model, cfg).items()):
        dev = generator.device
        a = torch.randn(d_in, cfg.r, generator=generator, device=dev) / cfg.r
        flat[f"{name}.a"] = a.requires_grad_(True)
        flat[f"{name}.b"] = torch.zeros(cfg.r, d_out, device=dev, requires_grad=True)
    return nest(flat)


def merge_lora(model: nn.Module, adapter: dict, cfg: LoraConfig) -> nn.Module:
    """Attach ``adapter`` to ``model``'s dense layers (in place; returns
    the model) by :func:`attach_factors`.  Differentiable in the adapter;
    pass detached leaves for export.  :func:`clear_lora` takes them off
    again."""
    flat = flatten_paths(adapter)
    for name in sorted({path.rsplit(".", 1)[0] for path in flat}):
        attach_factors(model.get_submodule(name), flat[f"{name}.a"], flat[f"{name}.b"], cfg.scale)
    return model


def attach_factors(dense: Dense, a: torch.Tensor, b: torch.Tensor, scale: float) -> None:
    """Attach one layer's whole factors: lazy factors on a quantized layer,
    ``W + scale * A @ B`` on a float one.  A tensor-parallel part
    (``layers.split_dense``) takes B's columns of its part (``tp_cols``: x @ A
    is computed whole) or A's rows (``tp_rows``: the row-parallel sum adds
    the partial products), on its own device; gradients reach the whole
    leaves through the slices."""
    cols, rows = getattr(dense, "tp_cols", None), getattr(dense, "tp_rows", None)
    if cols is not None:
        b = b[:, cols]
    if rows is not None:
        a = a[rows]
    dev = (dense.w_q if dense.w_q is not None else dense.w).device
    a, b = a.to(dev), b.to(dev)
    if dense.w_q is not None:
        dense.lora_a, dense.lora_b = a, b * scale
    else:
        w = dense.w.detach()
        dense.w_merged = w + ((a.float() @ b.float()) * scale).to(w.dtype)


def clear_lora(model: nn.Module) -> None:
    """Take off what ``merge_lora`` and ``quantize.dequantize_tree`` attached."""
    for mod in model.modules():
        if isinstance(mod, Dense):
            mod.lora_a = mod.lora_b = mod.w_merged = mod.w_dequant = None
            mod.lora_folded = False


def stack_adapters(adapters: Sequence[dict], cfg: LoraConfig) -> dict:
    """Stack same-shaped adapters into a serving bank: every ``a`` / ``b``
    leaf gains a leading adapter axis, index 0 is a zero adapter (the base
    model: a request without an adapter costs one rank-r product instead
    of a branch) and ``b`` is pre-scaled by alpha / r.  Adapters that
    target other layers, or another rank, raise ValueError.  The bank's
    leaves are detached, on the adapters' device."""
    if not adapters:
        raise ValueError("stack_adapters needs at least one adapter")
    flats = [flatten_paths(ad) for ad in adapters]
    if any(sorted(f) != sorted(flats[0]) for f in flats[1:]):
        raise ValueError("adapters target different leaves (same base + same LoraConfig.targets required)")
    bank = {}
    for path in flats[0]:
        leaves = [f[path].detach().float() for f in flats]
        if any(leaf.shape != leaves[0].shape for leaf in leaves[1:]):
            raise ValueError(f"adapter leaf shapes differ: {[tuple(leaf.shape) for leaf in leaves]} "
                             "(same rank r required)")
        stacked = torch.stack([torch.zeros_like(leaves[0]), *leaves])
        bank[path] = stacked * cfg.scale if path.endswith(".b") else stacked
    return nest(bank)


class PlacedBank(dict):
    """A bank laid onto a model's layers (:func:`place_bank`): {module:
    (a (N, d_in, r) or None, b (N, r, d_out) or None)}, each on its
    module's device."""


def place_bank(model: nn.Module, bank: dict) -> PlacedBank:
    """The bank ``stack_adapters`` made, by the layer of ``model`` that
    applies each leaf pair: the Dense layer itself, or on a
    tensor-parallel reader its split parts (``layers.split_dense``), each
    with its slice, copied to the part's device once (an engine places its
    bank when it is built).  A column part takes B's columns with A whole;
    a row part takes A's rows and no B, and its layer (``layers.
    TPAttention`` / ``TPMLP``) takes B whole on the lead device: the layer
    sums the parts' x @ A before it rounds and multiplies by B, as the
    unsharded Dense does (``layers._RowParallel``).  On the bank's device
    a whole leaf is the bank's own tensor."""
    flat = flatten_paths(bank)
    out = PlacedBank()
    for name in sorted({path.rsplit(".", 1)[0] for path in flat}):
        a, b = flat[f"{name}.a"], flat[f"{name}.b"]
        try:
            parts, layer = [model.get_submodule(name)], None
        except AttributeError:  # a tensor-parallel layer's split parts
            parent, leaf = name.rsplit(".", 1)
            layer = model.get_submodule(parent)
            parts = [getattr(part, leaf) for part in layer.parts]
        for dense in parts:
            cols, rows = getattr(dense, "tp_cols", None), getattr(dense, "tp_rows", None)
            dev = (dense.w_q if dense.w_q is not None else dense.w).device
            if rows is not None:
                out[dense] = (a[:, rows].to(dev).contiguous(), None)
                out[layer] = (None, b.to(layer.lead))
            else:
                out[dense] = (a.to(dev), (b if cols is None else b[:, :, cols]).to(dev).contiguous())
    return out


def select_adapters(model: nn.Module, bank: dict, idx) -> dict:
    """Per-row factors of ``bank`` (stacked, or placed by
    :func:`place_bank`) at ``idx`` for ``model``'s dense layers: {Dense:
    (a (B, d_in, r), b (B, r, d_out))} for a (B,) index tensor, (d_in, r) /
    (r, d_out) for a scalar one (a tensor-parallel reader's row parts and
    their layers hold one of the two, see :func:`place_bank`); apply them
    with ``layers.row_adapters``.  Each layer gathers on its own device,
    the index copied there once, and nothing is read back to the host."""
    placed = bank if isinstance(bank, PlacedBank) else place_bank(model, bank)
    at = {}
    out = {}
    for mod, factors in placed.items():
        dev = next(f.device for f in factors if f is not None)
        if isinstance(idx, torch.Tensor):
            if dev not in at:
                at[dev] = idx.to(dev)
            ix = at[dev]
        else:
            ix = idx
        out[mod] = tuple(None if f is None else f[ix] for f in factors)
    return out


def load_adapter(path: str, model: nn.Module, cfg: LoraConfig) -> dict:
    """The adapter tree in ``path`` (an ``adapter.npz`` of either package's
    trainer, leaves in the JAX order) for ``model``'s targeted layers
    under ``cfg``, f32 on the model's device.  A file that holds another
    adapter (leaf count or shapes) raises ValueError."""
    from ..train.checkpoint import load_pytree

    like = init_lora(torch.Generator().manual_seed(0), model, cfg)
    return tree_map(lambda t: t.detach().to(model.device), load_pytree(path, like))


def count_params(tree) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(tree))
