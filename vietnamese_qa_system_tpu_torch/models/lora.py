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
detached).  ``stack_adapters`` and ``select_adapters`` (multi-LoRA
serving) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..utils.tree import flatten_paths, nest, tree_leaves
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


def _targets(model: nn.Module, cfg: LoraConfig) -> dict[str, Dense]:
    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, Dense) and name.split(".")[-1] in cfg.targets}


def _shape(dense: Dense) -> tuple[int, int]:
    return tuple((dense.w if dense.w_q is None else dense.w_q).shape)


def init_lora(generator: torch.Generator, model: nn.Module, cfg: LoraConfig) -> dict:
    """An adapter for every targeted dense layer of ``model`` (float or
    quantized): A ~ N(0, 1/r^2) drawn from ``generator`` (on its device),
    B = 0, so the adapted model starts equal to the base.  Leaves are f32
    and require grad."""
    flat = {}
    for name, dense in sorted(_targets(model, cfg).items()):
        d_in, d_out = _shape(dense)
        dev = generator.device
        a = torch.randn(d_in, cfg.r, generator=generator, device=dev) / cfg.r
        flat[f"{name}.a"] = a.requires_grad_(True)
        flat[f"{name}.b"] = torch.zeros(cfg.r, d_out, device=dev, requires_grad=True)
    return nest(flat)


def merge_lora(model: nn.Module, adapter: dict, cfg: LoraConfig) -> nn.Module:
    """Attach ``adapter`` to ``model``'s dense layers (in place; returns
    the model): lazy factors on quantized layers, ``W + scale * A @ B`` on
    float ones.  Differentiable in the adapter; pass detached leaves for
    export.  :func:`clear_lora` takes them off again."""
    flat = flatten_paths(adapter)
    for name in sorted({path.rsplit(".", 1)[0] for path in flat}):
        dense = model.get_submodule(name)
        a, b = flat[f"{name}.a"], flat[f"{name}.b"]
        if dense.w_q is not None:
            dense.lora_a, dense.lora_b = a, b * cfg.scale
        else:
            w = dense.w.detach()
            dense.w_merged = w + ((a.float() @ b.float()) * cfg.scale).to(w.dtype)
    return model


def clear_lora(model: nn.Module) -> None:
    for mod in model.modules():
        if isinstance(mod, Dense):
            mod.lora_a = mod.lora_b = mod.w_merged = None


def count_params(tree) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(tree))
