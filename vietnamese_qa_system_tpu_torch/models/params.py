"""Carry JAX parameter trees (numpy leaves) into the port's modules, and
LoRA adapters both ways."""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.tree import flatten_paths, nest, tree_leaves
from .causal_lm import CausalLM, unstack_blocks
from .config import ModelConfig
from .encoder import SentenceEncoder
from .layers import Dense


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _flatten(sub, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree
    return out


def encoder_from_jax(params, cfg: ModelConfig, device="cuda") -> SentenceEncoder:
    """The JAX ``init_encoder`` pytree (numpy leaves) -> :class:`SentenceEncoder`.

    Paths join with dots (``params["blocks"][0]["attn"]["wq"]["w"]`` is
    ``blocks.0.attn.wq.w``); dense weights keep their (d_in, d_out) layout.
    Every tensor the module expects must be present, and nothing else."""
    device = resolve_device(device)
    flat = {
        name: torch.tensor(np.asarray(leaf, dtype=np.float32), device=device)
        for name, leaf in _flatten(params, "", {}).items()
    }
    model = SentenceEncoder(cfg, device="meta")
    model.load_state_dict(flat, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def causal_from_state_dict(state: dict, cfg: ModelConfig) -> CausalLM:
    """A :class:`CausalLM` over the tensors of ``state`` (``state_dict``
    names; quantized layers as ``.w_q`` / ``.w_s``), used as they are, on
    their device.  Every tensor the module expects must be present, and
    nothing else."""
    model = CausalLM(cfg, device="meta")
    for name, mod in model.named_modules():
        if isinstance(mod, Dense) and f"{name}.w_q" in state:
            mod.set_quantized(torch.empty_like(state[f"{name}.w_q"], device="meta"),
                              torch.empty_like(state[f"{name}.w_s"], device="meta"))
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def causal_from_jax(params, cfg: ModelConfig, device="cuda") -> CausalLM:
    """A JAX causal-LM pytree (numpy leaves; list-form or scan-stacked
    blocks) -> :class:`CausalLM`.  Float leaves load as f32; quantized
    ``int8`` / ``int8c`` leaves ``{w_q, w_s[, b]}`` are carried bit for bit
    (int8 codes, f32 scales)."""
    device = resolve_device(device)
    flat = {}
    for name, leaf in _flatten(unstack_blocks(params, cfg.n_layers), "", {}).items():
        leaf = np.asarray(leaf)
        if name.endswith(".w_q") and leaf.dtype != np.int8:
            raise NotImplementedError(f"{name}: {leaf.dtype} codes (nf4) are not ported yet; int8 and int8c are")
        if name.endswith((".s_q", ".s_s", ".s_m")):
            raise NotImplementedError(f"{name}: double-quantized (nf4-dq) leaves are not ported yet")
        flat[name] = torch.from_numpy(np.array(leaf, dtype=leaf.dtype if leaf.dtype == np.int8 else np.float32))
        flat[name] = flat[name].to(device)
    return causal_from_state_dict(flat, cfg)


def adapter_from_jax(adapter, device="cuda") -> dict:
    """A JAX LoRA adapter pytree (numpy leaves; list-form or scan-stacked
    blocks) -> the port's adapter tree (list-form nesting, f32 tensors that
    require grad)."""
    device = resolve_device(device)
    blocks = adapter.get("blocks")
    if isinstance(blocks, dict):  # scan-stacked: every leaf (L, ...)
        adapter = unstack_blocks(adapter, len(tree_leaves(blocks)[0]))
    flat = {name: torch.tensor(np.asarray(leaf, dtype=np.float32), device=device).requires_grad_(True)
            for name, leaf in _flatten(adapter, "", {}).items()}
    return nest(flat)


def adapter_to_jax(adapter) -> dict:
    """The port's adapter tree -> the JAX package's pytree, numpy leaves."""
    return nest({name: leaf.detach().cpu().numpy() for name, leaf in flatten_paths(adapter).items()})
