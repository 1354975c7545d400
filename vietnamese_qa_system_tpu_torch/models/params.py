"""Carry a JAX encoder parameter tree into the port."""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .encoder import SentenceEncoder


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


def encoder_from_jax(params, cfg: ModelConfig, device="cpu") -> SentenceEncoder:
    """The JAX ``init_encoder`` pytree (numpy leaves) -> :class:`SentenceEncoder`.

    Paths join with dots (``params["blocks"][0]["attn"]["wq"]["w"]`` is
    ``blocks.0.attn.wq.w``); dense weights keep their (d_in, d_out) layout.
    Every tensor the module expects must be present, and nothing else."""
    flat = {
        name: torch.tensor(np.asarray(leaf, dtype=np.float32), device=device)
        for name, leaf in _flatten(params, "", {}).items()
    }
    model = SentenceEncoder(cfg, device="meta")
    model.load_state_dict(flat, strict=True, assign=True)
    return model.eval().requires_grad_(False)
