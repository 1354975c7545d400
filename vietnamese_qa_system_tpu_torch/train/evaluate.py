"""Evaluation: token-weighted perplexity.

Counterpart of ``perplexity_eval`` in
``vietnamese_qa_system_tpu/train/evaluate.py:38-90``: the forward-only loss
over an eval set, with one host sync at the end.  ``generative_eval`` is
not ported yet.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..models import causal_lm
from ..models.config import ModelConfig


def perplexity_eval(model, cfg: ModelConfig, batches: Iterable[dict]) -> dict:
    """{"eval_loss", "perplexity", "eval_tokens"} of ``model`` (a
    :class:`CausalLM`, with any adapter attached) over host batches
    {"input_ids", "attention_mask", "labels"}."""
    if cfg.arch != "causal":
        raise NotImplementedError(f"perplexity of a {cfg.arch} model is not ported yet")
    dev = model.device
    total_nll = torch.zeros((), dtype=torch.float32, device=dev)
    total_n = torch.zeros((), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for batch in batches:
            b = {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(dev) for k, v in batch.items()}
            loss, n = causal_lm.loss_fn(model, b)
            total_nll += loss * n
            total_n += n
    mean_nll = float(total_nll) / max(float(total_n), 1.0)  # the one sync
    return {"eval_loss": mean_nll, "perplexity": float(np.exp(min(mean_nll, 80.0))), "eval_tokens": int(total_n)}
