"""Evaluation: token-weighted perplexity and generative eval.

Counterpart of ``vietnamese_qa_system_tpu/train/evaluate.py``:
``perplexity_eval`` (:38-90), the forward-only loss over an eval set with
one host sync at the end, and ``generative_eval`` (:91-223), generation
driven by a ``GenerationConfig`` with the predictions logged as the JAX
package logs them, for causal and seq2seq models.  Both run on one device: the JAX functions' ``mesh``
and multi-host gathers have no counterpart yet.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.generate import GenerationConfig, generate_with_config


def perplexity_eval(model, cfg: ModelConfig, batches: Iterable[dict]) -> dict:
    """{"eval_loss", "perplexity", "eval_tokens"} of ``model`` (a
    :class:`CausalLM` or an encoder-decoder, with any adapter attached)
    over host batches {"input_ids", "attention_mask", "labels"}."""
    from ..train.trainer import model_loss_fn

    loss_fn = model_loss_fn(cfg)
    dev = model.device
    total_nll = torch.zeros((), dtype=torch.float32, device=dev)
    total_n = torch.zeros((), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for batch in batches:
            b = {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(dev) for k, v in batch.items()}
            loss, n = loss_fn(model, b)
            total_nll += loss * n
            total_n += n
    mean_nll = float(total_nll) / max(float(total_n), 1.0)  # the one sync
    return {"eval_loss": mean_nll, "perplexity": float(np.exp(min(mean_nll, 80.0))), "eval_tokens": int(total_n)}


def generative_eval(model, cfg: ModelConfig, tokenizer, batches: Iterable[dict], *, max_new_tokens: int = 32,
                    temperature: float = 0.0, gen_config: Optional[GenerationConfig] = None,
                    log_dir: Optional[str] = None, epoch: int = 0, run_name: str = "model") -> dict:
    """Generation over prompt batches {"input_ids", "attention_mask"}
    (LEFT-padded host arrays: a causal model's prompts or a seq2seq
    model's encoder inputs, with optional "reference" strings) by
    ``gen_config`` (beams, sampling, penalties, speculation), or by the
    ``max_new_tokens`` / ``temperature`` shorthands without one.  Writes
    ``{log_dir}/log_dir_e{epoch}_{run_name}_{time}.txt`` in the JAX
    package's format and returns {"n_examples", "gen_tokens_per_s",
    "records"}: each record's "prompt", "prediction" and, where given,
    "reference".  Generated tokens are counted without the pad and eos
    fill after a row stops.  A batch's tokens are fetched and decoded
    after the next batch's generation is dispatched, so that decoding
    overlaps the device's work where the decode loop reads nothing back.
    A seq2seq model decodes from the start token 0, the shift-right start
    its training losses use (evaluate.py:184-189)."""
    is_s2s = cfg.arch == "seq2seq"
    if gen_config is None:
        gen_config = GenerationConfig(max_new_tokens=max_new_tokens, temperature=temperature)
    dev = model.device
    records = []
    n_tokens = 0
    t0 = time.time()

    def flush(batch, ids, out):
        nonlocal n_tokens
        out = out.cpu().numpy()
        if is_s2s:  # new tokens only: keep the causal layout (prompt, then tokens)
            out = np.concatenate([ids, out], axis=1)
        tail = out[:, ids.shape[1]:]
        n_tokens += int(((tail != tokenizer.pad_id) & (tail != tokenizer.eos_id)).sum())
        refs = batch.get("reference")
        for r in range(out.shape[0]):
            rec = {"prompt": tokenizer.decode([t for t in ids[r] if t != tokenizer.pad_id]),
                   "prediction": tokenizer.decode([t for t in tail[r]
                                                   if t not in (tokenizer.pad_id, tokenizer.eos_id)])}
            if refs is not None:
                rec["reference"] = refs[r]
            records.append(rec)

    pending = None
    for batch in batches:
        ids = np.asarray(batch["input_ids"])
        out = generate_with_config(model, torch.from_numpy(ids).to(dev),
                                   torch.from_numpy(np.asarray(batch["attention_mask"])).to(dev), gen_config,
                                   eos_id=tokenizer.eos_id, bos_id=0 if is_s2s else tokenizer.bos_id)
        if pending is not None:
            flush(*pending)
        pending = (batch, ids, out)
    if pending is not None:
        flush(*pending)
    elapsed = time.time() - t0
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fname = os.path.join(log_dir, f"log_dir_e{epoch}_{run_name}_{time.strftime('%Y%m%d_%H%M%S')}.txt")
        with open(fname, "w") as f:
            for rec in records:
                for k, v in rec.items():
                    f.write(f"### {k}:\n{v}\n")
                f.write("\n" + "=" * 60 + "\n")
    return {"n_examples": len(records), "gen_tokens_per_s": n_tokens / max(elapsed, 1e-9), "records": records}
