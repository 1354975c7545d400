"""Evaluation: token-weighted perplexity and generative eval.

Counterpart of ``vietnamese_qa_system_tpu/train/evaluate.py``:
``perplexity_eval`` (:38-90), the forward-only loss over an eval set with
one host sync at the end, and ``generative_eval`` (:91-223), generation
driven by a ``GenerationConfig`` with the predictions logged as the JAX
package logs them, for causal and seq2seq models.

With ``mesh`` each batch's rows are split over the mesh's data rows
(``train/mesh.py:split_rows``), each share run by that row's model: the
trainer's rows (``Trainer.merged_replicas()``), or copies of one model on
the rows' devices; the totals and records are those of the one-device run.
Under several processes (``core/distributed.py``) each process feeds its
own shard of the eval set, and the (nll, n) totals and the generated token
blocks are all-gathered, so every process reports the whole set
(evaluate.py:74-82, :131-162).
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..core import distributed
from ..core.mesh import DATA_AXIS, Mesh
from ..models.config import ModelConfig
from ..models.generate import GenerationConfig, generate_with_config
from ..parallel.sharding import batch_sharding
from .mesh import data_replicas, split_rows, target_count


def perplexity_eval(model, cfg: ModelConfig, batches: Iterable[dict], *, mesh: Optional[Mesh] = None) -> dict:
    """{"eval_loss", "perplexity", "eval_tokens"} of ``model`` (a
    :class:`CausalLM` or an encoder-decoder, with any adapter attached; a
    list of one model a data row with ``mesh``) over host batches
    {"input_ids", "attention_mask", "labels"}."""
    from ..train.trainer import model_loss_fn

    loss_fn = model_loss_fn(cfg)
    if mesh is not None and batch_sharding(mesh)[0] != DATA_AXIS:
        mesh = None  # no data axis: the batches run whole on the first row
    rows = data_replicas(model, mesh)
    dev = rows[0].device
    total_nll = torch.zeros((), dtype=torch.float32, device=dev)
    total_n = torch.zeros((), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for batch in batches:
            host = {k: np.asarray(v).astype(np.int64) for k, v in batch.items()}
            if mesh is None or len(host["labels"]) % len(rows):
                # one device, or a short batch that does not split: the first row runs it whole
                b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
                loss, n = loss_fn(rows[0], b)
                total_nll += loss * n
                total_n += n
                continue
            grid = mesh.grid()
            split = {k: split_rows(torch.from_numpy(v), grid) for k, v in host.items()}
            step = host["labels"].shape[0] // len(grid)
            n_batch = 0
            for i, row in enumerate(rows):
                c = target_count(cfg, host["labels"][i * step:(i + 1) * step])
                loss, _ = loss_fn(row, {k: v[i] for k, v in split.items()})
                total_nll += (loss * c).to(dev)
                n_batch += c
            total_n += max(n_batch, 1)
    totals = torch.stack([total_nll, total_n]).cpu().numpy()  # the one sync
    if distributed.process_count() > 1:
        totals = np.sum(distributed.allgather_object(totals), axis=0)
    mean_nll = float(totals[0]) / max(float(totals[1]), 1.0)
    return {"eval_loss": mean_nll, "perplexity": float(np.exp(min(mean_nll, 80.0))),
            "eval_tokens": int(totals[1])}


def generative_eval(model, cfg: ModelConfig, tokenizer, batches: Iterable[dict], *, max_new_tokens: int = 32,
                    temperature: float = 0.0, gen_config: Optional[GenerationConfig] = None,
                    log_dir: Optional[str] = None, epoch: int = 0, run_name: str = "model",
                    mesh: Optional[Mesh] = None) -> dict:
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
    its training losses use (evaluate.py:184-189).  With ``mesh`` each
    batch's prompts are split over the data rows (a list of one model a
    row, or one model copied to each).  Under several processes every
    process's token blocks are gathered before decoding, so each process
    logs the whole set; the "reference" strings then stay local and are
    dropped from the records, as in the JAX package."""
    is_s2s = cfg.arch == "seq2seq"
    if gen_config is None:
        gen_config = GenerationConfig(max_new_tokens=max_new_tokens, temperature=temperature)
    if mesh is not None and batch_sharding(mesh)[0] != DATA_AXIS:
        mesh = None
    rows = data_replicas(model, mesh)
    dev = rows[0].device
    multi = distributed.process_count() > 1
    records = []
    n_tokens = 0
    t0 = time.time()

    def generate(ids, mask):
        if mesh is None or len(ids) % len(rows):
            return generate_with_config(rows[0], torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                                        gen_config, eos_id=tokenizer.eos_id, bos_id=0 if is_s2s else tokenizer.bos_id)
        grid = mesh.grid()
        outs = [generate_with_config(row, i_, m_, gen_config, eos_id=tokenizer.eos_id,
                                     bos_id=0 if is_s2s else tokenizer.bos_id)
                for row, i_, m_ in zip(rows, split_rows(torch.from_numpy(ids), grid),
                                       split_rows(torch.from_numpy(mask), grid))]
        return [o.cpu() for o in outs]

    def flush(batch, ids, out):
        nonlocal n_tokens
        out = torch.cat(out).numpy() if isinstance(out, list) else out.cpu().numpy()
        if is_s2s:  # new tokens only: keep the causal layout (prompt, then tokens)
            out = np.concatenate([ids, out], axis=1)
        if multi:
            ids, out = distributed.allgather_rows(ids), distributed.allgather_rows(out)
            batch = {k: v for k, v in batch.items() if k != "reference"}
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
        out = generate(ids, np.asarray(batch["attention_mask"]))
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
