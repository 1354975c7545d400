"""Parity of the port's train step with the JAX package's
``make_train_step`` on the same carried weights and numpy batches, on the
CPU (the JAX flash kernels in Pallas interpret mode, the port's through
their plain versions).

- A tiny PhoGPT-like model -- MPT ALiBi over 6 heads of 32, flash
  attention, the chunked loss (vocab 16,384), int8 base + LoRA, scan
  layers with the proj_bf16 remat, grad accumulation over 2 microbatches,
  adamw: the loss, the adapter gradients and the adapter after 2 steps.
- A rope / GQA model and a GPT-Neo-like local-window model (flash, LoRA
  over a float base): the loss and the adapter gradients.

Tolerances: loss 1e-4 relative (bf16-rounded products: a rounding flip
upstream moves an f32 sum by an ulp of bf16), 1e-3 for the second step's
loss (see below); each adapter gradient leaf
within 5e-2 of its largest entry (the flash kernels round P and dS to
bf16); the adapter's move over 2 adamw steps: its median difference
over the elements whose first JAX gradient exceeds 5% of the leaf's
largest entry within 5% of lr, and its norm difference within 25% of the
JAX move's norm.  Adam normalises every element, so an element whose
gradient is near rounding noise moves by about lr either way, and the
second step's gradients are taken at adapters that already differ there
(measured: medians 1-2% of lr, norms 5-15%; a wrong sign, scale or
schedule gives a median near lr)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import causal_lm as jcl
from vietnamese_qa_system_tpu.models import config as jcfg
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models.quantize import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu.train import optim as jopt
from vietnamese_qa_system_tpu.train import trainer as jtrainer
from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, adapter_from_jax, causal_from_jax,
                                                   clear_lora, loss_fn, merge_lora)
from vietnamese_qa_system_tpu_torch.train import TrainConfig, make_train_step, params_tree
from vietnamese_qa_system_tpu_torch.train import optim as topt
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(4)

LR = 1e-2
LORA = dict(r=4, alpha=8)


def _setup(cfg, quantize, seed):
    params = jcl.init_causal_lm(jax.random.key(seed), cfg)
    if quantize:
        params = jquant(params, quantize)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    # B != 0, so the gradients of A are not zero at the first step
    adapter = jax.tree.map(lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
                           jlora.init_lora(jax.random.key(seed + 1), params, jlora.LoraConfig(**LORA)))
    return params, adapter, rng


def _batch(rng, vocab, shape):
    ids = rng.integers(3, vocab, shape).astype(np.int32)
    labels = ids.copy()
    labels[..., : shape[-1] // 4] = -100
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels}


def _port_leaves(jax_tree):
    """A JAX adapter-shaped tree (stacked or not) as the port's leaf list."""
    return [x.detach().numpy() for x in tree_leaves(adapter_from_jax(jax.tree.map(np.asarray, jax_tree), "cpu"))]


def _jax_grads(params, adapter, cfg, mb):
    def loss(ad):
        return jcl.loss_fn(jlora.merge_lora(params, ad, jlora.LoraConfig(**LORA)), cfg, mb)

    # jitted, as the JAX trainer runs it: eager JAX rounds every bf16
    # elementwise op (the MLP's gelu) to bf16, XLA computes them in f32
    (value, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(adapter)
    return float(value), _port_leaves(grads)


def _port_grads(model, adapter, mb):
    merge_lora(model, adapter, LoraConfig(**LORA))
    loss, _ = loss_fn(model, {k: torch.from_numpy(v.astype(np.int64)) for k, v in mb.items()})
    grads = torch.autograd.grad(loss, tree_leaves(adapter))
    clear_lora(model)
    return float(loss.detach()), [g.numpy() for g in grads]


def _grads_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), (np.abs(g - w).max(), np.abs(w).max())


def test_train_step_matches_jax():
    cfg = dataclasses.replace(jcfg.phogpt_4b_class(), vocab_size=16384, d_model=192, n_heads=6, n_layers=2, d_ff=768,
                              max_seq_len=256, scan_layers=True, remat_policy="proj_bf16")
    params, adapter, rng = _setup(cfg, "int8", 0)
    batches = [_batch(rng, cfg.vocab_size, (2, 2, 48)) for _ in range(2)]  # (accum, micro, T)
    mb0 = {k: v[0] for k, v in batches[0].items()}
    jloss, jgrads = _jax_grads(params, adapter, cfg, mb0)
    lc = jlora.LoraConfig(**LORA)
    tx = jopt.make_optimizer("adamw", jopt.make_schedule("linear", LR, 10, 0))
    jstep = jtrainer.make_train_step(jtrainer.TrainConfig(model=cfg, lora=lc, quantize_base="int8", grad_accum=2), tx)
    # copies: the step donates its state, and jnp.asarray may alias numpy memory
    jstate = {"params": jax.tree.map(jnp.array, params), "adapter": jax.tree.map(jnp.array, adapter),
              "opt_state": tx.init(jax.tree.map(jnp.array, adapter)), "step": jnp.zeros([], jnp.int32)}
    jmetrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.array(v) for k, v in b.items()})
        jmetrics.append({k: float(v) for k, v in m.items()})

    tcfg = TrainConfig(model=ModelConfig.from_dict(dataclasses.asdict(cfg)), lora=LoraConfig(**LORA),
                       quantize_base="int8", grad_accum=2)
    model = causal_from_jax(params, tcfg.model, device="cpu")
    tad = adapter_from_jax(adapter, device="cpu")
    tloss, tgrads = _port_grads(model, tad, mb0)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _grads_close(tgrads, jgrads)

    ttx = topt.make_optimizer("adamw", topt.make_schedule("linear", LR, 10, 0))
    state = {"params": params_tree(model), "adapter": tad, "opt_state": ttx.init(tad),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(tcfg, ttx, model)
    before = [x.detach().numpy().copy() for x in tree_leaves(tad)]
    codes = model.blocks[0].mlp.wi.w_q.clone()
    for i, (b, jm) in enumerate(zip(batches, jmetrics)):
        state, m = step(state, {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()})
        # step 2 starts from adapters that differ where Adam normalised
        # noise-level gradients (an lr-sized move either way): 1e-3 there
        np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-4 if i == 0 else 1e-3)
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=5e-2)
    assert int(state["step"]) == 2 and torch.equal(model.blocks[0].mlp.wi.w_q, codes)
    after_j = _port_leaves(jstate["adapter"])
    for b0, mine, theirs, g in zip(before, tree_leaves(state["adapter"]), after_j, jgrads):
        moved_j = theirs - b0
        sure = np.abs(g) > 0.05 * np.abs(g).max()
        assert sure.any()
        d = np.abs((mine.detach().numpy() - b0) - moved_j)
        assert np.median(d[sure]) <= 0.05 * LR, np.median(d[sure]) / LR
        assert np.linalg.norm(d) <= 0.25 * np.linalg.norm(moved_j), np.linalg.norm(d) / np.linalg.norm(moved_j)


CONFIGS = {
    "rope_gqa": lambda: dataclasses.replace(jcfg.llama_1b_class(), vocab_size=512, d_model=128, n_heads=4,
                                            n_kv_heads=2, n_layers=2, d_ff=256, max_seq_len=256,
                                            use_flash_attention=True, scan_layers=False),
    "local_window": lambda: dataclasses.replace(jcfg.gpt_neo_125m(), vocab_size=512, d_model=128, n_heads=4,
                                                n_layers=2, d_ff=256, max_seq_len=256, attention_window=24,
                                                attention_layers=("global", "local"), use_flash_attention=True,
                                                scan_layers=False),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flash_loss_and_adapter_grads_match_jax(name):
    cfg = CONFIGS[name]()
    params, adapter, rng = _setup(cfg, None, 3)
    mb = _batch(rng, cfg.vocab_size, (2, 80))
    jloss, jgrads = _jax_grads(params, adapter, cfg, mb)
    model = causal_from_jax(params, ModelConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tloss, tgrads = _port_grads(model, adapter_from_jax(adapter, device="cpu"), mb)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _grads_close(tgrads, jgrads)
