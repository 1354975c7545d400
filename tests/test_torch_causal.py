"""Parity of the port's causal LM with the JAX package on the same weights
(``init_causal_lm`` pytree carried across by ``causal_from_jax``), for every
causal preset the reader CLI accepts, at reduced width: 2 layers,
128-divisible widths, vocab 512, each preset keeping its kind (phogpt: 6
heads under mpt ALiBi; llama / qwen2: their GQA ratio; gpt-neo: a local
window; pythia: parallel residual and partial rotary).

Tolerance: logits max abs <= 2e-2 and mean abs <= 1e-3 (|logits| ~ 1-6).
Every product rounds its inputs to bf16, so an f32 difference of one ulp
upstream can move an input across a bf16 rounding boundary: the JAX
forward itself moves by up to ~4e-3 when its embeddings change by 2e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.models import layers as jl
from vietnamese_qa_system_tpu.models import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu_torch.core import make_generator
from vietnamese_qa_system_tpu_torch.models import (ModelConfig, causal_from_jax, init_causal_lm, make_cache,
                                                   unstack_blocks)
from vietnamese_qa_system_tpu_torch.models import layers as tl

torch.set_num_threads(2)
MAX_TOL, MEAN_TOL = 2e-2, 1e-3

SMALL = dict(vocab_size=512, d_model=256, d_ff=512, n_layers=2, use_flash_attention=False, scan_layers=False)
PRESETS = {
    "tiny": dataclasses.replace(jc.tiny_test("causal"), use_flash_attention=False),
    "gpt125m": dataclasses.replace(jc.gpt_125m_class(), n_heads=4, **SMALL),
    "gptneo125m": dataclasses.replace(jc.gpt_neo_125m(), n_heads=4, attention_layers=("global", "local"),
                                      attention_window=8, **SMALL),
    "pythia410m": dataclasses.replace(jc.pythia_410m_class(), n_heads=4, **SMALL),
    "llama1b": dataclasses.replace(jc.llama_1b_class(), n_heads=8, n_kv_heads=2, **SMALL),
    "qwen2-05b": dataclasses.replace(jc.qwen2_05b_class(), n_heads=8, n_kv_heads=2, **SMALL),
    "bloom560m": dataclasses.replace(jc.bloom_560m_class(), n_heads=4, **SMALL),
    "phogpt4b": dataclasses.replace(jc.phogpt_4b_class(), n_heads=6, **dict(SMALL, d_model=384)),
}


def _port(params, cfg, quantize=None):
    if quantize:
        params = jquant(params, quantize)
    return causal_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_dict(dataclasses.asdict(cfg)),
                           device="cpu")


def _close(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= MAX_TOL and diff.mean() <= MEAN_TOL, (diff.max(), diff.mean())


def _batch(seed, t=20):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 512, (3, t)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :7] = 0  # left padding
    mask[2, :1] = 0
    return ids * mask, mask


@pytest.mark.parametrize("name", list(PRESETS))
def test_forward_matches_jax(name):
    cfg = PRESETS[name]
    params = jlm.init_causal_lm(jax.random.key(1), cfg)
    ids, mask = _batch(2)
    want = np.asarray(jlm.forward(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    model = _port(params, cfg)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == (3, ids.shape[1], cfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("quantize", [None, "int8c"])
@pytest.mark.parametrize("name", list(PRESETS))
def test_prefill_and_cached_step_match_jax(name, quantize):
    """Prefill through the KV cache (as generate runs it), then one cached
    decode step; with int8c the decode step's dense layers take K6's route
    (3 rows) and the prefill's too (60 rows)."""
    cfg = PRESETS[name]
    params = jlm.init_causal_lm(jax.random.key(3), cfg)
    ids, mask = _batch(4)
    b, t = ids.shape
    total = t + 4
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    key_valid = np.concatenate([mask.astype(bool), np.zeros((b, 4), bool)], axis=1)
    prefill_mask = (np.arange(total)[None, None, :] <= np.arange(t)[None, :, None]) & key_valid[:, None, :]
    step_ids = np.array([[7], [300], [11]], np.int32)
    step_pos = mask.sum(1, keepdims=True)
    step_mask = key_valid[:, None, :] | (np.arange(total) == t)[None, None, :]

    jparams = params if quantize is None else jquant(params, quantize)
    jcache = jg._make_cache(cfg, b, total, cfg.n_layers)
    want0, jcache = jlm.forward(jparams, cfg, jnp.asarray(ids), jnp.asarray(prefill_mask),
                                positions=jnp.asarray(positions), cache=jcache, cache_index=0)
    want1, _ = jlm.forward(jparams, cfg, jnp.asarray(step_ids), jnp.asarray(step_mask),
                           positions=jnp.asarray(step_pos), cache=jcache, cache_index=t)

    model = _port(params, cfg, quantize)
    cache = make_cache(model.cfg, b, total, "cpu")
    with torch.inference_mode():
        got0 = model(torch.from_numpy(ids).long(), torch.from_numpy(prefill_mask),
                     positions=torch.from_numpy(positions).long(), cache=cache, cache_index=0).numpy()
        got1 = model(torch.from_numpy(step_ids).long(), torch.from_numpy(step_mask),
                     positions=torch.from_numpy(step_pos).long(), cache=cache, cache_index=t).numpy()
    _close(got0, np.asarray(want0))
    _close(got1, np.asarray(want1))


def test_scan_stacked_tree_carries_and_flash_refuses():
    cfg = dataclasses.replace(PRESETS["phogpt4b"], scan_layers=True)
    params = jax.tree.map(np.asarray, jquant(jlm.init_causal_lm(jax.random.key(5), cfg), "int8c"))
    assert params["blocks"]["attn"]["wq"]["w_q"].shape == (2, 384, 384)
    listed = jax.tree.map(np.asarray, jlm.unstack_blocks(params, 2))
    ours = unstack_blocks(params, 2)
    assert jax.tree.structure(ours) == jax.tree.structure(listed)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(listed)):
        np.testing.assert_array_equal(a, b)
    model = causal_from_jax(params, ModelConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    assert model.blocks[1].mlp.wi.w_q.dtype == torch.int8
    np.testing.assert_array_equal(model.blocks[1].mlp.wi.w_q.numpy(), params["blocks"]["mlp"]["wi"]["w_q"][1])
    # the cache-less forward with use_flash_attention=True used to refuse;
    # it now runs the causal flash path with the ALiBi key-only bias and
    # agrees with the JAX package's flash forward (Pallas, interpret mode)
    flash = dataclasses.replace(cfg, use_flash_attention=True)
    ids = np.random.default_rng(0).integers(0, 512, (2, 40))
    model.cfg = ModelConfig.from_dict(dataclasses.asdict(flash))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long()).numpy()
    _close(got, np.asarray(jlm.forward(params, flash, jnp.asarray(ids, jnp.int32))))


def test_causal_from_jax_is_strict():
    params = jax.tree.map(np.asarray, jlm.init_causal_lm(jax.random.key(0), PRESETS["tiny"]))
    del params["blocks"][1]["ln2"]
    with pytest.raises(RuntimeError, match="ln2"):
        causal_from_jax(params, ModelConfig.from_dict(dataclasses.asdict(PRESETS["tiny"])), device="cpu")


@pytest.mark.parametrize("n_heads", [6, 12, 16, 24])
@pytest.mark.parametrize("mode", ["bloom", "mpt"])
def test_alibi_and_rope_tables_match_jax(mode, n_heads):
    np.testing.assert_array_equal(tl.alibi_slopes(n_heads, mode).numpy(), np.asarray(jl.alibi_slopes(n_heads, mode)))
    np.testing.assert_array_equal(tl.alibi_bias(n_heads, 33, mode).numpy(),
                                  np.asarray(jl.alibi_bias(n_heads, jnp.arange(33), mode)))
    for got, want in zip(tl.rope_frequencies(16, 64, 1e4), jl.rope_frequencies(16, 64, 1e4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_init_causal_lm_seeded():
    cfg = ModelConfig.from_dict(dataclasses.asdict(PRESETS["llama1b"]))
    a = init_causal_lm(cfg, make_generator(3)).state_dict()
    b = init_causal_lm(cfg, make_generator(3)).state_dict()
    c = init_causal_lm(cfg, make_generator(4)).state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["blocks.0.attn.wq.w"], c["blocks.0.attn.wq.w"])
    assert a["blocks.0.attn.wk.w"].shape == (256, 64) and "blocks.0.ln1.bias" not in a  # GQA, RMSNorm
    assert a["blocks.1.mlp.wg.w"].abs().max() <= 1 / 256 ** 0.5
    assert abs(a["tok_embed"].std().item() - 0.02) < 2e-3 and "lm_head.w" in a
