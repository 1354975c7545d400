"""The port's generation against the JAX package: greedy ``generate`` on
carried weights (float and int8c, tiny and a phogpt-kind reader), the
logit processors, the HF-style decode options, the sampler's marginals,
and what ``generate_with_config`` dispatches and refuses.

Greedy streams are compared by the margin rule: tokens must agree until
the first step whose top-2 logit margin (JAX logits, teacher-forced on the
JAX stream) is below the logit tolerance of test_torch_causal.py (2e-2),
where bf16 rounding may legitimately flip the argmax.
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
from vietnamese_qa_system_tpu.models import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu_torch.models import GenerationConfig, ModelConfig, causal_from_jax
from vietnamese_qa_system_tpu_torch.models import generate as tg

torch.set_num_threads(2)
MARGIN_TOL = 2e-2

READERS = {
    "tiny": jc.tiny_test("causal"),
    "phogpt": dataclasses.replace(jc.phogpt_4b_class(), vocab_size=512, d_model=384, n_heads=6, d_ff=768,
                                  n_layers=2, max_seq_len=256),
}


def _reader(name, quantize=None, seed=0):
    cfg = READERS[name]
    params = jlm.init_causal_lm(jax.random.key(seed), cfg)
    if quantize:
        params = jquant(params, quantize)
    port = causal_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    return params, cfg, port


def _prompts(seed, b=4, t=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 260, (b, t)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1::2, : t // 3] = 0  # left padding on every other row
    return ids * mask, mask


def _assert_margin_rule(got, want, mask, params, cfg):
    """Rows agree until the first near-tie of the JAX stream."""
    if np.array_equal(got, want):
        return
    t = mask.shape[1]
    full = np.concatenate([mask, np.ones((mask.shape[0], want.shape[1] - t - 1), mask.dtype)], axis=1)
    flat = dataclasses.replace(cfg, use_flash_attention=False)
    logits = np.asarray(jlm.forward(params, flat, jnp.asarray(want[:, :-1]), jnp.asarray(full),
                                    positions=jnp.asarray(np.maximum(np.cumsum(full, axis=1) - 1, 0))))
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r, t:] != want[r, t:])[0]
        if len(diff):
            step = t + diff[0]
            top2 = np.sort(logits[r, step - 1])[-2:]
            assert top2[1] - top2[0] < MARGIN_TOL, (r, step, top2)


@pytest.mark.parametrize("quantize", [None, "int8c"])
@pytest.mark.parametrize("name", list(READERS))
def test_greedy_generate_matches_jax(name, quantize):
    params, cfg, port = _reader(name, quantize)
    ids, mask = _prompts(1)
    want = np.asarray(jg.generate(params, cfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=8, eos_id=2))
    got = tg.generate(port, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=8, eos_id=2).numpy()
    assert got.shape == (4, 24) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :16], ids)
    _assert_margin_rule(got, want, mask, params, cfg)


def test_decode_options_match_jax():
    """repetition_penalty, no_repeat_ngram_size (1 and 3) and
    min_new_tokens with an eos id, greedy, against the JAX loop."""
    params, cfg, port = _reader("tiny", seed=2)
    ids, mask = _prompts(3, b=2, t=12)
    ids[0, -6:] = ids[0, :6] if mask[0, 0] else ids[0, -6:]
    for kw in (dict(repetition_penalty=1.3), dict(no_repeat_ngram_size=1), dict(no_repeat_ngram_size=3),
               dict(min_new_tokens=4, repetition_penalty=0.8)):
        want = np.asarray(jg.generate(params, cfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=10,
                                      eos_id=5, **kw))
        got = tg.generate(port, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=10, eos_id=5,
                          **kw).numpy()
        _assert_margin_rule(got, want, mask, params, cfg)


def _logits(seed, b=3, v=64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    x[0, 5] = x[0, 9]  # a tie
    return x


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.9), (0, 0.5), (8, 0.7), (1, 1.0)])
def test_process_logits_masks_match_jax(top_k, top_p):
    x = _logits(top_k + int(top_p * 10))
    want = np.asarray(jg._process_logits(jnp.asarray(x), temperature=0.7, top_k=top_k, top_p=top_p))
    got = tg._process_logits(torch.from_numpy(x), temperature=0.7, top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tg._top_p_mask(torch.from_numpy(x), 0.8).numpy(),
                                  np.asarray(jg._top_p_mask(jnp.asarray(x), 0.8)))


def test_sampler_marginals_match_processed_softmax():
    """40,000 draws of one row: every token's frequency within 0.012 of the
    JAX processed distribution (> 5 standard deviations), masked tokens
    never drawn, and the draws repeat for the same generator seed."""
    x = np.repeat(_logits(7, b=1, v=16), 40_000, axis=0)
    kw = dict(temperature=0.8, top_k=6, top_p=0.95)
    p = np.asarray(jax.nn.softmax(jg._process_logits(jnp.asarray(x[:1]), **kw), axis=-1))[0]
    draw = tg._sample_logits(torch.from_numpy(x), torch.Generator().manual_seed(0), **kw)
    freq = np.bincount(draw.numpy(), minlength=16) / len(x)
    assert np.abs(freq - p).max() < 0.012
    assert freq[p == 0].sum() == 0
    again = tg._sample_logits(torch.from_numpy(x), torch.Generator().manual_seed(0), **kw)
    assert torch.equal(draw, again)
    assert torch.equal(tg._sample_logits(torch.from_numpy(x[:2]), None, temperature=0.0, top_k=0, top_p=1.0),
                       torch.full((2,), int(x[0].argmax()), dtype=torch.int32))


def test_sampled_generate_is_seeded():
    _, _, port = _reader("tiny")
    ids, mask = _prompts(5)
    gen = GenerationConfig(max_new_tokens=6, temperature=0.9, top_p=0.9, seed=3)
    a = tg.generate_with_config(port, torch.from_numpy(ids), torch.from_numpy(mask), gen)
    b = tg.generate_with_config(port, torch.from_numpy(ids), torch.from_numpy(mask), gen)
    c = tg.generate_with_config(port, torch.from_numpy(ids), torch.from_numpy(mask),
                                dataclasses.replace(gen, seed=4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_generate_with_config_refuses_what_is_not_ported():
    _, _, port = _reader("tiny")
    ids, mask = _prompts(6, b=1, t=8)
    args = (port, torch.from_numpy(ids), torch.from_numpy(mask))
    # beams and both speculative modes are ported: they dispatch to their decode loops
    assert torch.equal(tg.generate_with_config(*args, GenerationConfig(max_new_tokens=4, num_beams=2), eos_id=2),
                       tg.beam_search(*args, max_new_tokens=4, num_beams=2, eos_id=2))
    plain = tg.generate(*args, max_new_tokens=5, eos_id=2)
    assert torch.equal(tg.generate_with_config(*args, GenerationConfig(max_new_tokens=5, speculative="ngram"),
                                               eos_id=2), plain)
    assert torch.equal(tg.generate_with_config(*args, GenerationConfig(max_new_tokens=5, speculative="draft"),
                                               eos_id=2, draft=port), plain)
    for gen in (GenerationConfig(speculative="draft"), GenerationConfig(speculative="ngram", num_beams=2),
                GenerationConfig(speculative="ngram", repetition_penalty=1.2),
                GenerationConfig(speculative="ngram", min_new_tokens=2)):
        with pytest.raises(ValueError):
            tg.generate_with_config(*args, gen)
    # the int8 KV cache is ported: it runs as generate(kv_dtype="int8") (test_torch_kv_quant.py)
    assert torch.equal(tg.generate_with_config(*args, GenerationConfig(max_new_tokens=3, kv_dtype="int8")),
                       tg.generate(*args, max_new_tokens=3, kv_dtype="int8"))
    for gen in (GenerationConfig(speculative="medusa"), GenerationConfig(forced_bos_token_id=3),
                GenerationConfig(num_beams=2, no_repeat_ngram_size=2), GenerationConfig(kv_dtype="fp8")):
        with pytest.raises(ValueError):
            tg.generate_with_config(*args, gen)
    timings = {}
    out = tg.generate(port, *args[1:], max_new_tokens=3, timings=timings)
    assert out.shape == (1, 11) and timings["prefill_s"] >= 0 and timings["decode_s"] >= 0
