"""The port's speculative decoding against the JAX package:
``generate_speculative`` (prompt lookup) and ``generate_speculative_draft``
(a draft model) on carried weights, with the inputs of
tests/test_speculative.py.

Greedy speculation must give the tokens of plain greedy ``generate``; on
these small configurations the port's and the JAX package's streams are
equal token for token, so equality is asserted.  Sampled speculation is
held by distribution: the empirical marginals of 4,096 rows against the
enumerated exact marginals (TV < 0.08), with the port's plain sampled
``generate`` as the control.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import ModelConfig as JConfig
from vietnamese_qa_system_tpu.models import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu.models.causal_lm import init_causal_lm
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu_torch.models import GenerationConfig, ModelConfig, causal_from_jax
from vietnamese_qa_system_tpu_torch.models import generate as tg

torch.set_num_threads(2)
BASE = dict(arch="causal", vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=256)
DRAFT = dict(arch="causal", vocab_size=97, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq_len=256)
CONFIGS = {
    "base": JConfig(**BASE),
    "gptneo_local": JConfig(**{**BASE, "positional": "learned", "attention_scale": 1.0, "activation": "gelu_new"},
                            attention_layers=("global", "local"), attention_window=8),
    "gqa": JConfig(**{**BASE, "n_kv_heads": 2, "norm": "rmsnorm", "mlp_gated": True}),
    "alibi": JConfig(**{**BASE, "positional": "alibi", "embed_layernorm": True}),
    "int8c": JConfig(**BASE),
}
TV_TOL = 0.08  # TV noise at N=4096, V=13 is ~0.03


def _pair(cfg, seed=0, quantize=None):
    params = init_causal_lm(jax.random.key(seed), cfg)
    if quantize:
        params = jquant(params, quantize)
    port = causal_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_dict(dataclasses.asdict(cfg)),
                           device="cpu")
    return params, port


def _prompts(rng, b, t, vocab_hi=90):
    """tests/test_speculative.py's left-padded prompts."""
    ids = rng.integers(4, vocab_hi, (b, t)).astype(np.int32)
    lens = rng.integers(3, t + 1, (b,))
    mask = np.zeros((b, t), np.int32)
    for r in range(b):
        mask[r, t - lens[r]:] = 1
        ids[r, : t - lens[r]] = 0
    return ids, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("b,t,eos,gamma,ngram", [(1, 16, 2, 5, 2), (3, 20, None, 8, 3), (2, 8, 2, 3, 1)])
def test_speculative_greedy_matches_jax_and_generate(name, b, t, eos, gamma, ngram):
    cfg = CONFIGS[name]
    params, port = _pair(cfg, quantize="int8c" if name == "int8c" else None)
    ids, mask = _prompts(np.random.default_rng(b), b, t)
    want = np.asarray(jg.generate_speculative(params, cfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=24,
                                              eos_id=eos, draft_tokens=gamma, draft_ngram=ngram))
    got, stats = tg.generate_speculative(port, *_t(ids, mask), max_new_tokens=24, eos_id=eos, draft_tokens=gamma,
                                         draft_ngram=ngram, return_stats=True)
    assert got.shape == (b, t + 24) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tg.generate(port, *_t(ids, mask), max_new_tokens=24, eos_id=eos).numpy())
    assert 1 <= stats["iterations"] <= 23 and stats["drafted_accepted"] >= 0


def test_verify_windows_stay_inside_the_cache(monkeypatch):
    """The cache is T + max_new + gamma wide, so every window stays inside
    it (a per-row write past the end would clamp onto the last column).  A
    row that reached index max_new - 1 while another row still runs keeps
    verifying there: its window ends on the last column exactly, as the
    prompt-lookup run below shows."""
    cfg = CONFIGS["base"]
    _, port = _pair(cfg)
    ids, mask = _prompts(np.random.default_rng(3), 3, 12)
    seen = []
    real = port.hidden_states

    def recording(x, m=None, *, cache=None, cache_index=None, **kw):
        if isinstance(cache_index, torch.Tensor):
            seen.append((int((cache_index + x.shape[1] - 1).max()), cache[0]["k"].shape[1]))
        return real(x, m, cache=cache, cache_index=cache_index, **kw)

    monkeypatch.setattr(port, "hidden_states", recording)
    for fn, kw in ((tg.generate_speculative, dict(draft_ngram=2)), (tg.generate_speculative_draft, dict())):
        seen.clear()
        extra = (port,) if fn is tg.generate_speculative_draft else ()
        out, stats = fn(port, *extra, *_t(ids, mask), max_new_tokens=20, eos_id=None, draft_tokens=4,
                        return_stats=True, **kw)
        width = 12 + 20 + 4
        assert seen and all(w == width and last < width for last, w in seen), seen
        if fn is tg.generate_speculative:
            assert max(last for last, _ in seen) == width - 1
        np.testing.assert_array_equal(out.numpy(), tg.generate(port, *_t(ids, mask), max_new_tokens=20).numpy())


def test_speculative_eos_inside_window_matches_greedy():
    """tests/test_speculative.py:434: a window may accept an eos and tokens
    after it, which must not be written; with eos emitted mid-stream (both
    drafters) and eos in the prompt (the n-gram drafter proposes it)."""
    cfg = CONFIGS["base"]
    rng = np.random.default_rng(0)
    found = 0
    for seed in range(6):
        params, port = _pair(cfg, seed)
        ids = rng.integers(4, 90, (2, 12)).astype(np.int32)
        mask = np.ones_like(ids)
        ref0 = tg.generate(port, *_t(ids, mask), max_new_tokens=24).numpy()
        emitted = [x for x in np.unique(ref0[:, 12 + 2:]) if x > 3]
        if not emitted:
            continue
        eos = int(emitted[0])
        found += 1
        ref = tg.generate(port, *_t(ids, mask), max_new_tokens=24, eos_id=eos).numpy()
        jref = np.asarray(jg.generate(params, cfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=24,
                                      eos_id=eos))
        np.testing.assert_array_equal(ref, jref)
        draft = tg.generate_speculative_draft(port, port, *_t(ids, mask), max_new_tokens=24, eos_id=eos,
                                              draft_tokens=5)
        np.testing.assert_array_equal(draft.numpy(), ref)
        ngram = tg.generate_speculative(port, *_t(ids, mask), max_new_tokens=24, eos_id=eos, draft_tokens=5,
                                        draft_ngram=2)
        np.testing.assert_array_equal(ngram.numpy(), ref)
        ids2 = ids.copy()
        ids2[:, 5] = eos
        ref2 = tg.generate(port, *_t(ids2, mask), max_new_tokens=24, eos_id=eos).numpy()
        got2 = tg.generate_speculative(port, *_t(ids2, mask), max_new_tokens=24, eos_id=eos, draft_tokens=5,
                                       draft_ngram=2)
        np.testing.assert_array_equal(got2.numpy(), ref2)
        np.testing.assert_array_equal(got2.numpy(), np.asarray(jg.generate_speculative(
            params, cfg, jnp.asarray(ids2), jnp.asarray(mask), max_new_tokens=24, eos_id=eos, draft_tokens=5,
            draft_ngram=2)))
    assert found >= 2, "the test never constructed an emitted-eos case"


def test_draft_model_greedy_matches_regardless_of_draft():
    """An unrelated random draft accepts almost nothing; the tokens are
    plain greedy's all the same, and equal JAX's draft-model decode."""
    cfg, dcfg = JConfig(**BASE), JConfig(**DRAFT)
    params, port = _pair(cfg)
    dparams, dport = _pair(dcfg, seed=5)
    ids, mask = _prompts(np.random.default_rng(8), 3, 16)
    got = tg.generate_speculative_draft(port, dport, *_t(ids, mask), max_new_tokens=20, eos_id=2, draft_tokens=4)
    np.testing.assert_array_equal(got.numpy(), tg.generate(port, *_t(ids, mask), max_new_tokens=20, eos_id=2).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg.generate_speculative_draft(
        params, cfg, dparams, dcfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=20, eos_id=2,
        draft_tokens=4)))


def test_draft_model_vocab_mismatch_raises():
    _, port = _pair(JConfig(**BASE))
    _, dport = _pair(JConfig(**{**DRAFT, "vocab_size": 64}))
    ids, mask = _prompts(np.random.default_rng(0), 1, 8)
    with pytest.raises(ValueError, match="vocabulary"):
        tg.generate_speculative_draft(port, dport, *_t(ids, mask), max_new_tokens=4)
    with pytest.raises(ValueError, match="vocabulary"):
        tg.generate_with_config(port, *_t(ids, mask), GenerationConfig(max_new_tokens=4, speculative="draft"),
                                draft=dport)


@pytest.mark.parametrize("n_new", [20, 40])
def test_self_draft_takes_the_fewest_passes(n_new):
    """draft == target accepts every draft: the first token comes from the
    prefill and each pass then yields gamma + 1, so ceil((n - 1) / (gamma +
    1)) passes.  The JAX function takes more: its draft steps never write
    the last draft's K/V, so the pass after a fully accepted one drafts
    over an empty cache slot (ROADMAP Queue 3)."""
    cfg = JConfig(**BASE)
    params, port = _pair(cfg)
    ids, mask = _prompts(np.random.default_rng(9), 2, 12)
    gamma = 4
    got, stats = tg.generate_speculative_draft(port, port, *_t(ids, mask), max_new_tokens=n_new, eos_id=None,
                                               draft_tokens=gamma, return_stats=True)
    want, jstats = jg.generate_speculative_draft(params, cfg, params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                                                 max_new_tokens=n_new, eos_id=None, draft_tokens=gamma,
                                                 return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), tg.generate(port, *_t(ids, mask), max_new_tokens=n_new).numpy())
    fewest = -(-(n_new - 1) // (gamma + 1))
    assert stats["iterations"] == fewest
    assert stats["drafted_accepted"] == 2 * (n_new - 1 - fewest)
    assert int(jstats["iterations"]) > fewest


def test_generation_config_dispatch_and_guards():
    """tests/test_speculative.py:167: ngram through generate_with_config,
    the JAX guards, sampled speculation's shape."""
    cfg = JConfig(**BASE)
    _, port = _pair(cfg)
    ids, mask = _t(*_prompts(np.random.default_rng(5), 2, 10))
    out = tg.generate_with_config(port, ids, mask, GenerationConfig(max_new_tokens=8, speculative="ngram"), eos_id=2)
    assert torch.equal(out, tg.generate(port, ids, mask, max_new_tokens=8, eos_id=2))
    for fn, extra in ((tg.generate_speculative, ()), (tg.generate_speculative_draft, (port,))):
        timings = {}
        assert torch.equal(fn(port, *extra, ids, mask, max_new_tokens=8, eos_id=2, timings=timings), out)
        assert timings["prefill_s"] >= 0 and timings["decode_s"] >= 0
    for bad in (GenerationConfig(speculative="ngram", num_beams=2),
                GenerationConfig(speculative="ngram", repetition_penalty=1.2),
                GenerationConfig(speculative="ngram", no_repeat_ngram_size=2),
                GenerationConfig(speculative="draft", kv_dtype="int8"), GenerationConfig(speculative="magic"),
                GenerationConfig(speculative="draft")):
        with pytest.raises(ValueError):
            tg.generate_with_config(port, ids, mask, bad, eos_id=2)
    for spec in ("ngram", "draft"):
        gen = GenerationConfig(max_new_tokens=8, speculative=spec, temperature=0.8, top_k=20, seed=1)
        a = tg.generate_with_config(port, ids, mask, gen, eos_id=2, draft=port)
        assert a.shape == (2, 18) and torch.equal(a, tg.generate_with_config(port, ids, mask, gen, eos_id=2,
                                                                            draft=port))
    with pytest.raises(ValueError):
        tg.generate_speculative(port, ids, mask, draft_tokens=0)
    with pytest.raises(ValueError):
        tg.generate_speculative(port, ids, mask, draft_ngram=0)


def _marginals(params, cfg, prompt, depth):
    """Exact marginals of the target at produced positions 0 .. depth - 1,
    enumerated through the JAX forward."""
    from vietnamese_qa_system_tpu.models.causal_lm import forward

    v = cfg.vocab_size

    def dist_after(prefix):
        lg = np.asarray(forward(params, cfg, jnp.asarray(prefix), jnp.ones(prefix.shape, jnp.int32)))[:, -1]
        e = np.exp(lg.astype(np.float64) - lg.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    p0 = dist_after(prompt)[0]
    out = [p0]
    pre1 = np.concatenate([np.tile(prompt, (v, 1)), np.arange(v)[:, None]], axis=1).astype(np.int32)
    p1 = dist_after(pre1)
    out.append(p0 @ p1)
    if depth > 2:
        pairs = np.stack(np.meshgrid(np.arange(v), np.arange(v), indexing="ij"), -1).reshape(-1, 2)
        pre2 = np.concatenate([np.tile(prompt, (v * v, 1)), pairs], axis=1).astype(np.int32)
        out.append(np.einsum("i,ij,ijk->k", p0, p1, dist_after(pre2).reshape(v, v, v)))
    return out


def _check_marginals(name, toks, exact, v):
    for pos, want in enumerate(exact):
        emp = np.bincount(toks[:, pos], minlength=v) / toks.shape[0]
        tv = 0.5 * np.abs(emp - want).sum()
        assert tv < TV_TOL, f"{name} pos {pos}: TV {tv:.3f}"


V13 = dict(arch="causal", vocab_size=13, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq_len=64)


def test_speculative_sampling_marginals_exact():
    """tests/test_speculative.py:192: rejection sampling against the
    point-mass drafter draws positions 0-2 from the exact marginals."""
    cfg = JConfig(**V13)
    params, port = _pair(cfg, seed=3)
    prompt = np.random.default_rng(0).integers(0, 13, (1, 6)).astype(np.int32)
    exact = _marginals(params, cfg, prompt, 3)
    ids, mask = _t(np.tile(prompt, (4096, 1)), np.ones((4096, 6), np.int32))
    for name, run in (
            ("speculative", lambda: tg.generate_speculative(
                port, ids, mask, max_new_tokens=4, draft_tokens=3, draft_ngram=2, temperature=1.0,
                generator=torch.Generator().manual_seed(42))),
            ("plain control", lambda: tg.generate(port, ids, mask, max_new_tokens=4, temperature=1.0,
                                                  generator=torch.Generator().manual_seed(43)))):
        _check_marginals(name, run().numpy()[:, 6:], exact, 13)


def test_draft_model_sampling_marginals_exact():
    """tests/test_speculative.py:387: with a different draft model, ratio
    acceptance and residual redraws keep the target's exact marginals."""
    cfg = JConfig(**V13)
    dcfg = JConfig(**{**V13, "d_model": 8, "n_heads": 1, "d_ff": 16})
    params, port = _pair(cfg, seed=3)
    _, dport = _pair(dcfg, seed=11)
    prompt = np.random.default_rng(0).integers(0, 13, (1, 6)).astype(np.int32)
    exact = _marginals(params, cfg, prompt, 2)
    ids, mask = _t(np.tile(prompt, (4096, 1)), np.ones((4096, 6), np.int32))
    toks = tg.generate_speculative_draft(port, dport, ids, mask, max_new_tokens=3, draft_tokens=2, temperature=1.0,
                                         generator=torch.Generator().manual_seed(21)).numpy()[:, 6:]
    _check_marginals("draft", toks, exact, 13)
    control = tg.generate(port, ids, mask, max_new_tokens=3, temperature=1.0,
                          generator=torch.Generator().manual_seed(22)).numpy()[:, 6:]
    _check_marginals("plain control", control, exact, 13)
