"""The port's int8 KV cache against the JAX package's: ``kv_quantize`` codes
and scales bit for bit, a cached forward at per-row cursors with the scales
folded into the attention, ``generate(kv_dtype="int8")``, and the
continuous engine's int8 streams against the JAX int8 engine's (plain and
speculative chunks, prefix-cache hits), for four causal families.

Greedy streams are held by the margin rule of test_torch_generate.py
(MARGIN_TOL, the JAX stream's top-2 margin teacher-forced through an int8
cache).  The jitted JAX engine computes ``absmax / 127`` as a product with
the reciprocal, so its scales can be an ulp off the eager ``kv_quantize``
that the port matches; that is within the rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.engine.continuous import ContinuousEngine as JEngine
from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.models.layers import kv_dequantize as j_dequantize
from vietnamese_qa_system_tpu.models.layers import kv_quantize as j_quantize
from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine
from vietnamese_qa_system_tpu_torch.models import GenerationConfig, ModelConfig, causal_from_jax, make_cache
from vietnamese_qa_system_tpu_torch.models import decode_engine as tde
from vietnamese_qa_system_tpu_torch.models import generate as tg
from vietnamese_qa_system_tpu_torch.models.layers import kv_dequantize, kv_quantize

torch.set_num_threads(2)
MARGIN_TOL = 2e-2  # test_torch_generate.py's logit tolerance
LOGIT_TOL = 2e-2  # test_torch_causal.py's: bf16-rounded products summed in another order
TIMEOUT = 120
SMALL = dict(vocab_size=97, n_layers=2, max_seq_len=256)
FAMILIES = {
    "gpt2": dataclasses.replace(jc.gpt_125m_class(), d_model=32, n_heads=4, d_ff=64, **SMALL),
    "llama": dataclasses.replace(jc.llama_1b_class(), d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                                 use_flash_attention=False, **SMALL),
    "mpt": dataclasses.replace(jc.phogpt_4b_class(), d_model=48, n_heads=6, d_ff=96, use_flash_attention=False,
                               **SMALL),
    "gptneo": dataclasses.replace(jc.gpt_neo_125m(), d_model=32, n_heads=4, d_ff=64,
                                  attention_layers=("global", "local"), attention_window=6, **SMALL),
}


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(family):
        if family not in cache:
            cfg = FAMILIES[family]
            params = jlm.init_causal_lm(jax.random.key(4), cfg)
            port = causal_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_dict(dataclasses.asdict(cfg)),
                                   device="cpu")
            cache[family] = (params, cfg, port)
        return cache[family]

    return get


@pytest.fixture
def engines():
    made = []

    def make(model, jax_side=False, **kw):
        eng = JEngine(model[0], model[1], **kw) if jax_side else ContinuousEngine(model[2], model[2].cfg,
                                                                                  device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def _prompt(rng, n):
    return [int(x) for x in rng.integers(4, 90, (n,))]


def assert_margin_rule(got, want, model, prompt):
    """``got`` equals the JAX stream ``want`` until the first step whose
    top-2 margin, teacher-forced through an int8 cache, is below MARGIN_TOL."""
    if got == want:
        return
    params, cfg, _ = model
    seq = list(prompt) + list(want[:-1])
    n = len(seq)
    logits, _ = jlm.forward(params, cfg, jnp.asarray([seq], jnp.int32), jnp.tril(jnp.ones((1, n, n), jnp.bool_)),
                            positions=jnp.arange(n)[None], cache_index=0,
                            cache=jg._make_cache(cfg, 1, n, cfg.n_layers, kv_dtype="int8",
                                                 stacked=jlm.blocks_stacked(params)))
    top2 = np.asarray(jax.lax.top_k(logits[0, len(prompt) - 1:], 2)[0])
    ties = np.nonzero(top2[:, 0] - top2[:, 1] < MARGIN_TOL)[0]
    until = int(ties[0]) if len(ties) else len(want)
    assert got[:until] == want[:until], (got, want, until)
    assert until < len(want), "the streams differ with no near-tie"


# ------------------------------------------------------------ kv_quantize


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 4, 16), (2, 33, 2, 64), (1, 5, 6, 8)])
def test_kv_quantize_bit_equal_to_jax(shape, dtype):
    """Codes and scales equal the JAX function's bit for bit over five
    decades of magnitude, all-zero rows and exact halves included; the
    dequantization too."""
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal(shape).astype(np.float32) * np.logspace(-3, 2, shape[1])[None, :, None, None]
    x[:, 1, 0, :3] = (127.0, 2.5, -3.5)  # scale 1: codes at exact halves round to even (2, -4)
    x[:, 0] = 0.0  # a pad column: the scale clamps to KV_SCALE_EPS
    xj = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    codes, scales = kv_quantize(xt)
    jcodes, jscales = j_quantize(xj)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32 and scales.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    np.testing.assert_array_equal(kv_dequantize(codes, scales).numpy(), np.asarray(j_dequantize(jcodes, jscales)))
    err = (kv_dequantize(codes, scales) - xt.float()).abs()
    # half a scale, and the f32 rounding of x / s (< 2^-17 of a code at |x / s| <= 127)
    assert bool((err <= scales * (0.5 + 2.0 ** -16)).all()) and int(codes[:, 0].abs().max()) == 0
    assert codes[:, 1, 0, 1:3].tolist() == [[2, -4]] * shape[0]


def test_jitted_jax_kv_quantize_rounds_by_the_reciprocal():
    """What the engines' jitted JAX code computes: XLA turns ``absmax / 127``
    into a product with the reciprocal, one ulp off the eager function (and
    the port) for some rows.  Held here so a change on either side shows."""
    x = np.random.default_rng(0).standard_normal((4, 300, 4, 8)).astype(np.float32) * 3
    _, eager = j_quantize(jnp.asarray(x))
    _, jitted = jax.jit(j_quantize)(jnp.asarray(x))
    _, port = kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(port.numpy(), np.asarray(eager))
    off = np.asarray(jitted) != np.asarray(eager)
    assert 0 < off.mean() < 0.2
    assert np.abs(np.asarray(jitted)[off] - np.asarray(eager)[off]).max() <= np.spacing(np.asarray(eager)[off]).max()


# ------------------------------------------------ cached forward, generate


@pytest.mark.parametrize("family", list(FAMILIES))
def test_int8_cache_forward_at_row_cursors_matches_jax(models, family):
    """A prompt prefilled into an int8 cache, then a 3-token window per row
    at per-row cursors (one row's window running past the cache end: JAX
    drops those writes, the port sends them to the guard column): logits
    within LOGIT_TOL, the written codes and scales equal."""
    params, cfg, port = models(family)
    b, t, length = 3, 3, 24
    rng = np.random.default_rng(7)
    ids = rng.integers(4, 90, (b, 16)).astype(np.int32)
    cursor = np.array([16, 9, 22], np.int32)
    jcache = jg._make_cache(cfg, b, length, cfg.n_layers, kv_dtype="int8", stacked=jlm.blocks_stacked(params))
    cache = make_cache(port.cfg, b, length + 1, "cpu", "int8")
    j = np.arange(length)
    pmask = (j[None, None, :] <= np.arange(16)[None, :, None]) & (j[None, None, :] < 16)
    pos = np.broadcast_to(np.arange(16)[None], (b, 16))
    _, jcache = jlm.forward(params, cfg, jnp.asarray(ids), jnp.asarray(pmask), positions=jnp.asarray(pos),
                            cache=jcache, cache_index=0)
    with torch.inference_mode():
        port(torch.from_numpy(ids).long(), torch.from_numpy(pmask), positions=torch.from_numpy(pos.copy()).long(),
             cache=cache, cache_index=0)
    win = rng.integers(4, 90, (b, t)).astype(np.int32)
    qpos = np.minimum(cursor[:, None] + np.arange(t), length - 1)
    wmask = (j[None, None, :] <= qpos[:, :, None]) & ((j[None, None, :] < 16) | (j[None, None, :] >= cursor[:, None, None]))
    jlog, jcache = jlm.forward(params, cfg, jnp.asarray(win), jnp.asarray(wmask), positions=jnp.asarray(qpos),
                               cache=jcache, cache_index=jnp.asarray(cursor))
    with torch.inference_mode():
        log = port(torch.from_numpy(win).long(), torch.from_numpy(wmask), positions=torch.from_numpy(qpos).long(),
                   cache=cache, cache_index=torch.from_numpy(cursor))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for layer, jlayer in zip(cache, jcache if isinstance(jcache, list) else
                             [{k: v[i] for k, v in jcache.items()} for i in range(cfg.n_layers)]):
        for name in ("k", "v", "k_s", "v_s"):
            got, want = layer[name][:, :length].float().numpy(), np.asarray(jlayer[name]).astype(np.float32)
            if name in ("k", "v"):
                assert np.abs(got - want).max() <= 1 and (got != want).mean() < 1e-2, name
            else:
                np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generate_int8_matches_jax(models, family):
    """``generate(kv_dtype="int8")`` on left-padded prompts, greedy, by the
    margin rule per row; ``generate_with_config`` takes the same route."""
    model = models(family)
    params, cfg, port = model
    rng = np.random.default_rng(9)
    ids = rng.integers(4, 90, (3, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :5] = 0
    ids = ids * mask
    want = np.asarray(jg.generate(params, cfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=10,
                                  kv_dtype="int8"))[:, 12:]
    got = tg.generate(port, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=10, kv_dtype="int8")
    same = tg.generate_with_config(port, torch.from_numpy(ids), torch.from_numpy(mask),
                                   GenerationConfig(max_new_tokens=10, kv_dtype="int8"))
    assert torch.equal(got, same)
    for r in range(3):
        prompt = [int(x) for x, m in zip(ids[r], mask[r]) if m]
        assert_margin_rule(got[r, 12:].tolist(), want[r].tolist(), model, prompt)


def test_int8_with_beams_or_speculation_is_refused_as_in_jax(models):
    _, _, port = models("gpt2")
    args = (port, torch.ones((1, 4), dtype=torch.int32), torch.ones((1, 4), dtype=torch.int32))
    for gen in (GenerationConfig(kv_dtype="int8", num_beams=2), GenerationConfig(kv_dtype="int8", speculative="ngram")):
        with pytest.raises(ValueError, match="kv_dtype='int8'"):
            tg.generate_with_config(*args, gen)


# ---------------------------------------------------------------- engines


@pytest.mark.parametrize("family", list(FAMILIES))
def test_int8_engine_matches_jax_int8_engine(models, engines, family):
    """Interleaved requests through two int8 slots (slot reuse): the port's
    plain and speculative int8 engines against the JAX int8 engine."""
    model = models(family)
    rng = np.random.default_rng(11)
    prompts = [_prompt(rng, n) for n in (6, 12, 15, 9, 20)]
    budgets = [18, 10, 14, 18, 12]
    kw = dict(n_slots=2, total=64, buckets=(16, 32), chunk_steps=4, kv_dtype="int8")
    jeng = engines(model, jax_side=True, **kw, speculative="off")
    want = [f.result(timeout=TIMEOUT)["ids"] for f in [jeng.submit(p, m) for p, m in zip(prompts, budgets)]]
    for spec in ("off", "ngram"):
        eng = engines(model, **kw, speculative=spec, draft_tokens=4, draft_ngram=2, spec_steps=2)
        got = [f.result(timeout=TIMEOUT)["ids"] for f in [eng.submit(p, m) for p, m in zip(prompts, budgets)]]
        for p, g, w in zip(prompts, got, want):
            assert_margin_rule(g, w, model, p)
        assert eng._state["cache"][0]["k"].dtype == torch.int8


def test_int8_prefix_cache_hits_match_cold(models, engines):
    """Stored int8 codes are reused by a hit: the hit's stream equals the
    cold int8 engine's and the JAX int8 prefix-cached engine's."""
    model = models("mpt")
    rng = np.random.default_rng(19)
    prefix = _prompt(rng, 20)
    prompts = [prefix, prefix + _prompt(rng, 9)]
    kw = dict(n_slots=2, total=96, buckets=(32, 48), chunk_steps=4, kv_dtype="int8")
    jeng = engines(model, jax_side=True, **kw, prefix_cache_mb=8, min_cached_prompt=8)
    want = [jeng.generate_ids(p, 12) for p in prompts]
    eng = engines(model, **kw, prefix_cache_mb=8, min_cached_prompt=8)
    got = [eng.generate_ids(p, 12) for p in prompts]
    cold = engines(model, **kw)
    assert eng.snapshot_stats()["prefix_hits"] == jeng.snapshot_stats()["prefix_hits"] == 1
    for p, g, w in zip(prompts, got, want):
        assert g == cold.generate_ids(p, 12)
        assert_margin_rule(g, w, model, p)


def test_int8_state_bytes():
    """The int8 state's cache is int8 codes plus f32 scales per (token,
    head): (1 + 4 / head_dim) / 2 of the bf16 state's bytes."""
    cfg = ModelConfig.from_dict(dataclasses.asdict(FAMILIES["mpt"]))

    def nbytes(kv_dtype):
        st = tde.make_decode_state(cfg, 4, 128, kv_dtype=kv_dtype, device="cpu")
        return sum(leaf.numel() * leaf.element_size() for layer in st["cache"] for leaf in layer.values())

    assert nbytes("int8") / nbytes("bf16") == pytest.approx((1 + 4 / cfg.head_dim) / 2)
