"""The port's seq2seq slot engine against the JAX package's:

- ``models/decode_engine.py``'s seq2seq functions against JAX's, function
  for function (prefill, insert at two slots with diverging cursors, two
  greedy chunks, release): tokens by the margin rule, the state's fields
  exact, its self-attention and cross K/V within 1e-2 (bf16 storage of
  projections that sum in another order than XLA's; a bf16 ulp at |k| ~ 1
  is 4e-3), for the native, T5 and mBART families;
- ``ContinuousEngine`` streams against JAX ``generate_seq2seq`` at the
  engine's encoder bucket width, by the margin rule of
  test_torch_seq2seq.py: interleaved requests reusing slots, encoder
  buckets of two widths, eos, a slot run to the decoder cache end, a
  scan-stacked T5 tree, sampled co-riders;
- the engine's refusals (adapters, prefix cache, chunked prefill, int8 KV)
  and ``/generate`` over a seq2seq reader through ``ServingApp``.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seq2seq import V, assert_margin_rule, jax_params, port_cfg, port_model
from vietnamese_qa_system_tpu.models import decode_engine as jde
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.models import t5 as jt5
from vietnamese_qa_system_tpu.models.config import ModelConfig as JConfig
from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine
from vietnamese_qa_system_tpu_torch.models import decode_engine as tde

torch.set_num_threads(2)
TIMEOUT = 180
CACHE_TOL = 1e-2
SMALL = dict(arch="seq2seq", vocab_size=V, d_model=32, n_layers=2, n_decoder_layers=2, d_ff=64, max_seq_len=64)
FAMILIES = {
    "native": JConfig(n_heads=4, **SMALL),
    "t5": JConfig(seq2seq_family="t5", n_heads=2, d_kv=8, mlp_gated=True, tie_embeddings=False,
                  relative_attention_buckets=8, attention_bias=False, **SMALL),
    "bart": JConfig(seq2seq_family="bart", n_heads=4, positional="learned", scale_embedding=True, norm_eps=1e-5,
                    **SMALL),
}


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(family):
        if family not in cache:
            cfg = FAMILIES[family]
            params = jax_params(cfg, seed=7)
            cache[family] = (params, cfg, port_model(params, cfg))
        return cache[family]

    return get


@pytest.fixture
def engines():
    made = []

    def make(model, **kw):
        eng = ContinuousEngine(model, model.cfg, device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def _prompt(rng, n):
    return [int(x) for x in rng.integers(4, V - 8, (n,))]


def _padded(prompt, width):
    ids = np.zeros((1, width), np.int32)
    mask = np.zeros((1, width), np.int32)
    ids[0, : len(prompt)] = prompt
    mask[0, : len(prompt)] = 1
    return ids, mask


def _ref(params, cfg, prompt, bucket, max_new, eos=None):
    """JAX generate_seq2seq greedy at the engine's encoder bucket width,
    cut after the first eos."""
    ids, mask = _padded(prompt, bucket)
    out = np.asarray(jg.generate_seq2seq(params, cfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=max_new,
                                         eos_id=eos, bos_id=0))[0]
    if eos is not None and (out == eos).any():
        out = out[: int(np.argmax(out == eos)) + 1]
    return [int(x) for x in out]


def _assert_stream(got, want, params, cfg, prompt, bucket):
    ids, mask = _padded(prompt, bucket)
    assert len(got) == len(want), (got, want)
    assert_margin_rule(np.asarray([got]), np.asarray([want]), params, cfg, ids, mask)


def _samp():
    return (jnp.asarray([0.0], jnp.float32), jnp.asarray([0], jnp.int32), jnp.asarray([1.0], jnp.float32))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_functions_match_jax(models, family):
    params, cfg, model = models(family)
    rng = np.random.default_rng(11)
    n_slots, total, enc_w = 3, 24, 16
    jstate = jde.make_decode_state_seq2seq(cfg, n_slots, total, enc_w)
    state = tde.make_decode_state_seq2seq(model.cfg, n_slots, total, enc_w, device="cpu")
    gen = torch.Generator().manual_seed(0)
    jtoks, ttoks = [], []
    for slot, (n, width) in enumerate(((6, 8), (13, 16))):
        ids, mask = _padded(_prompt(rng, n), width)
        jckv, jdec, jfirst = jde.prefill_seq2seq(params, cfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(0),
                                                 *_samp())
        ckv, dec, first = tde.prefill_seq2seq(model, ids, mask, gen, [0.0], [0], [1.0], sampled=False)
        assert int(first[0]) == int(jfirst[0])
        if width != enc_w:
            jckv = jde.crop_kv(jckv, width=enc_w)
        full_mask = _padded(ids[0, :n].tolist(), enc_w)[1]
        jstate = jde.insert_seq2seq(jstate, jckv, jnp.asarray(full_mask), jdec, jfirst, jnp.int32(slot), *_samp())
        tde.insert_seq2seq(state, ckv, full_mask, dec, first, slot, [0.0], [0], [1.0])
        jstate, jt = jde.decode_chunk_seq2seq(params, jstate, jax.random.key(1), cfg, n_steps=5)
        jtoks.append(np.asarray(jt))
        ttoks.append(tde.decode_chunk_seq2seq(model, state, gen, sampled=False, n_steps=5).numpy())
    for j, t in zip(jtoks, ttoks):
        assert np.array_equal(j, t), (j, t)
    js = jax.tree.map(np.asarray, jstate)
    for name in ("key_valid", "last_tok", "cursor", "active", "done", "enc_mask"):
        assert np.array_equal(state[name].numpy(), js[name]), name
    assert state["cursor"].tolist() == [11, 6, 0]  # diverging cursors
    for port_layer, jax_layer in zip(state["cache"], js["cache"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(port_layer[name][:, :total].float().numpy(),
                                       jax_layer[name].astype(np.float32), atol=CACHE_TOL, rtol=0)
    for port_layer, jax_layer in zip(state["cross_kv"], js["cross_kv"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(port_layer[name].float().numpy(), jax_layer[name].astype(np.float32),
                                       atol=CACHE_TOL, rtol=0)
    tde.release_seq2seq(state, 1)
    js = jax.tree.map(np.asarray, jde.release_seq2seq(jstate, jnp.int32(1)))
    for name in ("key_valid", "active", "done", "enc_mask"):
        assert np.array_equal(state[name].numpy(), js[name]), name


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_streams_match_generate(models, engines, family):
    params, cfg, model = models(family)
    rng = np.random.default_rng(61)
    prompts = [_prompt(rng, n) for n in (6, 13, 9, 15, 4)]
    eng = engines(model, n_slots=2, total=32, buckets=(16,), chunk_steps=4)
    futs = [eng.submit(p, 14) for p in prompts]
    for p, fut in zip(prompts, futs):
        _assert_stream(fut.result(timeout=TIMEOUT)["ids"], _ref(params, cfg, p, 16, 14), params, cfg, p, 16)
    assert eng.stats["completed"] == 5 and eng.stats["spec_chunks"] == 0


def test_engine_buckets_eos_capacity_and_sampling(models, engines):
    params, cfg, model = models("native")
    rng = np.random.default_rng(67)
    small, big = _prompt(rng, 7), _prompt(rng, 25)
    # the largest encoder bucket may reach the decoder's total
    eng = engines(model, n_slots=2, total=32, buckets=(16, 32), chunk_steps=4)
    for p, bucket in ((small, 16), (big, 32)):
        _assert_stream(eng.generate_ids(p, 10), _ref(params, cfg, p, bucket, 10), params, cfg, p, bucket)
    # a sampled co-rider leaves a greedy stream alone
    f1 = eng.submit(small, 12)
    f2 = eng.submit(big, 12, temperature=1.0)
    _assert_stream(f1.result(timeout=TIMEOUT)["ids"], _ref(params, cfg, small, 16, 12), params, cfg, small, 16)
    assert len(f2.result(timeout=TIMEOUT)["ids"]) == 12
    free = _ref(params, cfg, small, 16, 20)
    eos = free[2]
    eng2 = engines(model, n_slots=1, total=24, buckets=(16,), chunk_steps=4, eos_id=eos)
    assert eng2.generate_ids(small, 20) == _ref(params, cfg, small, 16, 20, eos)
    # BOS and 11 written columns: 12 tokens at most, whatever the budget
    eng3 = engines(model, n_slots=1, total=12, buckets=(8,), chunk_steps=4)
    out = eng3.generate_ids(small[:7], 500)
    assert len(out) == 12
    _assert_stream(out, _ref(params, cfg, small[:7], 8, 12), params, cfg, small[:7], 8)


def test_engine_stacked_t5_tree(engines):
    """A scan-stacked JAX T5 tree, unstacked as it is carried, rides the
    engine; its streams equal JAX generate_seq2seq over the stacked tree."""
    cfg = dataclasses.replace(FAMILIES["t5"], scan_layers=True)
    params = jt5.stack_t5(jax_params(FAMILIES["t5"], seed=9))
    model = port_model(params, cfg)
    eng = engines(model, n_slots=2, total=32, buckets=(16,), chunk_steps=4)
    rng = np.random.default_rng(73)
    for p in (_prompt(rng, 8), _prompt(rng, 12)):
        _assert_stream(eng.generate_ids(p, 10), _ref(params, cfg, p, 16, 10), params, cfg, p, 16)


def test_engine_refusals(models):
    _, _, model = models("native")
    for kw in (dict(prefix_cache_mb=4), dict(prefill_chunk=8), dict(kv_dtype="int8"),
               dict(adapters={"a": {}})):
        with pytest.raises(ValueError, match="does not support"):
            ContinuousEngine(model, model.cfg, n_slots=1, total=16, buckets=(8,), device="cpu", **kw)


class _NoRetrieval:
    class store:  # noqa: N801 — an attribute namespace
        size = 0

    def search(self, queries, k):
        return [[] for _ in queries]


def test_generate_endpoint_over_a_seq2seq_reader():
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.engine import ServingApp, make_server
    from vietnamese_qa_system_tpu_torch.models import init_seq2seq_model
    from vietnamese_qa_system_tpu_torch.models.config import tiny_test

    tok = ByteTokenizer()
    cfg = dataclasses.replace(tiny_test("seq2seq"), vocab_size=tok.vocab_size, d_model=32, n_heads=4, d_ff=64)
    reader = init_seq2seq_model(cfg, make_generator(1), quantize="int8c")
    gen = ContinuousEngine(reader, cfg, n_slots=2, total=32, buckets=(32, 64), chunk_steps=4, eos_id=tok.eos_id,
                           default_max_new=8, device="cpu")
    app = ServingApp(_NoRetrieval(), gen=gen, tokenizer=tok, k=3, max_wait_s=0.02)
    httpd = make_server(app, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
        req = urllib.request.Request(url, data=json.dumps({"prompt": "xin chào " * 5}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            out = json.loads(resp.read())
        assert 1 <= out["n_new"] <= 8 and len(out["ids"]) == out["n_new"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        th.join(timeout=10)
