"""The port's continuous-batching engine against the JAX package's:
``models/decode_engine.py`` function for function, for four causal
families (GPT-2's learned positions, llama's RoPE with grouped-query
attention, MPT's ALiBi as PhoGPT lays it out, GPT-Neo's local window),
through a slot run to the cache end and n-gram speculation; then the
sampler's marginals, validation, ``/generate`` over HTTP and ``serve
--continuous-slots``.  ``engine/continuous.py`` engine against engine is in
test_torch_continuous_engines.py, which shares this module's fixtures.

Weights are carried from the JAX pytree by ``causal_from_jax``.  Greedy
streams are compared by the margin rule of test_torch_generate.py: tokens
must agree until the first step whose top-2 logit margin on the JAX stream
(teacher-forced) is below MARGIN_TOL.  The decode-state fields (tokens,
cursors, positions, masks, flags, emitted counts) must be equal exactly;
the caches within CACHE_TOL.  Every engine is closed by a fixture and
every wait has a timeout, so a hung scheduler fails one test.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.engine.continuous import ContinuousEngine as JEngine
from vietnamese_qa_system_tpu.engine.continuous import _validate_sampling as j_validate
from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import decode_engine as jde
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine, ServingApp, make_server
from vietnamese_qa_system_tpu_torch.engine.continuous import _validate_sampling
from vietnamese_qa_system_tpu_torch.models import LoraConfig, ModelConfig, causal_from_jax, init_lora
from vietnamese_qa_system_tpu_torch.models import decode_engine as tde

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN_TOL = 2e-2  # test_torch_generate.py's logit tolerance
CACHE_TOL = 1e-2  # bf16 K/V: the projections sum in another order than XLA's (|k| ~ 1, a bf16 ulp ~ 4e-3)
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
    """family -> (JAX params, JAX config, the port's model), built once."""
    cache = {}

    def get(family):
        if family not in cache:
            cfg = FAMILIES[family]
            params = jlm.init_causal_lm(jax.random.key(3), cfg)
            port = causal_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_dict(dataclasses.asdict(cfg)),
                                   device="cpu")
            cache[family] = (params, cfg, port)
        return cache[family]

    return get


@pytest.fixture
def engines():
    """Builds JAX (``jax=True``) and port engines over ``models``; closes
    every one at the end of the test."""
    made = []

    def make(model, jax_side=False, **kw):
        if jax_side:
            eng = JEngine(model[0], model[1], **kw)
        else:
            eng = ContinuousEngine(model[2], model[2].cfg, device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def _prompt(rng, n):
    return [int(x) for x in rng.integers(4, 90, (n,))]


def _margins(params, cfg, prompt, stream, kv_dtype="bf16"):
    """Top-2 logit margin of the JAX model at each step of ``stream``,
    teacher-forced through a KV cache of ``kv_dtype`` (the engine's layout:
    the prompt at slots 0..n-1)."""
    seq = list(prompt) + list(stream[:-1])
    n = len(seq)
    cache = jg._make_cache(cfg, 1, n, cfg.n_layers, kv_dtype=kv_dtype, stacked=jlm.blocks_stacked(params))
    mask = jnp.tril(jnp.ones((1, n, n), jnp.bool_))
    logits, _ = jlm.forward(params, cfg, jnp.asarray([seq], jnp.int32), mask,
                            positions=jnp.arange(n)[None], cache=cache, cache_index=0)
    top2 = jax.lax.top_k(logits[0, len(prompt) - 1:], 2)[0]
    return np.asarray(top2[:, 0] - top2[:, 1])


def assert_margin_rule(got, want, model, prompt, kv_dtype="bf16"):
    """``got`` equals the JAX stream ``want`` until the first step whose
    top-2 margin on the JAX stream is below MARGIN_TOL."""
    if got == want:
        return
    margins = _margins(model[0], model[1], prompt, want, kv_dtype)
    ties = np.nonzero(margins < MARGIN_TOL)[0]
    until = int(ties[0]) if len(ties) else len(want)
    assert got[:until] == want[:until], (got, want, until)
    assert until < len(want), "the streams differ with no near-tie"


# --------------------------------------------------------------- functions


def _jstate_np(state):
    return jax.tree.map(np.asarray, state)


def _layers(jcache):
    """A JAX cache as a list of per-layer dicts (scan-stacked: one leading
    layer axis)."""
    if isinstance(jcache, dict):
        return [{name: leaf[i] for name, leaf in jcache.items()} for i in range(len(jcache["k"]))]
    return jcache


def _assert_state_equal(port, jstate, total):
    for name in ("toks", "cursor", "pos", "key_valid", "done", "last_tok", "active", "temp", "top_k", "top_p",
                 "adapter"):
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(jstate[name]), err_msg=name)
    for layer, jlayer in zip(port["cache"], _layers(jstate["cache"])):
        for name, leaf in layer.items():
            want = np.asarray(jlayer[name]).astype(np.float32)
            got = leaf[:, :total].float().numpy()
            if name in ("k", "v") and leaf.dtype == torch.int8:
                # codes of values within a scale ulp of a rounding edge may step by one
                assert np.abs(got - want).max() <= 1 and (got != want).mean() < 1e-2, name
            else:
                np.testing.assert_allclose(got, want, atol=CACHE_TOL, rtol=CACHE_TOL, err_msg=name)


@pytest.mark.parametrize("family,kv_dtype", [(f, "bf16") for f in FAMILIES] + [("mpt", "int8"), ("llama", "int8")])
def test_decode_functions_match_jax(models, family, kv_dtype):
    """The same state through JAX's and the port's prefill -> insert ->
    decode_chunk -> decode_chunk_spec -> release: equal fields after each.
    total=40 with a 30-token prompt: the plain chunk runs slot 1 to the
    cache end (cursor == total, writes past it dropped) and the spec chunk
    drafts windows across it."""
    model = models(family)
    params, cfg, port = model
    total, n_slots = 40, 3
    jstate = jde.make_decode_state(cfg, n_slots, total, kv_dtype=kv_dtype, stacked=jlm.blocks_stacked(params))
    state = tde.state_from_numpy(_jstate_np(jstate), device="cpu")
    assert state["cache"][0]["k"].shape[1] == total + 1  # the guard column
    _assert_state_equal(state, jstate, total)
    rng = np.random.default_rng(11)
    greedy = (np.zeros(1, np.float32), np.zeros(1, np.int32), np.ones(1, np.float32))
    for slot, (n, width) in enumerate(((7, 16), (30, 32))):
        ids = np.zeros((1, width), np.int32)
        ids[0, :n] = _prompt(rng, n)
        mask = (np.arange(width) < n)[None].astype(np.int32)
        kv, first, n_prompt = jde.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(0),
                                          *map(jnp.asarray, greedy), kv_dtype=kv_dtype)
        tkv, tfirst, tn = tde.prefill(port, ids, mask, None, *map(torch.from_numpy, greedy), sampled=False,
                                        kv_dtype=kv_dtype)
        assert int(tfirst[0]) == int(first[0]) and int(tn[0]) == int(n_prompt[0])
        jstate = jde.insert(jstate, kv, jnp.asarray(ids), jnp.asarray(mask), first, n_prompt, jnp.int32(slot),
                            *map(jnp.asarray, greedy))
        tde.insert(state, tkv, ids, mask, tfirst, tn, slot, *greedy)
        _assert_state_equal(state, _jstate_np(jstate), total)
    jstate, jtoks = jde.decode_chunk(params, jstate, jax.random.key(1), cfg, n_steps=12, eos_id=None)
    toks = tde.decode_chunk(port, state, None, sampled=False, n_steps=12, eos_id=None)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    _assert_state_equal(state, _jstate_np(jstate), total)
    assert bool(state["done"][1]) and int(state["cursor"][1]) == total  # ran to the cache end
    jstate, jvals, jcounts = jde.decode_chunk_spec(params, jstate, cfg, n_steps=3, eos_id=None, gamma=4, ngram=2)
    vals, counts = tde.decode_chunk_spec(port, state, n_steps=3, eos_id=None, gamma=4, ngram=2)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    live = np.arange(5)[None, None, :] < np.asarray(jcounts)[:, :, None]
    np.testing.assert_array_equal(np.where(live, vals.numpy(), 0), np.where(live, np.asarray(jvals), 0))
    _assert_state_equal(state, _jstate_np(jstate), total)
    jstate = jde.release(jstate, jnp.int32(0))
    tde.release(state, 0)
    _assert_state_equal(state, _jstate_np(jstate), total)


def test_prefill_extend_and_crop_match_jax(models):
    """A prefix KV extended by a suffix at its own cursor, then cropped to a
    bucket: equal first token and lengths, caches within CACHE_TOL."""
    params, cfg, port = models("mpt")
    rng = np.random.default_rng(5)
    toks = _prompt(rng, 27)
    head = np.zeros((1, 16), np.int32)
    head[0, :12] = toks[:12]
    hmask = (np.arange(16) < 12)[None].astype(np.int32)
    sfx = np.zeros((1, 16), np.int32)
    sfx[0, :15] = toks[12:]
    smask = (np.arange(16) < 15)[None].astype(np.int32)
    greedy = (np.zeros(1, np.float32), np.zeros(1, np.int32), np.ones(1, np.float32))
    jkv, _, _ = jde.prefill(params, cfg, jnp.asarray(head), jnp.asarray(hmask), jax.random.key(0),
                            *map(jnp.asarray, greedy))
    jkv2, jfirst, jn = jde.prefill_extend(params, cfg, jkv, jnp.asarray([12], jnp.int32), jnp.asarray(sfx),
                                          jnp.asarray(smask), jax.random.key(0), *map(jnp.asarray, greedy))
    tkv, _, _ = tde.prefill(port, head, hmask, None, *map(torch.from_numpy, greedy), sampled=False)
    tkv2, tfirst, tn = tde.prefill_extend(port, tkv, [12], sfx, smask, None, *greedy, sampled=False)
    assert int(tfirst[0]) == int(jfirst[0]) and int(tn[0]) == int(jn[0]) == 27
    for width in (32, 40):
        got, want = tde.crop_kv(tkv2, width), jde.crop_kv(jkv2, width=width)
        for layer, jlayer in zip(got, _layers(want)):
            for name in layer:
                assert layer[name].shape[1] == width
                np.testing.assert_allclose(layer[name].float().numpy(), np.asarray(jlayer[name]).astype(np.float32),
                                           atol=CACHE_TOL, rtol=CACHE_TOL)


def test_spec_chunk_runs_to_the_cache_end(models):
    """A fault of the JAX package: its speculative chunk marks a slot done
    when its cursor reaches total - 1 (decode_engine.py:585), one emission
    before the plain chunk does, so its engine waits forever for a request
    budgeted to the cache end.  At gamma 0 (one token a step) the port's
    speculative chunk emits exactly the plain chunk's tokens, to cursor ==
    total; JAX's stops one short."""
    params, cfg, port = models("gpt2")
    total = 24
    ids = np.zeros((1, 16), np.int32)
    ids[0, :14] = _prompt(np.random.default_rng(1), 14)
    mask = (np.arange(16) < 14)[None].astype(np.int32)
    greedy = (np.zeros(1, np.float32), np.zeros(1, np.int32), np.ones(1, np.float32))
    kv, first, n = jde.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(0),
                               *map(jnp.asarray, greedy))
    tkv, tfirst, tn = tde.prefill(port, ids, mask, None, *greedy, sampled=False)

    def jax_state():
        return jde.insert(jde.make_decode_state(cfg, 1, total), kv, jnp.asarray(ids), jnp.asarray(mask), first, n,
                          jnp.int32(0), *map(jnp.asarray, greedy))

    def port_state():
        st = tde.make_decode_state(port.cfg, 1, total, device="cpu")
        tde.insert(st, tkv, ids, mask, tfirst, tn, 0, *greedy)
        return st

    jplain, jtoks = jde.decode_chunk(params, jax_state(), jax.random.key(1), cfg, n_steps=12)
    jspec, _, jcounts = jde.decode_chunk_spec(params, jax_state(), cfg, n_steps=12, gamma=0, ngram=2)
    assert int(jplain["cursor"][0]) == total and int(np.asarray(jcounts).sum()) == total - 14 - 1  # the fault
    st = port_state()
    toks = tde.decode_chunk(port, st, None, sampled=False, n_steps=12)
    assert int(st["cursor"][0]) == total and toks[0, : total - 14].tolist() == np.asarray(jtoks)[0, : total - 14].tolist()
    st = port_state()
    vals, counts = tde.decode_chunk_spec(port, st, n_steps=12, gamma=0, ngram=2)
    assert int(st["cursor"][0]) == total and bool(st["done"][0])
    assert counts[0].tolist() == [1] * (total - 14) + [0] * (12 - total + 14)
    assert vals[0, : total - 14, 0].tolist() == toks[0, : total - 14].tolist()


# ------------------------------------------------------ sampling, validation


@pytest.mark.parametrize("args", [(-1.0, 0, 1.0), (0.5, 100000, 1.0), (0.5, 0, 0.0), (0.5, 0, 1.5), (True, 0, 1.0),
                                  (0.5, True, 1.0), (0.5, 1.5, 1.0), ("0.5", 0, 1.0), (0.5, 0, None),
                                  (0.0, 0, 1.0), (1, 64, 0.5), (0.7, 0, 1)])
def test_validate_sampling_matches_jax(args):
    try:
        j_validate(*args)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).split(" must")[0]):
            _validate_sampling(*args)
    else:
        _validate_sampling(*args)


def test_engine_validation(models, engines):
    model = models("gpt2")
    params, cfg, port = model
    eng = engines(model, n_slots=1, total=64, buckets=(16,))
    for call, frag in ((lambda: eng.submit([]), "empty"), (lambda: eng.submit(list(range(4, 40))), "largest bucket"),
                       (lambda: eng.submit([5, 6], max_new_tokens=0), "max_new_tokens"),
                       (lambda: eng.submit([5, 6], 4, top_k=100000), "top_k"),
                       (lambda: eng.submit([5, 6], 4, adapter="vi"), "unknown adapter")):
        with pytest.raises(ValueError, match=frag):
            call()
    for kw, frag in ((dict(total=32, buckets=(32,)), "decode room"), (dict(total=512), "max_seq_len"),
                     (dict(buckets=(16, 32), prefill_chunk=24), "prefill_chunk"), (dict(temperature=-0.5), "temperature"),
                     (dict(kv_dtype="fp8"), "kv_dtype"), (dict(speculative="draft"), "speculative")):
        with pytest.raises(ValueError, match=frag):
            ContinuousEngine(port, port.cfg, device="cpu", **{"total": 64, **kw})
    # an adapter bank of two ranks (tests/test_torch_multilora.py holds the served banks)
    ranks = {name: init_lora(torch.Generator().manual_seed(r), port, LoraConfig(r=r)) for name, r in (("a", 4), ("b", 8))}
    with pytest.raises(ValueError, match="shapes differ"):
        ContinuousEngine(port, port.cfg, device="cpu", adapters=ranks)
    with pytest.raises(ValueError, match="causal or seq2seq"):
        ContinuousEngine(port, dataclasses.replace(port.cfg, arch="encoder"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ContinuousEngine(port, port.cfg)  # the default device is the card: no quiet CPU fallback
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit([5, 6])


def _processed(logits, temp, top_k, top_p):
    """The JAX sampler's target distribution (generate._process_logits)."""
    proc = jg._process_logits(jnp.asarray(logits), temperature=temp, top_k=top_k, top_p=top_p)
    return np.asarray(jax.nn.softmax(proc, axis=-1))


@pytest.mark.parametrize("temp,top_k,top_p", [(0.8, 5, 1.0), (1.3, 0, 0.7), (0.6, 12, 0.8), (1.0, 0, 1.0)])
def test_first_token_marginals(models, temp, top_k, top_p):
    """A sampled request's first token (prefill's draw, per-row knobs)
    follows the processed distribution of its logits: Pearson's chi-square
    statistic over 8,000 draws within six of its standard deviations of its
    mean, and no draw outside the support.  A greedy row of the same batch
    takes the argmax."""
    params, cfg, port = models("gpt2")
    n = 8000
    prompt = _prompt(np.random.default_rng(29), 6)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :6] = prompt
    mask = (np.arange(16) < 6)[None].astype(np.int32)
    logits = np.asarray(jlm.forward(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))[0, 5]
    want = _processed(logits[None], temp, top_k, top_p)[0]
    temps = np.full(n + 1, temp, np.float32)
    temps[-1] = 0.0
    gen = torch.Generator().manual_seed(5)
    _, first, _ = tde.prefill(port, np.repeat(ids, n + 1, 0), np.repeat(mask, n + 1, 0), gen,
                              torch.from_numpy(temps), torch.full((n + 1,), top_k, dtype=torch.int32),
                              torch.full((n + 1,), top_p), sampled=True)
    first = first.numpy()
    assert first[-1] == int(np.argmax(logits))
    freq = np.bincount(first[:-1], minlength=cfg.vocab_size) / n
    assert freq[want == 0].sum() == 0
    support = want > 0
    chi2 = float((((freq - want) ** 2)[support] / want[support]).sum() * n)
    dof = int(support.sum()) - 1
    assert chi2 < dof + 6 * (2 * dof) ** 0.5  # six standard deviations of the chi-square statistic


def test_ngram_draft_matches_jax():
    rng = np.random.default_rng(31)
    seq = rng.integers(0, 5, (6, 40)).astype(np.int32)
    cur_end = np.array([40, 12, 3, 25, 39, 7], np.int32)
    pad_start = np.array([0, 0, 0, 4, 2, 0], np.int32)
    from vietnamese_qa_system_tpu_torch.models.generate import _ngram_draft

    for gamma, ngram in ((8, 3), (5, 2), (3, 1)):
        want = np.asarray(jg._ngram_draft(jnp.asarray(seq), jnp.asarray(cur_end), jnp.asarray(pad_start), gamma,
                                          ngram))
        got = _ngram_draft(torch.from_numpy(seq), torch.from_numpy(cur_end), torch.from_numpy(pad_start), gamma, ngram)
        np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- HTTP and CLI


def _post(url, payload, timeout=TIMEOUT):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class _NoRetrieval:
    """Just enough of a Retriever for an app that serves /generate."""

    class store:  # noqa: N801 — an attribute namespace
        size = 0

    def search(self, queries, k):
        return [[] for _ in queries]


@pytest.fixture
def generate_app(models):
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.models import config as tcfg
    from vietnamese_qa_system_tpu_torch.models import init_causal_lm

    tok = ByteTokenizer()
    cfg = dataclasses.replace(tcfg.tiny_test("causal"), vocab_size=tok.vocab_size, d_model=32, n_heads=4, d_ff=64,
                              n_layers=2)
    reader = init_causal_lm(cfg, make_generator(1), quantize="int8c")
    gen = ContinuousEngine(reader, cfg, n_slots=2, total=96, buckets=(32, 64), chunk_steps=4, eos_id=tok.eos_id,
                           default_max_new=16, device="cpu")
    app = ServingApp(_NoRetrieval(), gen=gen, tokenizer=tok, k=3, max_wait_s=0.02)
    httpd = make_server(app, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", app
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()  # closes the engine too
        th.join(timeout=10)
    assert not th.is_alive()


def test_generate_endpoint(generate_app):
    """/generate through ServingApp and make_server, as JAX
    tests/test_server.py:371-460 drives it: concurrency, 400s, health."""
    url, app = generate_app
    out = _post(f"{url}/generate", {"prompt": "xin chào", "max_new_tokens": 8})
    assert 1 <= out["n_new"] <= 8 and len(out["ids"]) == out["n_new"] and isinstance(out["text"], str)
    same = _post(f"{url}/generate", {"prompt": "xin chào", "max_new_tokens": 8, "temperature": 1.5, "top_k": 1})
    assert same["ids"] == out["ids"]
    with ThreadPoolExecutor(max_workers=5) as ex:
        outs = list(ex.map(lambda i: _post(f"{url}/generate", {"prompt": f"câu hỏi số {i}", "max_new_tokens": 6}),
                           range(5)))
    assert all(1 <= o["n_new"] <= 6 for o in outs)
    for payload, frag in (({}, "missing 'prompt'"), ({"prompt": "a", "max_new_tokens": 0}, "max_new_tokens"),
                          ({"prompt": "a", "max_new_tokens": "x"}, "max_new_tokens"),
                          ({"prompt": "y" * 200}, "largest bucket"), ({"prompt": "a", "temperature": -2}, "temperature"),
                          ({"prompt": "a", "top_p": 0}, "top_p"), ({"prompt": "a", "adapter": 3}, "adapter"),
                          ({"prompt": "a", "adapter": "vi"}, "unknown adapter")):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{url}/generate", payload)
        assert err.value.code == 400 and frag in json.loads(err.value.read())["error"]
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
        health = json.loads(resp.read())
    g = health["stats"]["generate"]
    assert health["generate"] is True and g["completed"] == 7 and g["adapters"] == []
    assert g["latency_ms"]["n"] == 7 and g["tokens"] >= 7  # a request refused before queueing is not timed


def test_serve_continuous_slots_cli(tmp_path):
    """``serve --port --reader-size tiny --continuous-slots 2`` on the CPU,
    in a subprocess: /generate answers, /healthz shows the engine, SIGTERM
    closes it."""
    from vietnamese_qa_system_tpu_torch.cli import main as cli

    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": f"tài liệu {i}"}, ensure_ascii=False) for i in range(6)),
                    encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--batch-size", "8",
                "--max-len", "48"]) == 0
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "vietnamese_qa_system_tpu_torch.cli", "serve", "--index", idx,
                             "--db", db, "--device", "cpu", "--port", "0", "--max-len", "48", "--reader-size", "tiny",
                             "--reader-quantize", "int8c", "--continuous-slots", "2", "--gen-total", "256",
                             "--gen-chunk-steps", "4", "--prefix-cache-mb", "4", "--kv-quant", "int8",
                             "--prefill-chunk", "32", "--max-new-tokens", "5"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("serving "):
                break
        assert "/generate" in line
        assert any("/generate: continuous batching, 2 slots x 256 cache, buckets [32, 64, 128]" in x for x in lines)
        url = "http://" + line.split("http://", 1)[1].split(" ", 1)[0]
        out = _post(f"{url}/generate", {"prompt": "xin chào " * 5})  # 50 tokens: two 32-token pieces
        assert out["n_new"] <= 5
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            g = json.loads(resp.read())["stats"]["generate"]
        assert g["completed"] == 1 and g["prefill_pieces"] == 2 and "prefix_cache" in g
    finally:
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, out


def test_engine_modules_import_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'vietnamese_qa_system_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from vietnamese_qa_system_tpu_torch.models import decode_engine, init_causal_lm, tiny_test\n"
        "from vietnamese_qa_system_tpu_torch.engine import continuous\n"
        "m = init_causal_lm(tiny_test('causal'), torch.Generator().manual_seed(0))\n"
        "eng = continuous.ContinuousEngine(m, m.cfg, n_slots=2, total=64, buckets=(16,), device='cpu')\n"
        "print(len(eng.generate_ids([5, 6, 7], 4, timeout=120)))\n"
        "eng.close()\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'vietnamese_qa_system_tpu') "
        "and sys.modules[n] is not None))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:2] == ["4", "[]"]
