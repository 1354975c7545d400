"""The port's ``ContinuousEngine`` against the JAX package's, engine
against engine on the same prompts and arrivals: slot reuse and a slot run
to ``total`` for four causal families, eos, prefix-cache hits against a cold
run, chunked prefill, n-gram speculation against plain chunks, sampled
co-riders, stream callbacks and a failing chunk.

The families, the tiny models, the engine fixture (every engine closed at
the end of its test) and the margin rule are those of
test_torch_continuous.py, which holds the decode functions one by one.
"""

import threading

import numpy as np
import pytest

from test_torch_continuous import FAMILIES, TIMEOUT, _prompt, assert_margin_rule
from test_torch_continuous import engines, models  # noqa: F401  (fixtures)
from vietnamese_qa_system_tpu_torch.models import decode_engine as tde


def _run(eng, prompts, budgets, **kw):
    futs = [eng.submit(p, m, **kw) for p, m in zip(prompts, budgets)]
    return [f.result(timeout=TIMEOUT)["ids"] for f in futs]


def _interleaved(seed):
    """Six prompts through two slots: queueing and slot reuse; the 30-token
    prompt's budget runs its slot to total=64 (1 + 64 - 30 tokens)."""
    rng = np.random.default_rng(seed)
    prompts = [_prompt(rng, n) for n in (5, 13, 16, 3, 30, 9)]
    return prompts, [8, 20, 5, 16, 60, 20]


ENGINE = dict(n_slots=2, total=64, buckets=(16, 32), chunk_steps=4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_interleaved_streams_match_jax_engine(models, engines, family):
    """Six requests through two slots, all submitted at once: queueing, slot
    reuse and a slot run to ``total``.  The port's plain and speculative
    engines both give the JAX engine's streams.  The JAX side runs plain
    chunks: its speculative engine hangs on the request budgeted to the
    cache end (test_spec_chunk_runs_to_the_cache_end)."""
    model = models(family)
    prompts, budgets = _interleaved(7)
    want = _run(engines(model, jax_side=True, **ENGINE, speculative="off"), prompts, budgets)
    for speculative in ("off", "ngram"):
        eng = engines(model, **ENGINE, speculative=speculative, draft_tokens=5, draft_ngram=2, spec_steps=2)
        got = _run(eng, prompts, budgets)
        for p, g, w in zip(prompts, got, want):
            assert_margin_rule(g, w, model, p)
        assert len(got[4]) == 1 + 64 - 30  # the slot ran to total
        stats = eng.snapshot_stats()
        assert stats["requests"] == stats["completed"] == 6 and stats["prefills"] == 6
        assert stats["active_slots"] == 0 and stats["pending"] == 0
        if speculative == "ngram":
            assert stats["spec_chunks"] == stats["chunks"] > 0 and stats["drafted_accepted"] > 0
        else:
            assert stats["spec_chunks"] == 0


@pytest.mark.parametrize("speculative", ["off", "ngram"])
def test_eos_stops_like_jax(models, engines, speculative):
    """eos taken from the free-running stream, so it is hit mid-chunk (and
    inside a speculative window): the stream stops there, as JAX's does."""
    model = models("mpt")
    prompt = _prompt(np.random.default_rng(3), 10)
    free = engines(model, **ENGINE, speculative="off").generate_ids(prompt, 24)
    eos = free[3]
    kw = dict(ENGINE, eos_id=eos, speculative=speculative, draft_tokens=4, draft_ngram=2, spec_steps=2)
    want = engines(model, jax_side=True, **kw).generate_ids(prompt, 24)
    got = engines(model, **kw).generate_ids(prompt, 24)
    assert_margin_rule(got, want, model, prompt)
    assert got[-1] == eos and len(got) < 24


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefix_cache_hits_match_cold_and_jax(models, engines, family):
    """Chained prefixes and a repeat prompt: the hits reuse stored KV, and
    every stream equals the cold engine's and the JAX prefix-cached one's."""
    model = models(family)
    rng = np.random.default_rng(13)
    base = _prompt(rng, 10)
    prompts = [base, base + _prompt(rng, 8), base + _prompt(rng, 15), base]
    kw = dict(ENGINE, total=96, prefix_cache_mb=64.0, min_cached_prompt=4)
    jeng = engines(model, jax_side=True, **kw)
    want = [jeng.generate_ids(p, 10) for p in prompts]
    eng = engines(model, **kw)
    got = [eng.generate_ids(p, 10) for p in prompts]
    cold = engines(model, **dict(ENGINE, total=96))
    for p, g, w in zip(prompts, got, want):
        assert g == cold.generate_ids(p, 10)
        assert_margin_rule(g, w, model, p)
    s, js = eng.snapshot_stats(), jeng.snapshot_stats()
    assert s["prefix_hits"] == js["prefix_hits"] == 3
    assert s["prefix_tokens_reused"] == js["prefix_tokens_reused"] == 10 + 10 + 9
    assert s["prefix_cache"]["entries"] == 3 and s["prefix_cache"]["mb"] >= 0


def test_prefix_cache_evicts_lru_by_bytes(models, engines):
    """A cache that holds one entry of 16 columns evicts the older prompt."""
    model = models("gpt2")
    one = 2 * 2 * 16 * 4 * 8 * 2  # layers x (k, v) x 16 columns x heads x head dim x bf16 bytes
    eng = engines(model, **ENGINE, prefix_cache_mb=1.5 * one / (1 << 20), min_cached_prompt=4)
    rng = np.random.default_rng(17)
    a, b = _prompt(rng, 12), _prompt(rng, 12)
    eng.generate_ids(a, 4)
    eng.generate_ids(b, 4)
    eng.generate_ids(a + [5], 4)  # a was evicted: cold
    s = eng.snapshot_stats()
    assert s["prefix_hits"] == 0 and s["prefix_cache"]["entries"] == 1


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunked_prefill_matches_jax(models, engines, family):
    """Prompts of 40, 7, 55 and 23 tokens admitted in 16-token pieces: 9
    pieces, streams equal to the JAX chunked engine's, and a prefix-cache
    hit seeding a later chunked chain."""
    model = models(family)
    rng = np.random.default_rng(43)
    prompts = [_prompt(rng, n) for n in (40, 7, 55, 23)]
    kw = dict(ENGINE, total=128, buckets=(16, 32, 64), prefill_chunk=16)
    want = _run(engines(model, jax_side=True, **kw), prompts, [12] * 4)
    eng = engines(model, **kw)
    got = _run(eng, prompts, [12] * 4)
    for p, g, w in zip(prompts, got, want):
        assert_margin_rule(g, w, model, p)
    assert eng.snapshot_stats()["prefill_pieces"] == 9  # 3 + 4 + 2; the 7-token prompt goes whole
    cached = engines(model, **kw, prefix_cache_mb=8, min_cached_prompt=8)
    longer = prompts[0] + _prompt(rng, 20)
    assert cached.generate_ids(prompts[0], 12) == got[0]
    out = cached.generate_ids(longer, 12)
    assert cached.snapshot_stats()["prefix_hits"] == 1
    assert out == engines(model, **dict(ENGINE, total=128, buckets=(16, 32, 64))).generate_ids(longer, 12)


def test_chunked_prefill_interleaves_decode(models, engines):
    """While a long prompt admits piece by piece, the running request keeps
    receiving tokens, and both streams stay those of the plain engine."""
    model = models("gpt2")
    rng = np.random.default_rng(47)
    p_live, p_long = _prompt(rng, 9), _prompt(rng, 60)
    kw = dict(n_slots=2, total=128, buckets=(16, 64), chunk_steps=2, speculative="off")
    ref = engines(model, **kw)
    want_live, want_long = ref.generate_ids(p_live, 40), ref.generate_ids(p_long, 8)
    eng = engines(model, **kw, prefill_chunk=16)
    seen = []
    started = threading.Event()
    f1 = eng.submit(p_live, 40, stream=lambda t: (seen.append(t), started.set()))
    assert started.wait(TIMEOUT)
    n_before = len(seen)
    f2 = eng.submit(p_long, 8)
    assert f2.result(timeout=TIMEOUT)["ids"] == want_long
    assert f1.result(timeout=TIMEOUT)["ids"] == want_live
    assert eng.snapshot_stats()["prefill_pieces"] == 4 and len(want_live) > n_before


def test_sampled_co_rider_keeps_greedy_exact(models, engines):
    """A sampled request sends the batch to plain chunks (spec is greedy
    only); the greedy co-rider still equals its JAX stream, and a sampled
    request at top_k 1 is the greedy stream."""
    model = models("mpt")
    rng = np.random.default_rng(37)
    p_greedy, p_sampled = _prompt(rng, 9), _prompt(rng, 11)
    want = engines(model, jax_side=True, **ENGINE).generate_ids(p_greedy, 16)
    eng = engines(model, **ENGINE, spec_steps=2)
    f1 = eng.submit(p_greedy, 16)
    f2 = eng.submit(p_sampled, 16, temperature=1.0, top_p=0.9)
    assert_margin_rule(f1.result(timeout=TIMEOUT)["ids"], want, model, p_greedy)
    drawn = f2.result(timeout=TIMEOUT)["ids"]
    assert len(drawn) == 16 and all(0 <= t < 97 for t in drawn)
    s = eng.snapshot_stats()
    assert s["chunks"] > s["spec_chunks"]
    assert eng.submit(p_greedy, 16, temperature=2.0, top_k=1).result(timeout=TIMEOUT)["ids"] == \
        eng.generate_ids(p_greedy, 16)


def test_streaming_callbacks_and_a_raising_one(models, engines):
    model = models("gpt2")
    rng = np.random.default_rng(23)
    p1, p2 = _prompt(rng, 8), _prompt(rng, 10)
    eng = engines(model, **ENGINE)
    streamed = []

    def bad(tok):
        raise RuntimeError("client went away")

    f_bad = eng.submit(p1, 12, stream=bad)
    f_ok = eng.submit(p2, 12, stream=streamed.append)
    assert len(f_bad.result(timeout=TIMEOUT)["ids"]) == 12
    assert f_ok.result(timeout=TIMEOUT)["ids"] == streamed


def test_failing_chunk_fails_its_owners_and_the_engine_serves_on(models, engines, monkeypatch):
    model = models("gpt2")
    eng = engines(model, **ENGINE, speculative="off")
    prompt = _prompt(np.random.default_rng(2), 8)
    want = eng.generate_ids(prompt, 6)
    real = tde.decode_chunk

    def broken(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tde, "decode_chunk", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        eng.generate_ids(prompt, 6, timeout=TIMEOUT)
    monkeypatch.setattr(tde, "decode_chunk", real)
    assert eng.generate_ids(prompt, 6, timeout=TIMEOUT) == want
