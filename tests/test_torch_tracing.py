"""The port's span recorder (core/tracing.py) and the continuous engine's
spans on the CPU: the spans share the profiler's clock, record nothing
and change no token with the profiler off, keep their structure (three
gapless parts of a request's first-token wait, parents, sessions), and the
benchmark's readers of them (portbench/metrics) reduce them as they say."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import spec
from vietnamese_qa_system_tpu_torch.core import tracing
from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine
from vietnamese_qa_system_tpu_torch.models.causal_lm import init_causal_lm
from vietnamese_qa_system_tpu_torch.models.config import tiny_test

TIMEOUT = 120
PROMPTS = [[(7 * i + j) % 500 + 3 for j in range(5 + 3 * i)] for i in range(6)]


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return init_causal_lm(tiny_test(), torch.Generator().manual_seed(5))


def session():
    return profile(activities=[ProfilerActivity.CPU])


def serve(model, prompts, *, max_new=6, **kw):
    """Greedy ids of ``prompts`` over 2 slots, with the time.time_ns() of each
    submit() and of each request's first stream callback."""
    eng = ContinuousEngine(model, model.cfg, n_slots=2, total=128, chunk_steps=4, device="cpu", **kw)
    sent, first = [], [None] * len(prompts)

    def on_token(i):
        def cb(_tok):
            if first[i] is None:
                first[i] = time.time_ns()
        return cb

    try:
        futs = []
        for i, p in enumerate(prompts):
            sent.append(time.time_ns())
            futs.append(eng.submit(p, max_new, stream=on_token(i)))
        ids = [f.result(timeout=TIMEOUT)["ids"] for f in futs]
    finally:
        eng.close()
    assert not eng._thread.is_alive()
    return ids, sent, first


def test_span_brackets_the_profiler_events_of_its_block():
    with session() as prof:
        with tracing.span("test.add", rid=7, n=64):
            torch.ones(64) + 1
    (s,) = [x for x in tracing.spans() if x.name == "test.add"]
    events = list(prof.profiler.kineto_results.events())
    (add,) = [e for e in events if e.name() == "aten::add"]
    assert s.t0 <= add.start_ns() and add.end_ns() <= s.t1
    assert s.rid == 7 and s.args == {"n": 64} and s.parent is None and s.thread == threading.get_ident()
    # the span is in the trace too, for Perfetto
    assert any(e.name() == "test.add" for e in events)


def test_no_session_records_nothing_and_changes_no_token(model):
    before = len(tracing._spans)
    assert tracing.span("test.off") is tracing.span("test.off")  # one shared object: nothing allocated
    plain, _, _ = serve(model, PROMPTS[:3])
    assert len(tracing._spans) == before
    with session():
        traced, _, _ = serve(model, PROMPTS[:3])
    assert traced == plain
    assert {s.name for s in tracing.spans()} >= {"engine.queue", "engine.prefill", "engine.first", "engine.chunk"}


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 32, "prefix_cache_mb": 4.0, "speculative": "off"}],
                         ids=["whole", "pieces"])
def test_engine_spans_of_six_requests_over_two_slots(model, kw):
    with session():  # a warm-up session, as the benchmark's tracer runs before its window
        serve(model, PROMPTS[:2], **kw)
    warm = tracing.spans()
    # with pieces: prompts longer than a piece, each the one before it and one token more (prefix-cache hits)
    prompts = PROMPTS if not kw else [[(11 * j) % 500 + 3 for j in range(40 + k)] for k in range(6)]
    with session():
        _, sent, first = serve(model, prompts, **kw)
    got = tracing.spans()
    assert got and not {s.id for s in warm} & {s.id for s in got}
    assert len({s.session for s in got}) == 1 and got[0].session > warm[0].session
    names = {s.id: s.name for s in got}
    by_rid = {}
    for s in got:
        if s.rid is not None:
            by_rid.setdefault(s.rid, []).append(s)
    assert len(by_rid) == 6
    for i, rid in enumerate(sorted(by_rid)):
        parts = {s.name: s for s in by_rid[rid]}
        assert sorted(s.name for s in by_rid[rid]) == ["engine.first", "engine.prefill", "engine.queue"]
        q, p, f = parts["engine.queue"], parts["engine.prefill"], parts["engine.first"]
        assert q.t1 == p.t0 and p.t1 == f.t0  # no gap between the parts
        assert q.args["prompt"] == len(prompts[i]) and p.args["bucket"] >= len(prompts[i])
        assert abs((q.t1 - q.t0) + (p.t1 - p.t0) + (f.t1 - f.t0) - (first[i] - sent[i])) < 1e6
        if not kw:
            assert names[p.parent] == "engine.admit"
    if kw:
        assert max(s.args["reused"] for s in got if s.name == "engine.prefill") > 0
    fetches = [s for s in got if s.name == "engine.fetch"]
    assert fetches and all(names[s.parent] == "engine.harvest" for s in fetches)
    harvests = [s for s in got if s.name == "engine.harvest"]
    assert len(harvests) == len(fetches) and sum(s.args["tokens"] for s in harvests) == 6 * 6
    chunks = [s for s in got if s.name == "engine.chunk"]
    assert chunks and all(s.args["slots"] == 2 and s.args["steps"] == 4 for s in chunks)
    assert {s.args["spec"] for s in chunks} == ({1} if not kw else {0})
    admitted = sum(s.args["admitted"] for s in got if s.name == "engine.admit")
    assert admitted == 6
    # every engine span came from the engine's thread, where the thread-local profiler check is False
    assert {s.thread for s in got} == {got[0].thread} != {threading.get_ident()}


def synthetic(spans):
    """Span tuples from (name, start ms, end ms, rid)."""
    return [tracing.Span(n, int(a * 1e6), int(b * 1e6), 1, i, None, rid, {}, 1)
            for i, (n, a, b, rid) in enumerate(spans)]


READERS = ["ttft.queue_ms", "ttft.prefill_ms", "ttft.first_ms", "engine.chunk_host_ms.gen_closed",
           "engine.chunk_host_ms.gen_poisson", "engine.fetch_ms.gen_closed", "engine.fetch_ms.gen_poisson"]


@pytest.mark.parametrize("name", READERS)
def test_span_readers(name, monkeypatch):
    spans = synthetic([
        # request 0 and 1 whole; request 2 never got its first token in the window
        ("engine.queue", 0, 10, 0), ("engine.prefill", 10, 14, 0), ("engine.first", 14, 44, 0),
        ("engine.queue", 5, 25, 1), ("engine.prefill", 25, 31, 1), ("engine.first", 31, 41, 1),
        ("engine.queue", 40, 90, 2), ("engine.prefill", 90, 95, 2),
        ("engine.chunk", 10, 13, None), ("engine.chunk", 20, 27, None),
        ("engine.harvest", 13, 20, None), ("engine.fetch", 14, 19, None),
        ("engine.harvest", 27, 30, None), ("engine.fetch", 27, 28, None),
        ("engine.wait", 50, 60, None),
    ])
    want = {"ttft.queue_ms": 15.0, "ttft.prefill_ms": 5.0, "ttft.first_ms": 20.0,
            "engine.chunk_host_ms.gen_closed": 5.0, "engine.chunk_host_ms.gen_poisson": 5.0,
            "engine.fetch_ms.gen_closed": 3.0, "engine.fetch_ms.gen_poisson": 3.0}[name]
    read = spec.load_module("metrics", name).read
    rec = {"trace": {"window_s": 1.0}}
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    assert read(rec) == pytest.approx(want)
    assert read({"trace": None}) is None  # no traced window
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert read(rec) is None
    monkeypatch.delattr(tracing, "spans")  # a program without the recorder
    assert read(rec) is None
