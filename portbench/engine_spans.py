"""The continuous engine's spans of the traced window, for the per-layer
metrics that read them: ``vietnamese_qa_system_tpu_torch/core/tracing.py``
records them while the profiler runs and ``spans()`` returns those of its
latest session, which is the cell's traced window (the tracer's short
warm-up sessions come before it).  A run without a traced window, or a
program without the span recorder, gives nothing."""

from __future__ import annotations

# a request's wait for its first token, without a gap: submit() -> the pop
# that gives it a slot -> the insert done -> the first token handed on
TTFT_PARTS = ("engine.queue", "engine.prefill", "engine.first")


def window_spans(rec) -> list | None:
    if not rec.get("trace"):
        return None
    from vietnamese_qa_system_tpu_torch.core import tracing

    read = getattr(tracing, "spans", None)
    return read() if read is not None else None


def ttft_part_ms(rec, name: str) -> float | None:
    """The mean duration (ms) of span ``name`` over the requests whose
    first token came in the window: those with all three parts."""
    by_rid: dict = {}
    for s in window_spans(rec) or ():
        if s.name in TTFT_PARTS and s.rid is not None:
            by_rid.setdefault(s.rid, {})[s.name] = s.t1 - s.t0
    done = [parts[name] for parts in by_rid.values() if len(parts) == len(TTFT_PARTS)]
    return sum(done) / len(done) / 1e6 if done else None


def mean_ms(rec, name: str, per: str | None = None) -> float | None:
    """The total duration (ms) of span ``name`` over the number of spans
    ``per`` (by default of ``name`` itself)."""
    spans = window_spans(rec) or ()
    n = sum(1 for s in spans if s.name == (per or name))
    return sum(s.t1 - s.t0 for s in spans if s.name == name) / n / 1e6 if n else None
