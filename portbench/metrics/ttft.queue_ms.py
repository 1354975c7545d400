"""ttft.queue_ms: the mean time (ms) a request waits in the continuous
engine's queue (``engine.queue``): from ``submit()`` to the pop that gives
it a free slot.  Over the requests whose first token came in the traced
window; with ``ttft.prefill_ms`` and ``ttft.first_ms`` it adds up to their
mean wait from ``submit()`` to the first token."""

from portbench import engine_spans


def read(rec):
    return engine_spans.ttft_part_ms(rec, "engine.queue")
