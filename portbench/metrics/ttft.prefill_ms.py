"""ttft.prefill_ms: the mean time (ms) from the pop that gives a request a
slot to its insert done (``engine.prefill``): the host's enqueue of its
prefill, or of its pieces, and of the insert, which blocks while the launch
queue is full.  Over the requests whose first token came in the traced
window; with ``ttft.queue_ms`` and ``ttft.first_ms`` it adds up to their
mean wait from ``submit()`` to the first token."""

from portbench import engine_spans


def read(rec):
    return engine_spans.ttft_part_ms(rec, "engine.prefill")
