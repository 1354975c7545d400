"""ttft.first_ms: the mean time (ms) from a request's insert to its first
token handed to the stream (``engine.first``): the decode chunk in flight
and the harvest that reads the first token.  Over the requests whose first
token came in the traced window; with ``ttft.queue_ms`` and
``ttft.prefill_ms`` it adds up to their mean wait from ``submit()`` to the
first token."""

from portbench import engine_spans


def read(rec):
    return engine_spans.ttft_part_ms(rec, "engine.first")
