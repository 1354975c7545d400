"""engine.chunk_host_ms.gen_poisson: the mean host time (ms) of one decode
chunk's ``engine.chunk`` span: the enqueue of its steps' operators.  Read
it beside ``chunk_busy_ms``: a full CUDA launch queue blocks the enqueue,
so this is the larger of the host's launch time and the device's time for
the work queued ahead; near ``chunk_busy_ms``, the host's launches pace
the chunk."""

from portbench import engine_spans


def read(rec):
    return engine_spans.mean_ms(rec, "engine.chunk")
