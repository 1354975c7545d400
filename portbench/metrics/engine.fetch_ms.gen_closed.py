"""engine.fetch_ms.gen_closed: the mean time (ms) a harvest waits for its
chunk's tokens to reach the host (``engine.fetch`` inside
``engine.harvest``): the host waiting on the device.  Near 0, the device
finished the chunk before the host asked for it, so the device waits on
the host."""

from portbench import engine_spans


def read(rec):
    return engine_spans.mean_ms(rec, "engine.fetch", per="engine.harvest")
