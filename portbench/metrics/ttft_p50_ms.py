"""ttft_p50_ms: the median time (ms) from each request's due time to its
first token, over every request due in the window: the same samples as
``ttft_p90_ms``."""

from portbench import stats


def read(rec):
    ttft = rec.get("ttft_ms")
    return stats.percentile(ttft, 50) if ttft else None
