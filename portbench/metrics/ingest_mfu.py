"""ingest_mfu: the index build's share (%) of the card's bf16 peak: the
encoder's operations on the valid tokens of every chunk indexed, over the
window's wall time."""

from portbench import roofline


def read(rec):
    if rec.get("elapsed_s", 0) <= 0 or "flops" not in rec:
        return None
    return roofline.share(rec["flops"] / roofline.PEAK_BF16, rec["elapsed_s"])
