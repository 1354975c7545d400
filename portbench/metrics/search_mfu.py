"""search_mfu: the whole search's share (%) of the card's bf16 peak: the
encoder's operations on the valid query tokens and the scan's scores over
every corpus row, over the window's wall time."""

from portbench import roofline


def read(rec):
    if rec.get("elapsed_s", 0) <= 0 or "flops" not in rec:
        return None
    return roofline.share(rec["flops"] / roofline.PEAK_BF16, rec["elapsed_s"])
