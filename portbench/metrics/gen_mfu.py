"""gen_mfu: generation's share (%) of the card's bf16 peak: the dense
products, tied head and attention of every prompt prefilled and every
token decoded in the window (2 x parameters x tokens, plus 4 x layers x
d_model x the keys each token attends), over the window's wall time."""

from portbench import roofline


def read(rec):
    if rec.get("elapsed_s", 0) <= 0 or not rec.get("flops"):
        return None
    return roofline.share(rec["flops"] / roofline.PEAK_BF16, rec["elapsed_s"])
