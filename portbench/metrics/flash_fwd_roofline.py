"""flash_fwd_roofline: the flash-attention forward K4's share (%) of its
roofline over the traced ingest calls: the least time of each launch
(valid queries against valid keys at the bf16 peak, or its bytes) over the
device time of what the launches ran.  The valid lengths are the traced
calls' chunks', in launch order: one encoder layer a launch, the blocks of
a call in turn."""

from portbench import roofline


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("traced_block_lens"):
        return None
    launches = tr["launches"].get("flash_attention_fwd", [])
    layers = len(launches) // len(rec["traced_block_lens"]) if launches else 0
    if not launches or layers * len(rec["traced_block_lens"]) != len(launches):
        return None
    bound = spent = 0.0
    for n, (ints, secs) in enumerate(launches):
        # bias_rows, BH, heads, Tq, Tk, head dim, causal, window
        bias_rows, _, heads, tq, tk, hd = ints[:6]
        lens = rec["traced_block_lens"][n // layers]
        bound += roofline.bound_s(*roofline.flash_fwd_call(lens, heads, hd, tq, tk, bias_rows))
        spent += secs
    return roofline.share(bound, spent)
