"""topk_roofline: the fused matmul + top-k kernel K1's share (%) of its
roofline in the traced calls: the least time of each launch (its corpus
bytes read once, or its score operations at the bf16 peak) over the
device time of what the launch ran."""

from portbench import roofline

KERNELS = ("matmul_topk_bf16", "matmul_topk_bf16_large", "matmul_topk_bf16_scan")


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    bound = spent = 0.0
    for name in KERNELS:
        # both forms: element form (or kind), B, D, valid_n, k, ...
        for ints, secs in tr["launches"].get(name, ()):
            bound += roofline.bound_s(*roofline.topk_call(*ints[1:5]))
            spent += secs
    return roofline.share(bound, spent)
