"""w8_roofline: the int8-weight GEMM K6's share (%) of its roofline in the
traced sub-window: the least time of each launch (its int8 weight, scales,
bf16 input and f32 output each moved once, or its operations at the bf16
peak) over the device time of the K6 kernels.  The launches come from
their spans where the host was traced, else from the tally of a
device-only sub-window, against every ``w8_gemm_kernel`` in it."""

from portbench import roofline


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    bound = spent = 0.0
    if tr["launches"].get("w8_matmul"):
        for ints, secs in tr["launches"]["w8_matmul"]:  # M, K, N, padded rows, grid
            bound += roofline.bound_s(*roofline.w8_call(*ints[:3]))
            spent += secs
    else:
        for name, ints in tr.get("tally") or ():
            if name == "w8_matmul":
                bound += roofline.bound_s(*roofline.w8_call(*ints[:3]))
        spent = sum(s for k, s in tr["kernel_s"].items() if k.startswith("w8_gemm_kernel"))
    return roofline.share(bound, spent)
