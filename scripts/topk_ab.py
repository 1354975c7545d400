"""Times the top-k scans K1 and K2 of one checkout on one GPU, for A/B
runs of two commits in one call.

Run from the root of a checkout, on a machine with one NVIDIA GPU, once
for each tree to compare, alternating (parent, change, change, parent)::

    python3 scripts/topk_ab.py <root of the tree to time>

The tree's kernels are built from its own ``csrc/`` (into its own
gitignored ``csrc/build/``); the 1M x 768 corpus and the queries are drawn
from seed 0, so every tree times the same inputs.  Prints one JSON line:
the tree and each case's mean device time in ms (CUDA events over 20
calls of the public wrapper, after 3 warm-up calls).
"""

from __future__ import annotations

import json
import os
import sys


def ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("usage: python3 scripts/topk_ab.py <tree root> (needs a CUDA device)", file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels as ck
    from vietnamese_qa_system_tpu_torch.ops import quant
    from vietnamese_qa_system_tpu_torch.ops import topk as T

    if not ck.CSRC.startswith(root):
        raise RuntimeError(f"imported the package from {ck.CSRC}, not from {root}")
    ck.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d = 1 << 20, 768
    corpus = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    base = torch.randn(n, d, generator=gen, device="cuda")
    codes, scales = quant.quantize_int8_reference(base)
    del base
    qb = torch.randn(256, d, generator=gen, device="cuda").to(torch.bfloat16)
    qi, _ = T.quantize_queries(torch.randn(256, d, generator=gen, device="cuda"))
    cases = {
        "K1 B256 k10": lambda: T.topk_bf16(qb, corpus, n, 10),
        "K1 B8 k10": lambda: T.topk_bf16(qb[:8], corpus, n, 10),
        "K1 B32 k256": lambda: T.topk_bf16(qb[:32], corpus, n, 256),
        "K2 B256 k10": lambda: T.topk_int8(qi, codes, scales, n, 10),
        "K2 B8 k10": lambda: T.topk_int8(qi[:8], codes, scales, n, 10),
        "K2 B256 k40": lambda: T.topk_int8(qi, codes, scales, n, 40),
    }
    print(json.dumps({"root": sys.argv[1], **{c: ms(torch, f) for c, f in cases.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
