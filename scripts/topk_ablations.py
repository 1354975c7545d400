"""Ablations of the top-k cluster scan (``csrc/topk.cu``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 scripts/topk_ablations.py

It compiles copies of ``csrc/topk.cu`` with one part of the cluster scan's
selection taken out (``-DABLATION=n``, into the gitignored
``csrc/build/ablations/``), loads each in place of the built library, and
times K1, K2 and K3 at the shapes of PERF.md section 6 (1M x 768 corpus
drawn from a seed).  The parts:

- ``full``: the kernels as they ship;
- ``no selection``: no tile is selected (the stream, the products, the
  flush and the merge remain), what the scan costs with a free selection;
- ``no pool stores``: the pool form appends no entry (its counts still
  grow, so its selects still run), what its global stores cost;
- ``no floors``: no floor is read from the published maxima, the pool form
  and the int8 lists at k > 16 as they would run without it;
- ``K3 in place``: K3 converts its s32 sums to f32 in place after the
  products, as K2's epilogue does (ptxas then serializes the wgmma),
  instead of where each score is read: the other epilogue design.  Its
  results are right; only K3's times differ.

A variant's results are wrong by construction (but for ``K3 in place``):
only its times are read.
Prints the card's name and power limit, one line per variant and, last,
one JSON object of the times in ms.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

VARIANTS = {0: "full", 1: "no selection", 3: "no pool stores", 5: "no floors", 6: "K3 in place"}
# (text in csrc/topk.cu, its replacement): each takes one part out under its ABLATION value
EDITS = (
    ("            if (!active) continue;\n            if constexpr (FORM == LISTS) {",
     "            if (!active) continue;\n            if (ABLATION == 1) continue;\n            if constexpr (FORM == LISTS) {"),
    ("if (m[i] != 0u) {", "if (ABLATION != 3 && m[i] != 0u) {"),
    ("        auto refresh = [&](int r) {\n", "        auto refresh = [&](int r) {\n            if (ABLATION == 5) return;\n"),
    ("constexpr bool RAW_AT_READ = E::EL == EL_S8_RAW;", "constexpr bool RAW_AT_READ = ABLATION != 6 && E::EL == EL_S8_RAW;"),
)


def build(ck) -> dict[int, str]:
    """Compile every variant (all nvcc processes at once); returns the libraries."""
    out_dir = os.path.join(ck.BUILD_DIR, "ablations")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(ck.CSRC, "topk.cu")) as f:
        src = f.read()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/topk.cu changed: the ablation point {old.strip()[:60]!r} is not found once")
        src = src.replace(old, new)
    path = os.path.join(out_dir, "topk_ablation.cu")
    with open(path, "w") as f:
        f.write("#ifndef ABLATION\n#define ABLATION 0\n#endif\n" + src)
    for name in os.listdir(ck.CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(ck.CSRC, name)) as f, open(os.path.join(out_dir, name), "w") as g:
                g.write(f.read())
    libs = {v: os.path.join(out_dir, f"libtopk_ablation{v}.so") for v in VARIANTS}
    procs = {v: subprocess.Popen([ck._nvcc(), *ck.NVCC_FLAGS, f"-DABLATION={v}", "-o", libs[v], path],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for v in VARIANTS}
    for v, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {v}:\n{err[-3000:]}")
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_ablations: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels as ck
    from vietnamese_qa_system_tpu_torch.ops import quant
    from vietnamese_qa_system_tpu_torch.ops import topk as T

    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(power, flush=True)
    ck.library()
    libs = build(ck)

    def ms(fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d = 1 << 20, 768
    corpus = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    base = torch.randn(n, d, generator=gen, device="cuda")
    codes, scales = quant.quantize_int8_reference(base)
    gcodes, _ = quant.quantize_int8_global(base)
    del base
    qb = torch.randn(256, d, generator=gen, device="cuda").to(torch.bfloat16)
    qi, _ = T.quantize_queries(torch.randn(256, d, generator=gen, device="cuda"))
    cases = {
        "K1 B32 k256 (pool form)": lambda: T.topk_bf16(qb[:32], corpus, n, 256),
        "K1 B32 k100 (pool form)": lambda: T.topk_bf16(qb[:32], corpus, n, 100),
        "K1 B256 k256 (pool form)": lambda: T.topk_bf16(qb, corpus, n, 256),
        "K1 B256 k10 (lists)": lambda: T.topk_bf16(qb, corpus, n, 10),
        "K2 B256 k10 (lists)": lambda: T.topk_int8(qi, codes, scales, n, 10),
        "K2 B256 k40 (lists, floor)": lambda: T.topk_int8(qi, codes, scales, n, 40),
        "K2 B256 k256 (pool form)": lambda: T.topk_int8(qi, codes, scales, n, 256),
        "K3 B256 k10 (lists)": lambda: T.topk_int8_global(qi, gcodes, n, 10),
        "K3 B8 k10 (lists)": lambda: T.topk_int8_global(qi[:8], gcodes, n, 10),
        "K3 B256 k40 (lists, floor)": lambda: T.topk_int8_global(qi, gcodes, n, 40),
        "K3 B32 k256 (pool form)": lambda: T.topk_int8_global(qi[:32], gcodes, n, 256),
    }
    times = {}
    for v, name in VARIANTS.items():
        ck._libs = {**ck._libs, "topk.cu": ctypes.CDLL(libs[v])}
        for kern in ck.KERNELS:
            kern._fn = None
        T._cluster_capacity.cache_clear()
        times[name] = {case: ms(fn) for case, fn in cases.items()}
        print(f"{name}: " + " | ".join(f"{c} {t:.4f} ms" for c, t in times[name].items()), flush=True)
    print(json.dumps({"device": power, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
