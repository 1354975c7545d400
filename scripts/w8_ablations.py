"""Ablations of the w8 GEMM (kernel K6, ``csrc/w8_matmul.cu``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 scripts/w8_ablations.py [--root DIR] [--variants 0,1,2,3,4]

It compiles copies of ``csrc/w8_matmul.cu`` with one part of the kernel
taken out (``-DW8_ABLATION=n``, into the gitignored
``csrc/build/ablations/``), loads each in place of the built library and
times the kernel at the three PhoGPT-4B shapes (K, N) = (3072, 3072),
(3072, 12288), (12288, 3072) at M 8 (``/qa`` decode), 72 (the engine's
speculative chunk) 128 and 256 (prefills).  The parts:

- ``full``: the kernel as it ships;
- ``stream only`` (1): the TMA loads through the ring and nothing else (no
  conversion, no products, no epilogue): what the weight stream costs;
- ``no conversion`` (2): the raw int8 bytes go into the products in place
  of the converted bf16 values;
- ``no products`` (3): the converted values are folded into the sums by
  one logic op in place of the tensor-core products;
- ``no split-K epilogue`` (4): partial tiles are neither written nor
  summed (whole tiles still write y);
- ``no split-K sum`` (5): the partials are written and their tickets
  posted, but no block waits for them or adds them;
- ``no split-K wait`` (6): the reducers add the partials without waiting
  for their tickets;
- ``no first partial`` (7): a share's first segment writes no partial
  (its ticket is still posted), what the stores in mid-stream cost.

A variant's results are wrong by construction: only its times are read.
Times are device times of CUDA graph replays over weight copies larger
than L2 (as ``chip_smoke.py`` times K6), beside the bf16 matmul on a
pre-dequantized weight and the byte / bf16-operation bound.  ``--root``
times the kernel of another checkout (its package and sources) with this
script.  Prints the card's name and power limit, one line per variant
and shape and, last, one JSON object of the times in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

VARIANTS = {0: "full", 1: "stream only", 2: "no conversion", 3: "no products", 4: "no split-K epilogue",
            5: "no split-K sum", 6: "no split-K wait", 7: "no first partial"}
ROWS = (8, 72, 128, 256)
SHAPES = ((3072, 3072), (3072, 12288), (12288, 3072))
PER_LAYER = {(3072, 3072): 4, (3072, 12288): 1, (12288, 3072): 1}
HBM_BYTES_S, BF16_OPS_S, L2_BYTES = 3.35e12, 989e12, 50 << 20


def build(ck, variants) -> dict[int, str]:
    """Compile every variant (all nvcc processes at once); returns the libraries."""
    out_dir = os.path.join(ck.BUILD_DIR, "ablations")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(ck.CSRC, "w8_matmul.cu")
    libs = {v: os.path.join(out_dir, f"libw8_ablation{v}.so") for v in variants}
    procs = {v: subprocess.Popen([ck._nvcc(), *ck.NVCC_FLAGS, f"-DW8_ABLATION={v}", "-I", ck.CSRC, "-o", libs[v],
                                  src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for v in variants}
    for v, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {v}:\n{err[-3000:]}")
    return libs


def graph_ms(torch, fn, iters: int = 24) -> float:
    """Mean device time of ``fn`` over ``iters`` calls in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose package and kernel source are timed")
    ap.add_argument("--variants", default=",".join(map(str, VARIANTS)), help="comma-separated W8_ABLATION values")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("w8_ablations: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels as ck
    from vietnamese_qa_system_tpu_torch.ops import w8_matmul as W

    variants = [int(v) for v in args.variants.split(",")]
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(power, flush=True)
    print(f"kernel source: {ck.CSRC}", flush=True)
    ck.library()
    libs = build(ck, variants)

    gen = torch.Generator(device="cuda").manual_seed(11)
    weights = {}
    for k, n in SHAPES:
        codes = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        scales = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
        copies = max(2, -(-3 * L2_BYTES // (k * n)))
        weights[(k, n)] = ([codes.clone() for _ in range(copies)], scales)
    xs = {(m, k): torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16) for m in ROWS for k in (3072, 12288)}

    times: dict[str, dict] = {}
    for k, n in SHAPES:  # the yardsticks: the bf16 matmul on a pre-dequantized weight, the bound
        w_bf16 = [(wq.float() * weights[(k, n)][1]).to(torch.bfloat16) for wq in weights[(k, n)][0]]
        for m in ROWS:
            x = xs[(m, k)]
            lib = graph_ms(torch, lambda it=itertools.cycle(w_bf16), x=x: torch.matmul(x, next(it)))
            t_bytes = (m * k * 2 + k * n + n * 4 + m * n * 4) / HBM_BYTES_S * 1e3
            t_ops = 2 * m * k * n / BF16_OPS_S * 1e3
            times.setdefault("library", {})[f"M{m} K{k} N{n}"] = lib
            times.setdefault("bound", {})[f"M{m} K{k} N{n}"] = max(t_bytes, t_ops)
        del w_bf16
    for v in variants:
        name = VARIANTS[v]
        ck._libs = {**ck._libs, "w8_matmul.cu": ctypes.CDLL(libs[v])}
        for kern in ck.KERNELS:
            kern._fn = None
        W.resident_slots.cache_clear()
        row = times.setdefault(name, {})
        for k, n in SHAPES:
            wqs, ws = weights[(k, n)]
            for m in ROWS:
                x = xs[(m, k)]
                row[f"M{m} K{k} N{n}"] = graph_ms(
                    torch, lambda it=itertools.cycle(wqs), x=x, ws=ws: W.w8_matmul(x, next(it), ws,
                                                                                   out_dtype=torch.float32))
        torch.cuda.synchronize()
    for name, row in times.items():
        for m in ROWS:
            layer = sum(PER_LAYER[s] * row[f"M{m} K{s[0]} N{s[1]}"] for s in SHAPES)
            row[f"M{m} layer"] = layer
            shapes = " | ".join(f"K{k} N{n} {row[f'M{m} K{k} N{n}'] * 1e3:.2f} us" for k, n in SHAPES)
            print(f"{name:20s} M {m:3d}: layer {layer:.4f} ms ({shapes})", flush=True)
    print(json.dumps({"device": power, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
