"""One run of one cell: set-up, the measured window, the traced
sub-window's reduction, the correctness check, the result line.

A driver (``drivers/<name>.py``) defines ``Driver(ctx)`` with:

- ``setup()``: build the program's objects from the seed and warm up
  every shape the cell uses, timing its parts with ``ctx.part(name)``;
- ``window(seconds)``: drive the program for ``seconds``, starting and
  stopping ``ctx.tracer`` around a steady sub-window; returns ``{"metrics":
  {end-to-end name: value}, "attempted", "failed", "record": {...}}``, the
  record being what the per-layer readers read;
- ``release()``: drop the program's state, so the reference has the card;
- ``check()``: the comparison with the plain reference: a list of
  ``(name, value, limit)``, each passing when ``value <= limit``.

Output: earlier stdout lines give the set-up's parts; the last stdout line
is the result; the last stderr lines are the compared numbers beside their
limits.  No result is printed when the card is missing, when a run fails,
or when ``jax``, ``jaxlib``, ``flax`` or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

from portbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "vietnamese_qa_system_tpu")


def cache_env(root: str) -> None:
    """Fixed cache directories inside the checkout, so that only the first
    run of a checkout builds; keep ``transformers`` away from JAX."""
    cache = os.path.join(root, ".pbcache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Ctx:
    def __init__(self, cell: dict, seed: int, trace: bool, dry: bool):
        from portbench.trace import Tracer

        self.workload = cell["workload"]
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = seed
        self.dry = dry
        self.device = "cpu" if dry else "cuda"
        self.tracer = Tracer(trace and not dry)
        self.parts: dict[str, float] = {}
        self.log = log

    def sync(self) -> None:
        if not self.dry:
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.perf_counter()
        yield
        self.sync()
        self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry", action="store_true", help="CPU rehearsal at the files' dry sizes (tests only)")
    args = ap.parse_args(argv)
    cache_env(spec.ROOT)
    cell = spec.cell(args.workload, dry=args.dry)
    seed = args.seed % (1 << 63)

    import torch

    chips = cell["entry"]["chips"]
    if not args.dry and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        log(f"portbench: this cell needs {chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    from portbench import reference
    from portbench.trace import instrument_kernels

    reference.strict_f32()  # the program's own f32 products are f32 too; this is PyTorch's default
    ctx = Ctx(cell, seed, bool(args.trace), args.dry)
    driver = spec.load_module("drivers", ctx.workload["driver"]).Driver(ctx)
    if args.trace and not args.dry:
        instrument_kernels()
    driver.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v:.3f}" for k, v in ctx.parts.items())
    print(f"setup_s {setup_s:.3f} ({parts}; the rest is interpreter start-up and imports)", flush=True)

    ctx.tracer.warm()
    out = driver.window(args.seconds)
    ctx.sync()
    peak = 0 if args.dry else torch.cuda.max_memory_allocated()
    record = out["record"]
    record["setup_s"] = setup_s
    record["trace"] = ctx.tracer.result()
    driver.release()
    gc.collect()
    if not args.dry:
        torch.cuda.empty_cache()
    checks = driver.check()
    checks = [("failed", float(out["failed"]), 0.0)] + list(checks)
    correct = all(v <= lim for _, v, lim in checks)

    if args.trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = spec.load_module("metrics", m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {name: {"value": v, "unit": units[name]} for name, v in out["metrics"].items() if name in units}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device = {"platform": "cpu" if args.dry else "gpu",
              "kind": "cpu" if args.dry else torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device}
    tr = record["trace"]
    if args.trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        print(f"traced: {tr['note']}", flush=True)
    if not args.dry:
        result["card"] = power_limit()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    if args.dry:
        result = {"dry": True, **result}

    bad = forbidden_modules()
    if bad:
        log(f"portbench: forbidden modules loaded: {bad}")
        return 4
    for name, v, lim in checks:
        log(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
