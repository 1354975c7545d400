"""Profiling, tracing and failure recording.

The port's copy of ``vietnamese_qa_system_tpu/core/tracing.py`` (which
imports jax):

- :func:`trace` (and :func:`start_trace` / :func:`stop_trace`): a
  ``torch.profiler`` trace of the host's operators and, on a GPU, the
  device's kernels, written as a Chrome trace (``trace_*.json``) that
  Perfetto or ``chrome://tracing`` opens;
- :class:`StepTimer`: running steps/s, tokens/s and ETA;
- :func:`roofline`: achieved against peak compute and memory rate, with
  the H100 SXM5's dense bf16 peak and HBM rate as defaults;
- :func:`record_errors`: writes a JSON error file before re-raising, for
  an external supervisor.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
import traceback
from typing import Optional

import torch

# H100 SXM5 (700 W) data sheet: dense bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BW = 3.35e12


def start_trace(log_dir: str = "runs/profile", device: str | torch.device = "cuda"):
    """Start a ``torch.profiler`` trace of the host's operators and, for a
    CUDA ``device``, its kernels; returns the profiler for
    :func:`stop_trace`."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str = "runs/profile") -> str:
    """Stop ``prof`` and write its Chrome trace under ``log_dir``; returns
    the file's path."""
    prof.stop()
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile", device: str | torch.device = "cuda"):
    """Trace the block (see :func:`start_trace`); yields ``log_dir``."""
    prof = start_trace(log_dir, device)
    try:
        yield log_dir
    finally:
        stop_trace(prof, log_dir)


class StepTimer:
    """Running steps/s, tokens/s and ETA."""

    def __init__(self, total_steps: Optional[int] = None):
        self.total = total_steps
        self.start = time.perf_counter()
        self.steps = 0
        self.tokens = 0

    def update(self, n_tokens: int = 0) -> dict:
        self.steps += 1
        self.tokens += n_tokens
        elapsed = time.perf_counter() - self.start
        out = {
            "steps_per_s": self.steps / max(elapsed, 1e-9),
            "tokens_per_s": self.tokens / max(elapsed, 1e-9),
            "elapsed_s": elapsed,
        }
        if self.total:
            remaining = max(self.total - self.steps, 0)
            out["eta_s"] = remaining / max(out["steps_per_s"], 1e-9)
        return out


def roofline(flops: float, bytes_accessed: float, seconds: float, *, peak_flops: float = PEAK_BF16_FLOPS,
             peak_bw: float = PEAK_HBM_BW) -> dict:
    """Achieved against peak compute and bandwidth, and the binding resource."""
    achieved_flops = flops / seconds
    achieved_bw = bytes_accessed / seconds
    intensity = flops / max(bytes_accessed, 1)
    ridge = peak_flops / peak_bw
    bound = "compute" if intensity >= ridge else "memory"
    limit = peak_flops if bound == "compute" else peak_bw * intensity
    return {
        "achieved_tflops": achieved_flops / 1e12,
        "achieved_gbps": achieved_bw / 1e9,
        "flops_utilization": achieved_flops / peak_flops,
        "bw_utilization": achieved_bw / peak_bw,
        "arithmetic_intensity": intensity,
        "bound": bound,
        "fraction_of_roofline": achieved_flops / limit,
    }


ERROR_FILE_ENV = "VQA_TPU_ERROR_FILE"


def record_errors(fn=None, *, error_file: Optional[str] = None):
    """Decorator: on an exception, write {time, type, message, traceback,
    process_index} as JSON to ``$VQA_TPU_ERROR_FILE`` (or ``error_file``)
    and re-raise.  The port runs one process: its index is 0."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            try:
                return f(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 -- record everything
                path = error_file or os.environ.get(ERROR_FILE_ENV)
                if path:
                    try:
                        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                        with open(path, "w") as fh:
                            json.dump({"time": time.time(), "type": type(e).__name__, "message": str(e),
                                       "traceback": traceback.format_exc(), "process_index": 0}, fh, indent=2)
                    except OSError:
                        pass
                raise

        return wrapper

    return deco(fn) if fn is not None else deco
