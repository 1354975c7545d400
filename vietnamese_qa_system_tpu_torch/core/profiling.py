"""Timing and memory introspection.

The port's copy of ``vietnamese_qa_system_tpu/core/profiling.py`` (which
imports jax): ``bytes_to_mb``, the ``timeit`` decorator,
``device_memory_stats`` (from ``torch.cuda``'s allocator statistics) and
``MemoryTracker``, a context manager reporting the device's and the
host's memory deltas.
"""

from __future__ import annotations

import functools
import time
import tracemalloc
from typing import Any

import torch


def bytes_to_mb(n: int | float) -> float:
    """Bytes -> MiB, rounded to 2 places."""
    return round(n / (1 << 20), 2)


def timeit(fn):
    """Wall-clock decorator; the last call's duration is the wrapper's
    ``last_seconds``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        wrapper.last_seconds = time.perf_counter() - t0
        return out

    wrapper.last_seconds = 0.0
    return wrapper


def device_memory_stats(device: str | torch.device | None = None) -> dict[str, Any]:
    """The allocator's bytes in use, peak bytes in use and the device's
    total memory, for a CUDA device (default: the current one).
    ``supported`` is False, with zero counters, on the CPU or without a
    GPU: the host has no such statistics."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0, "supported": False}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
        "supported": True,
    }


class MemoryTracker:
    """Context manager reporting memory deltas in MiB: ``used`` / ``peaked``
    for the device (the allocator's peak is reset on entry), ``cpu_used``
    / ``cpu_peaked`` for the host's Python allocations (tracemalloc), and
    ``device_supported`` (False on the CPU)."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = device

    def __enter__(self):
        self._tracing = not tracemalloc.is_tracing()
        if self._tracing:
            tracemalloc.start()
        self._cpu_begin, _ = tracemalloc.get_traced_memory()
        stats = device_memory_stats(self.device)
        if stats["supported"]:
            torch.cuda.reset_peak_memory_stats(self.device)
        self._dev_begin = stats["bytes_in_use"]
        return self

    def __exit__(self, *exc):
        cpu_now, cpu_peak = tracemalloc.get_traced_memory()
        self.cpu_used = bytes_to_mb(cpu_now - self._cpu_begin)
        self.cpu_peaked = bytes_to_mb(cpu_peak - self._cpu_begin)
        stats = device_memory_stats(self.device)
        self.device_supported = stats["supported"]
        self.used = bytes_to_mb(stats["bytes_in_use"] - self._dev_begin)
        self.peaked = bytes_to_mb(max(0, stats["peak_bytes_in_use"] - self._dev_begin))
        if self._tracing:
            tracemalloc.stop()
        return False
