"""The port's hand-written CUDA kernels: build, load and launch.

The sources in ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded through ``ctypes``.  The
build runs at first use, from the sources in the checkout only, into
``csrc/build/`` under a name keyed on a hash of the sources and flags, so
an edited kernel is never served from a stale library.  Nothing here runs
at import time: the CPU tests import every module on a machine without
``nvcc``.

Each :class:`Kernel` counts its successful launches, so a run can show that
its main path went through the kernel and not through a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("topk.cu", "flash_fwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # kind, q, corpus, scales, B, D, valid_n, k, splits, cand_s, cand_i,
    # out_s, out_i, stream
    "vqa_matmul_topk": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # q, k, v, kv_lens, bias, bh, n_heads, tq, tk, hd, o, lse, stream
    "vqa_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use and need the CUDA toolkit")


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    paths = [os.path.join(CSRC, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"libvqa_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(lib_path[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of the calling thread's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


class Kernel:
    """One hand-written kernel of the port: where it lives, what TPU kernel
    it replaces, and how often it was launched."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.route = "cuda"
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._count_lock = threading.Lock()

    def launch(self, *args) -> None:
        err = getattr(library(), self.symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        with self._count_lock:
            self.launches += 1


TOPK_BF16 = Kernel(
    "matmul_topk_bf16", "vqa_matmul_topk",
    "vietnamese_qa_system_tpu_torch/csrc/topk.cu",
    "vietnamese_qa_system_tpu/ops/topk.py:336",
)
TOPK_INT8 = Kernel(
    "matmul_topk_int8", "vqa_matmul_topk",
    "vietnamese_qa_system_tpu_torch/csrc/topk.cu",
    "vietnamese_qa_system_tpu/ops/topk.py:355",
)
TOPK_INT8_GLOBAL = Kernel(
    "matmul_topk_int8_global", "vqa_matmul_topk",
    "vietnamese_qa_system_tpu_torch/csrc/topk.cu",
    "vietnamese_qa_system_tpu/ops/topk.py:396",
)
FLASH_FWD = Kernel(
    "flash_attention_fwd", "vqa_flash_fwd",
    "vietnamese_qa_system_tpu_torch/csrc/flash_fwd.cu",
    "vietnamese_qa_system_tpu/ops/attention.py:51",
)
KERNELS = (TOPK_BF16, TOPK_INT8, TOPK_INT8_GLOBAL, FLASH_FWD)
