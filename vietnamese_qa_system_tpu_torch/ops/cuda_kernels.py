"""The port's hand-written CUDA kernels: build, load and launch.

Each source file in ``csrc/`` that a :class:`Kernel` names is compiled by
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, loaded through ``ctypes``; the ``nvcc`` processes of all files
run at once.  The build runs at first
use, from the sources in the checkout only, into ``csrc/build/`` under
names keyed on a hash of each source, the shared headers (``*.cuh``) and
the flags, so an edited kernel is never served from a stale library.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use and need the CUDA toolkit")


def _lib_path(file: str) -> str:
    """The library of ``file``, keyed on the flags, the source and every
    header in ``csrc/`` (a header edit rebuilds the sources)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [file] + sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvqa_{file[:-3]}_{h.hexdigest()[:16]}.so")


def build() -> dict[str, str]:
    """Compile the kernel libraries that are not built yet, one ``nvcc``
    per source file, all started together; returns {file: library path}."""
    paths = {k.file: _lib_path(k.file) for k in KERNELS}
    jobs = []
    for file, lib_path in paths.items():
        if os.path.exists(lib_path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, file)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((file, lib_path, tmp, cmd, proc))
    failed = []
    for file, lib_path, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        with open(lib_path[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{file}: nvcc failed ({proc.returncode}):\n{err[-4000:]}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library() -> dict[str, ctypes.CDLL]:
    """The loaded kernel libraries by source file, built on first use."""
    global _libs
    with _lock:
        if _libs is None:
            _libs = {file: ctypes.CDLL(path) for file, path in build().items()}
        return _libs


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of the calling thread's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_card(t: torch.Tensor) -> bool:
    """True: a wrapper launches its kernel on ``t``; False: ``t`` lies on
    the CPU and the plain version runs.  Any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


class Kernel:
    """One hand-written kernel of the port: its C entry point in
    ``csrc/<file>`` and that entry point's argument types, what TPU kernel
    it replaces (``file:line`` of the Pallas kernel, or ``file:first-last``
    of the plain JAX code it takes over where the TPU had no kernel), and
    how often it was launched."""

    def __init__(self, name: str, symbol: str, file: str, argtypes: tuple, replaces: str):
        self.name = name
        self.symbol = symbol
        self.route = "cuda"
        self.file = file
        self.source = f"vietnamese_qa_system_tpu_torch/csrc/{file}"
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fn = None

    def launch(self, *args, device: torch.device | None = None) -> None:
        """Call the entry point with ``args``, under ``device`` (the
        operands' device) as the current CUDA device: the launch goes to
        the context of the card that holds the operands, not to the
        calling thread's current one."""
        if self._fn is None:
            fn = getattr(library()[self.file], self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        if device is None:
            err = self._fn(*args)
        else:
            with torch.cuda.device(device):
                err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        with self._count_lock:
            self.launches += 1


# The cluster scan of K1-K3: element form, q, corpus, scales, B, D,
# valid_n, k, form, cluster CTAs, clusters, pool_s, pool_i, glob, cand_s,
# cand_i, out_s, out_i, what, stream; counted apart by element form and
# route (K1's list and pool forms; K2's and K3's both forms)
_CLUSTER_ARGS = (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P)
TOPK_BF16 = Kernel("matmul_topk_bf16", "vqa_topk_cluster", "topk.cu", _CLUSTER_ARGS,
                   "vietnamese_qa_system_tpu/ops/topk.py:336")
TOPK_BF16_LARGE = Kernel("matmul_topk_bf16_large", "vqa_topk_cluster", "topk.cu", _CLUSTER_ARGS,
                         "vietnamese_qa_system_tpu/ops/topk.py:448")
TOPK_INT8 = Kernel("matmul_topk_int8", "vqa_topk_cluster", "topk.cu", _CLUSTER_ARGS,
                   "vietnamese_qa_system_tpu/ops/topk.py:355")
TOPK_INT8_GLOBAL = Kernel("matmul_topk_int8_global", "vqa_topk_cluster", "topk.cu", _CLUSTER_ARGS,
                          "vietnamese_qa_system_tpu/ops/topk.py:396")
# the tile scan (K1-K3 where no cluster form fits): kind, q, corpus,
# scales, B, D, valid_n, k, splits, cand_s, cand_i, out_s, out_i, stream
_TOPK_ARGS = (_I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P)
TOPK_BF16_SCAN = Kernel("matmul_topk_bf16_scan", "vqa_matmul_topk", "topk.cu", _TOPK_ARGS,
                        "vietnamese_qa_system_tpu/ops/topk.py:448")
TOPK_INT8_SCAN = Kernel("matmul_topk_int8_scan", "vqa_matmul_topk", "topk.cu", _TOPK_ARGS,
                        "vietnamese_qa_system_tpu/ops/topk.py:355")
TOPK_INT8_GLOBAL_SCAN = Kernel("matmul_topk_int8_global_scan", "vqa_matmul_topk", "topk.cu", _TOPK_ARGS,
                               "vietnamese_qa_system_tpu/ops/topk.py:396")
# q, k, v, kv_lens, bias, bias_rows, bh, n_heads, tq, tk, hd, causal, window, o, lse, stream
_FLASH_FWD_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P)
FLASH_FWD = Kernel("flash_attention_fwd", "vqa_flash_fwd", "flash_fwd.cu", _FLASH_FWD_ARGS,
                   "vietnamese_qa_system_tpu/ops/attention.py:51")
# the same kernel in its causal forms (the training path), counted apart
FLASH_FWD_CAUSAL = Kernel("flash_attention_fwd_causal", "vqa_flash_fwd", "flash_fwd.cu", _FLASH_FWD_ARGS,
                          "vietnamese_qa_system_tpu/ops/attention.py:51")
# q, k, v, dout, lse, dd, kv_lens, bias, bias_rows, bh, n_heads, tq, tk, hd,
# causal, window, then the outputs and the stream
_FLASH_BWD_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I)
FLASH_BWD_DKDV = Kernel("flash_attention_bwd_dkdv", "vqa_flash_bwd_dkdv", "flash_bwd.cu",
                        _FLASH_BWD_ARGS + (_P, _P, _P),  # dk, dv, stream
                        "vietnamese_qa_system_tpu/ops/attention.py:410")
FLASH_BWD_DQ = Kernel("flash_attention_bwd_dq", "vqa_flash_bwd_dq", "flash_bwd.cu",
                      _FLASH_BWD_ARGS + (_P, _P),  # dq, stream
                      "vietnamese_qa_system_tpu/ops/attention.py:489")
W8_MATMUL = Kernel(
    "w8_matmul", "vqa_w8_matmul", "w8_matmul.cu",
    # x, w_q, w_s, M, K, N, padded rows, grid, part, tickets, y, stream
    (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "vietnamese_qa_system_tpu/ops/w8_matmul.py:45",
)
IVF_PROBE = Kernel(
    "ivf_probe_scores", "vqa_ivf_probe", "ivf_probe.cu",
    # q, probe_ids, buckets, scales, gids, is_int8, B, P, C, cap, D, out_s, out_g, stream
    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "vietnamese_qa_system_tpu/ops/ivf_probe.py:53",
)
QUANT_INT8 = Kernel(
    "quantize_int8", "vqa_quantize_int8", "quant.cu",
    # x, is_bf16, N, D, q, scales, stream
    (_P, _I, _I, _I, _P, _P, _P),
    "vietnamese_qa_system_tpu/ops/quant.py:30",
)
_L = ctypes.c_longlong
DECODE_ATTN = Kernel(
    "decode_attention", "vqa_decode_attn", "decode_attn.cu",
    # q, k, v, mask, bias, out, part_o, part_ml, B, Tq, H, kvH, hd, n_keys, mask rows, splits, tiles a split,
    # row blocks, block rows, the strides of k (3), v (3), mask (3) and bias (4), scale, stream
    (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I) + (_L,) * 13 + (ctypes.c_float, _P),
    # none: the JAX package's two einsums over the cache
    "vietnamese_qa_system_tpu/models/layers.py:528-553",
)
KERNELS = (TOPK_BF16, TOPK_INT8, TOPK_INT8_GLOBAL, FLASH_FWD, W8_MATMUL, IVF_PROBE, QUANT_INT8, FLASH_FWD_CAUSAL,
           FLASH_BWD_DKDV, FLASH_BWD_DQ, TOPK_BF16_SCAN, TOPK_BF16_LARGE, TOPK_INT8_SCAN, TOPK_INT8_GLOBAL_SCAN,
           DECODE_ATTN)


def query(file: str, symbol: str, *args: int) -> list[int]:
    """Call a kernel library's ``int fn(int..., int* out)`` resource query
    (occupancy, registers, shared memory) on the current device; returns
    ``out``.  Not a launch: no counter moves."""
    out = (ctypes.c_int * 8)()
    fn = getattr(library()[file], symbol)
    fn.argtypes = [_I] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{symbol}{args}: CUDA error {err}")
    return list(out)
