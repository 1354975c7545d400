"""Symmetric int8 quantization (per-row, residual and global scales).

Counterpart of ``vietnamese_qa_system_tpu/ops/quant.py``.  Codes and scales
are bit-identical to the JAX package: ``x / scale`` in f32, then
``torch.round`` (half to even, like ``jnp.round``), then a clamp to +-127.

:func:`quantize_int8` is kernel K8: on a CUDA tensor it runs the
hand-written kernel of ``csrc/quant.cu`` (replaces the Pallas
``_quant_kernel``), on a CPU tensor its plain version
:func:`quantize_int8_reference`.  The int8 and int8_res adds of the stores
quantize through it.  The TPU's ``tile_rows`` and ``interpret`` knobs are
not carried over.
"""

from __future__ import annotations

import torch

from .cuda_kernels import QUANT_INT8, on_card, stream_of


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as a true division on every device.  PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which is one
    ulp off the JAX package's scales for some values; a 0-d tensor on the
    same device takes the plain division kernel.  ``torch.full`` makes it
    on the device (``torch.tensor`` would copy it from the host and wait
    for the device: a synchronisation in every decode step of an int8 KV
    cache)."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def quantize_int8_reference(x: torch.Tensor):
    """(N, D) floats -> (codes (N, D) int8, scales (N,) f32)."""
    x = x.float()
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = div127(absmax.clamp_min(1e-12))
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def quantize_int8(x: torch.Tensor):
    """K8: (N, D) f32 or bf16 -> (codes (N, D) int8, scales (N,) f32), per-row
    absmax scales; bit-identical to :func:`quantize_int8_reference` for
    finite inputs."""
    if x.ndim != 2:
        raise ValueError(f"quantize_int8 expects (N, D), got {tuple(x.shape)}")
    if not on_card(x):
        return quantize_int8_reference(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty(n, dtype=torch.float32, device=x.device)
    if n and d:
        QUANT_INT8.launch(x.data_ptr(), int(x.dtype == torch.bfloat16), n, d, q.data_ptr(), scales.data_ptr(),
                          stream_of(x), device=x.device)
    return q, scales


def quantize_int8_residual(x: torch.Tensor):
    """Two-level residual int8: ``x ~ q1*s1 + q2*s2`` with per-row scales.

    Returns ``(q1, s1, q2, s2)``; the second level quantizes the first
    level's rounding error (backs the ``int8_res`` store dtype).  Both
    levels go through :func:`quantize_int8`."""
    x = x.float()
    q1, s1 = quantize_int8(x)
    r = x - q1.float() * s1[:, None]
    q2, s2 = quantize_int8(r)
    return q1, s1, q2, s2


def quantize_int8_global(x: torch.Tensor):
    """One scalar scale for the whole matrix: ``(codes int8, scale () f32)``."""
    x = x.float()
    scale = div127(x.abs().amax().clamp_min(1e-12))
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, dtype=torch.float32):
    """Inverse of :func:`quantize_int8_reference`."""
    return q.to(dtype) * scales.reshape(-1, 1).to(dtype)
