"""Symmetric int8 quantization (per-row, residual and global scales).

Counterpart of ``vietnamese_qa_system_tpu/ops/quant.py:83-129``.  Codes and
scales are bit-identical to the JAX package: ``x / scale`` in f32, then
``torch.round`` (half to even, like ``jnp.round``), then a clamp to +-127.
The store quantizes with these plain functions, as the JAX store does with
its XLA reference; the Pallas ``_quant_kernel`` is off the serving path and
not ported yet.
"""

from __future__ import annotations

import torch


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as a true division on every device.  PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which is one
    ulp off the JAX package's scales for some values; a 0-d tensor on the
    same device takes the plain division kernel."""
    return x / torch.tensor(127.0, dtype=x.dtype, device=x.device)


def quantize_int8_reference(x: torch.Tensor):
    """(N, D) floats -> (codes (N, D) int8, scales (N,) f32)."""
    x = x.float()
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = div127(absmax.clamp_min(1e-12))
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def quantize_int8_residual(x: torch.Tensor):
    """Two-level residual int8: ``x ~ q1*s1 + q2*s2`` with per-row scales.

    Returns ``(q1, s1, q2, s2)``; the second level quantizes the first
    level's rounding error (backs the ``int8_res`` store dtype)."""
    x = x.float()
    q1, s1 = quantize_int8_reference(x)
    r = x - q1.float() * s1[:, None]
    q2, s2 = quantize_int8_reference(r)
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
