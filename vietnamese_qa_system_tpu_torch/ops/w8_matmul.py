"""Weight-only int8 matmul (the w8 GEMM) for serving decode: kernel K6.

Counterpart of ``vietnamese_qa_system_tpu/ops/w8_matmul.py``.  On a CUDA
tensor :func:`w8_matmul` runs the hand-written kernel of
``csrc/w8_matmul.cu`` (replaces the Pallas ``_w8_kernel``): the int8 weight
is read at byte rate and converted to bf16 in registers, the products with
the bf16 activations run on the tensor cores and are summed in f32 over
all of K, and the per-output-column scale multiplies once, after the sum.
On a CPU tensor its plain version :func:`w8_matmul_reference` (dequantize,
then an f32 product) runs instead.  The backward is dx only, in plain
PyTorch as it is XLA in the JAX package (w8_matmul.py:158-178):
``dx = (dy * w_s) @ w_q^T``; the frozen int8 codes and their scales get
no gradient.

``supports`` is the gate the dense layers route on (models/layers.py); it
is the JAX package's rule to the letter, because the route decides the
rounding: this kernel folds the scale after the K sum, while the
dequantize route rounds ``w_q * w_s`` to bf16 first.  The TPU's M padding
to 16 rows and its K/N block choice (``_pick_blk_k``) are not carried over.
"""

from __future__ import annotations

import torch

from .cuda_kernels import W8_MATMUL, stream_of

_COLS_PER_BLOCK = 64   # csrc/w8_matmul.cu NT
_ROWS_PER_BLOCK = 16   # csrc/w8_matmul.cu MT
_K_STEP = 128          # kc granularity (csrc/w8_matmul.cu KC_STEP)
_K_CHUNK_MAX = 1024    # csrc/w8_matmul.cu KC_MAX


def supports(m: int, k: int, n: int, max_rows: int = 256) -> bool:
    """True if w8_matmul can run this shape (the dense layers gate on it)."""
    return m <= max_rows and k % 128 == 0 and n % 128 == 0


def w8_matmul_reference(x, w_q, w_s, out_dtype=None):
    """Plain oracle: dequantize, then an f32 product (what the kernel
    replaces)."""
    out_dtype = out_dtype or x.dtype
    w = w_q.float() * w_s.float().reshape(1, -1)
    return (x.float() @ w).to(out_dtype)


def _split_k(m: int, k: int, n: int, device) -> tuple[int, int]:
    """(rows of K per block, number of K splits): enough blocks for about
    two per SM at decode shapes, at most 1024 rows each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = n // _COLS_PER_BLOCK * -(-m // _ROWS_PER_BLOCK)
    want = max(1, -(-2 * sms // tiles))
    rows = -(-k // want)
    kc = min(-(-rows // _K_STEP) * _K_STEP, _K_CHUNK_MAX)
    return kc, -(-k // kc)


class _W8Matmul(torch.autograd.Function):
    """K6 forward; dx = (dy * w_s) @ w_q^T backward (bf16 inputs, f32
    accumulation), no gradient for the frozen codes and scales."""

    @staticmethod
    def forward(ctx, x, w_q, w_s, out_dtype):
        ctx.save_for_backward(w_q, w_s)
        ctx.x_dtype = x.dtype
        return _w8_forward(x, w_q, w_s, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        w_q, w_s = ctx.saved_tensors
        dyf = dy.float() * w_s.float().reshape(1, -1)
        dx = dyf.to(torch.bfloat16).float() @ w_q.to(torch.bfloat16).float().T
        return dx.to(ctx.x_dtype), None, None, None


def w8_matmul(x, w_q, w_s, *, out_dtype=None):
    """``(x @ w_q) * w_s`` with int8 weights streamed at byte rate.

    x (M, K) float (rounded to bf16); w_q (K, N) int8; w_s per-output-
    channel scales of shape (1, N) or (N,).  Returns (M, N) in
    ``out_dtype`` (default: x.dtype).  K and N must be divisible by 128.
    Differentiable in x."""
    return _W8Matmul.apply(x, w_q, w_s, out_dtype or x.dtype)


def _w8_forward(x, w_q, w_s, out_dtype):
    m, kk = x.shape
    n = w_q.shape[1]
    if kk % 128 or n % 128:
        raise ValueError(
            f"w8_matmul needs K/N divisible by 128 (got K={kk}, N={n}); gate calls with ops.w8_matmul.supports()"
        )
    w_s = w_s.float().reshape(n)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return w8_matmul_reference(x.to(torch.bfloat16), w_q, w_s, out_dtype)
    if (w_q.dtype != torch.int8 or w_q.shape[0] != kk or not w_q.is_contiguous() or w_q.device != x.device
            or w_q.data_ptr() % 4):
        raise ValueError(f"w8_matmul needs a contiguous, 4-byte aligned ({kk}, {n}) int8 weight on {x.device}")
    if w_s.device != x.device:
        raise ValueError(f"w8_matmul: scales on {w_s.device}, x on {x.device}")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # the kernel stages x in 16-byte vectors
        xb = xb.clone()
    ws = w_s.contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    kc, splits = _split_k(m, kk, n, x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    W8_MATMUL.launch(
        xb.data_ptr(), w_q.data_ptr(), ws.data_ptr(), m, kk, n, kc, splits,
        None if part is None else part.data_ptr(), y.data_ptr(), stream_of(x),
    )
    return y if out_dtype == torch.float32 else y.to(out_dtype)
