"""Weight-only int8 matmul (the w8 GEMM) for serving decode: kernel K6.

Counterpart of ``vietnamese_qa_system_tpu/ops/w8_matmul.py``.  On a CUDA
tensor :func:`w8_matmul` runs the hand-written kernel of
``csrc/w8_matmul.cu`` (replaces the Pallas ``_w8_kernel``): the int8 weight
is read at byte rate and converted to bf16 in registers, the products with
the bf16 activations run on the tensor cores and are summed in f32 over
all of K, and the per-output-column scale multiplies once, after the sum.
On a CPU tensor its plain version :func:`w8_matmul_reference` (dequantize,
then an f32 product) runs instead.  One call is one launch: the kernel
splits the weight stream over exactly the card's resident blocks
(:func:`partition`, stream-K) and adds the split-K partials itself.  The
backward is dx only, in plain PyTorch as it is XLA in the JAX package
(w8_matmul.py:158-178): ``dx = (dy * w_s) @ w_q^T``; the frozen int8
codes and their scales get no gradient.

``supports`` is the gate the dense layers route on (models/layers.py); it
is the JAX package's rule to the letter, because the route decides the
rounding: this kernel folds the scale after the K sum, while the
dequantize route rounds ``w_q * w_s`` to bf16 first.  The TPU's M padding
to 16 rows and its K/N block choice (``_pick_blk_k``) are not carried over.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import torch

from .cuda_kernels import W8_MATMUL, query, stream_of

COLS_PER_UNIT = 128  # csrc/w8_matmul.cu NT
ROWS_PER_UNIT = 16   # csrc/w8_matmul.cu MT
K_PER_UNIT = 64      # csrc/w8_matmul.cu KU


def supports(m: int, k: int, n: int, max_rows: int = 256) -> bool:
    """True if w8_matmul can run this shape (the dense layers gate on it)."""
    return m <= max_rows and k % 128 == 0 and n % 128 == 0


def w8_matmul_reference(x, w_q, w_s, out_dtype=None):
    """Plain oracle: dequantize, then an f32 product (what the kernel
    replaces)."""
    out_dtype = out_dtype or x.dtype
    w = w_q.float() * w_s.float().reshape(1, -1)
    return (x.float() @ w).to(out_dtype)


@dataclasses.dataclass(frozen=True)
class Partition:
    """The kernel's split of one call into ``grid`` blocks (stream-K).

    The work units are (16 rows of x, 128 output columns, 64 rows of K),
    numbered output tile by output tile and, within a tile, in K order.
    Block b takes units ``[b * units // grid, (b + 1) * units // grid)``;
    its units of one tile form a segment, whose partial sum goes to
    workspace slot ``b + tile``, and the tile's last block adds the slots
    in K order.  csrc/w8_matmul.cu computes the same integers."""

    grid: int
    units: int
    chunks: int  # K chunks of a tile
    tiles: int   # output tiles: row tiles x column tiles

    @property
    def slots(self) -> int:
        """Workspace slots of ROWS_PER_UNIT x COLS_PER_UNIT floats."""
        return self.grid + self.tiles - 1

    def share(self, b: int) -> range:
        return range(b * self.units // self.grid, (b + 1) * self.units // self.grid)

    def block_of(self, u: int) -> int:
        return ((u + 1) * self.grid - 1) // self.units

    def segments(self, tile: int) -> list[tuple[int, range]]:
        """(block, its K chunks) of a tile, in the order the sum takes them."""
        lo, hi = tile * self.chunks, (tile + 1) * self.chunks
        out = []
        for b in range(self.block_of(lo), self.block_of(hi - 1) + 1):
            share = self.share(b)
            out.append((b, range(max(lo, share.start) - lo, min(hi, share.stop) - lo)))
        return out


def partition(m: int, k: int, n: int, slots: int) -> Partition:
    """The stream-K split of an (m, k) x (k, n) call over ``slots``
    resident blocks: as many blocks as slots (fewer only if the call has
    fewer units), each an equal contiguous share of the units to within
    one unit, so the call is one wave with no partial tail."""
    chunks = k // K_PER_UNIT
    tiles = -(-m // ROWS_PER_UNIT) * (n // COLS_PER_UNIT)
    units = tiles * chunks
    return Partition(grid=max(1, min(slots, units)), units=units, chunks=chunks, tiles=tiles)


def kernel_info() -> dict:
    """The kernel's blocks an SM, registers a thread, dynamic shared memory
    and local (spill) bytes on the current device."""
    blocks, regs, smem, local = query(W8_MATMUL.file, "vqa_w8_info")[:4]
    return {"blocks_per_sm": blocks, "registers": regs, "shared_bytes": smem, "local_bytes": local}


@functools.lru_cache(maxsize=None)
def resident_slots(device_index: int) -> int:
    """SMs x blocks of the kernel an SM (its occupancy on this card)."""
    with torch.cuda.device(device_index):
        blocks = kernel_info()["blocks_per_sm"]
    if blocks < 1:
        raise RuntimeError("w8_matmul: the kernel fits no block on an SM")
    return torch.cuda.get_device_properties(device_index).multi_processor_count * blocks


# One ticket buffer per device, zero between calls (the kernel's last block
# of each tile resets its ticket).  The serving path runs every call on
# one stream; calls in flight on two streams at once would share it.
_tickets: dict[int, torch.Tensor] = {}
_tickets_lock = threading.Lock()


def _tickets_for(device: torch.device, tiles: int) -> torch.Tensor:
    with _tickets_lock:
        t = _tickets.get(device.index)
        if t is None or t.numel() < tiles:
            t = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
            _tickets[device.index] = t
        return t


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
            or w_q.data_ptr() % 16):
        raise ValueError(f"w8_matmul needs a contiguous, 16-byte aligned ({kk}, {n}) int8 weight on {x.device}")
    if w_s.device != x.device:
        raise ValueError(f"w8_matmul: scales on {w_s.device}, x on {x.device}")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # TMA reads x from a 16-byte aligned base
        xb = xb.clone()
    ws = w_s.contiguous()
    dev = x.device
    plan = partition(m, kk, n, resident_slots(dev.index if dev.index is not None else torch.cuda.current_device()))
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((plan.slots, ROWS_PER_UNIT, COLS_PER_UNIT), dtype=torch.float32, device=dev)
    W8_MATMUL.launch(
        xb.data_ptr(), w_q.data_ptr(), ws.data_ptr(), m, kk, n, plan.grid, part.data_ptr(),
        _tickets_for(dev, plan.tiles).data_ptr(), y.data_ptr(), stream_of(x),
    )
    return y if out_dtype == torch.float32 else y.to(out_dtype)
