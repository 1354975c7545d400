"""Weight-only int8 matmul (the w8 GEMM) for serving decode: kernel K6.

Counterpart of ``vietnamese_qa_system_tpu/ops/w8_matmul.py``.  On a CUDA
tensor :func:`w8_matmul` runs the hand-written kernel of
``csrc/w8_matmul.cu`` (replaces the Pallas ``_w8_kernel``): the int8 weight
is read once and converted to bf16 in registers once per call, whatever
the rows, the products with the bf16 activations run on wgmma (swap AB:
the weight is wgmma's A, x's rows its n) and are summed in f32 over all of
K, and the per-output-column scale multiplies once, after the sum.  On a
CPU tensor its plain version :func:`w8_matmul_reference` (the same f32 sum
of exact products, then the scale) runs instead.  One call is one launch:
the kernel splits the weight stream over exactly the card's resident
blocks (:func:`partition`, stream-K) and adds the split-K partials itself.
The backward is dx only, in plain PyTorch as it is XLA in the JAX package
(w8_matmul.py:158-178): ``dx = (dy * w_s) @ w_q^T``; the frozen int8 codes
and their scales get no gradient.

``supports`` is the gate the dense layers route on (models/layers.py); it
is the JAX package's rule to the letter, because the route decides the
rounding: this kernel folds the scale after the K sum, while the
dequantize route rounds ``w_q * w_s`` to bf16 first.  The TPU's M padding
to 16 rows and its K/N block choice (``_pick_blk_k``) are not carried over:
the kernel pads M to a row bucket (:func:`padded_rows`).
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import torch

from .cuda_kernels import W8_MATMUL, query, stream_of

K_PER_UNIT = 64     # csrc/w8_matmul.cu KU
WG_COLS = 64        # output columns of a warpgroup (csrc/w8_matmul.cu WG_COLS)
# the padded row counts (wgmma's n) the kernel is built for: csrc/w8_matmul.cu W8_BUCKETS
ROW_BUCKETS = (8, 16, 32, 48, 64, 72, 96, 128, 192, 256)


def supports(m: int, k: int, n: int, max_rows: int = 256) -> bool:
    """True if w8_matmul can run this shape (the dense layers gate on it)."""
    return m <= max_rows and k % 128 == 0 and n % 128 == 0


def w8_matmul_reference(x, w_q, w_s, out_dtype=None):
    """Plain version: the f32 sum of the exact products of bf16(x) and the
    int8 codes, then the column scale, as the kernel and the JAX kernel
    compute it (folding the scale into the weight first rounds each
    product differently)."""
    out_dtype = out_dtype or x.dtype
    y = x.to(torch.bfloat16).float() @ w_q.float()
    return (y * w_s.float().reshape(1, -1)).to(out_dtype)


def padded_rows(m: int) -> int:
    """The row bucket of an m-row call: the kernel instance it launches
    (wgmma's n; the x tile's rows, zero past m)."""
    for b in ROW_BUCKETS:
        if m <= b:
            return b
    raise ValueError(f"w8_matmul takes at most {ROW_BUCKETS[-1]} rows (got {m})")


def warpgroups(mp: int) -> int:
    """Warpgroups of a block at mp padded rows: 4 up to 72 rows, 2 above,
    where a warpgroup's 64 x mp f32 sums fill most of its registers."""
    return 4 if mp <= 72 else 2


def cols_per_unit(mp: int) -> int:
    """Output columns of a work unit: 64 a warpgroup."""
    return WG_COLS * warpgroups(mp)


def fragment_columns(mp: int) -> list[tuple[int, int]]:
    """The unit's weight columns behind each thread's wgmma fragments, by
    thread of a block: A rows 16 w + g and 16 w + g + 8 of the thread's
    warpgroup (warp w of it, lane 4 g + t) are its columns 16 w + 2 g and
    16 w + 2 g + 1 of the warpgroup's 64, so one 16-bit shared load of a K
    row holds both.  The sums keep that map: a thread's register 4 j + 2 h
    + e is (x row 8 j + 2 t + e, its column h), written to y as one float2
    per row.  csrc/w8_matmul.cu computes the same map."""
    out = []
    for tid in range(128 * warpgroups(mp)):
        wg, w, g = tid // 128, tid // 32 % 4, tid % 32 // 4
        c = wg * WG_COLS + 16 * w + 2 * g
        out.append((c, c + 1))
    return out


@dataclasses.dataclass(frozen=True)
class Partition:
    """The kernel's split of one call into ``grid`` blocks (stream-K).

    The work units are (all rows, ``cols`` output columns, 64 rows of K),
    numbered output tile by output tile and, within a tile, in K order.
    Block b takes units ``[b * units // grid, (b + 1) * units // grid)``;
    its units of one tile form a segment, whose partial sum goes to
    workspace slot ``b + tile`` (the tile's rows below m, row by row);
    the tile's reducers (:meth:`reducers`) each add a slice of it
    (:meth:`slice_of`) over the slots in K order (a lone reducer, the
    tile's first block, starts from its own sums and writes no slot).
    csrc/w8_matmul.cu computes the same integers."""

    grid: int
    units: int
    chunks: int  # K chunks of a tile
    tiles: int   # output tiles: column tiles of all rows
    rows: int    # padded rows (the kernel instance)
    cols: int    # output columns of a unit

    @property
    def slots(self) -> int:
        """Workspace slots of rows x cols floats."""
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

    def reducers(self, tile: int) -> range:
        """The blocks that add a split tile's partials: those whose shares
        end inside it (every block of the tile but the last, unless its
        share ends there too)."""
        first, last = self.block_of(tile * self.chunks), self.block_of((tile + 1) * self.chunks - 1)
        ends_inside = (last + 1) * self.units // self.grid <= (tile + 1) * self.chunks
        return range(first, last + 1 if ends_inside else last)

    @staticmethod
    def slice_of(k: int, n_reducers: int, vecs: int) -> range:
        """Reducer k's float4s of a split tile's ``vecs`` = m * cols / 4
        (the slots hold the tile row by row: float4 f is row f // (cols /
        4), unit columns 4 (f % (cols / 4)) .. + 3)."""
        return range(k * vecs // n_reducers, (k + 1) * vecs // n_reducers)


def partition(m: int, k: int, n: int, slots: int) -> Partition:
    """The stream-K split of an (m, k) x (k, n) call over ``slots``
    resident blocks: as many blocks as slots (fewer only if the call has
    fewer units), each an equal contiguous share of the units to within
    one unit, so the call is one wave with no partial tail.  Each weight
    tile belongs to one unit: the weight is read once whatever m is."""
    mp = padded_rows(m)
    cols = cols_per_unit(mp)
    chunks = k // K_PER_UNIT
    tiles = -(-n // cols)
    units = tiles * chunks
    return Partition(grid=max(1, min(slots, units)), units=units, chunks=chunks, tiles=tiles, rows=mp, cols=cols)


def kernel_info(mp: int) -> dict:
    """The instance for ``mp`` padded rows on the current device: blocks
    an SM, registers a thread, dynamic shared memory, local (spill) bytes,
    threads a block, output columns a unit, ring stages."""
    out = query(W8_MATMUL.file, "vqa_w8_info", mp)
    keys = ("blocks_per_sm", "registers", "shared_bytes", "local_bytes", "threads", "cols", "stages")
    return dict(zip(keys, out))


@functools.lru_cache(maxsize=None)
def resident_slots(device_index: int, mp: int) -> int:
    """SMs x blocks of the ``mp`` instance an SM (its occupancy on this card)."""
    with torch.cuda.device(device_index):
        blocks = kernel_info(mp)["blocks_per_sm"]
    if blocks < 1:
        raise RuntimeError(f"w8_matmul: the {mp}-row instance fits no block on an SM")
    return torch.cuda.get_device_properties(device_index).multi_processor_count * blocks


# One ticket buffer per device, two ints a tile, zero between calls (the
# kernel's last reducer of each tile resets them).  The serving path runs every call on
# one stream; calls in flight on two streams at once would share it.
_tickets: dict[int, torch.Tensor] = {}
_tickets_lock = threading.Lock()


def _tickets_for(index: int, n: int) -> torch.Tensor:
    """The ticket buffer of CUDA device ``index`` (keyed by index, so
    ``cuda`` and ``cuda:0`` share one)."""
    with _tickets_lock:
        t = _tickets.get(index)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 4096), dtype=torch.int32, device=torch.device("cuda", index))
            _tickets[index] = t
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
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan = partition(m, kk, n, resident_slots(index, padded_rows(m)))
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((plan.slots, plan.rows * plan.cols), dtype=torch.float32, device=dev)
    W8_MATMUL.launch(
        xb.data_ptr(), w_q.data_ptr(), ws.data_ptr(), m, kk, n, plan.rows, plan.grid, part.data_ptr(),
        _tickets_for(index, 2 * plan.tiles).data_ptr(), y.data_ptr(), stream_of(x), device=dev,
    )
    return y if out_dtype == torch.float32 else y.to(out_dtype)
