"""Attention of a few query positions over a bf16 KV cache, read in place.

:func:`decode_attention` is kernel K9: on a CUDA tensor it runs the
hand-written kernel of ``csrc/decode_attn.cu``, on a CPU tensor its plain
version :func:`decode_attention_plain`.  K9 replaces no TPU kernel: the JAX
package computes cached attention with two einsums that XLA fuses
(``vietnamese_qa_system_tpu/models/layers.py:528-553``).  The port's
einsum branch of ``Attention.forward`` copied the attended cache columns
to f32 for each of them; K9 reads the bf16 buffers where they lie.

``Attention.forward`` (models/layers.py) routes a cached self-attention
call to K9 when :func:`supports` holds (a CUDA tensor, a bf16 cache, at
most :data:`MAX_TQ` query positions, a head dim of :data:`HEAD_DIMS`, cache
rows of whole 16-byte chunks): every decode step, speculative window and
short prefill extension.  Prefills at bucket width, the int8 KV cache and
cross-attention keep the einsum.  Query head h reads kv head ``h // (H //
kvH)``: grouped heads are never repeated.

Numerics are the einsum branch's, with one exception: a query row with no
valid key gives 0 (the einsum's finite ``-1e30`` gives the mean of V over
every column).  No token reads such a row: it is a free or finished slot,
or a padding position.

How the kernel cuts the work (:func:`plan`) follows what a call shows: the
query rows of one kv head (``H // kvH`` x Tq) in blocks of at most
:data:`MAX_ROWS`, and the keys in splits of whole 64-key tiles, enough
that the blocks fill the card's SMs twice where they can and that a
block's logits fit its shared memory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .attention import NEG_INF
from .cuda_kernels import DECODE_ATTN, on_card, stream_of

MAX_TQ = 16  # query positions a call: a decode step (1), a speculative window (gamma + 1)
HEAD_DIMS = (64, 128)
TILE = 64  # keys a tile (csrc/decode_attn.cu)
MAX_ROWS = 16  # query rows a block
LOGIT_BYTES = 64 * 1024  # a block's logits in shared memory


class Plan(NamedTuple):
    splits: int  # key splits, each a block
    per: int  # tiles a split
    row_blocks: int  # blocks over one kv head's query rows
    block_rows: int  # query rows a block


def plan(b: int, h: int, kv_h: int, tq: int, n_keys: int, sms: int) -> Plan:
    """K9's grid for a call: ``b`` rows, ``h`` query heads over ``kv_h``
    kv heads, ``tq`` positions, ``n_keys`` columns, on a card of ``sms``
    SMs.  Every split holds at least one tile."""
    rows = (h // kv_h) * tq
    row_blocks = -(-rows // MAX_ROWS)
    block_rows = -(-rows // row_blocks)
    tiles = -(-n_keys // TILE)
    fit = max(1, LOGIT_BYTES // (4 * TILE * block_rows))  # tiles whose logits fit a block
    fill = -(-2 * sms // (b * kv_h * row_blocks))  # splits that give every SM two blocks
    splits = min(tiles, max(-(-tiles // fit), fill))
    per = -(-tiles // splits)
    return Plan(-(-tiles // per), per, row_blocks, block_rows)


def _whole_rows(t: torch.Tensor) -> bool:
    """A cache buffer K9 reads by 16-byte copies: its head dim contiguous,
    every other stride and its start on 16 bytes."""
    return t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0


def fits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The shapes, types and layouts K9 takes, whatever the device: q (B,
    Tq <= MAX_TQ, H, D in HEAD_DIMS), bf16 cache buffers (B, L, kvH, D)
    with kvH dividing H, of whole 16-byte rows."""
    return (q.dim() == 4 and k.dim() == 4 and k.dtype == v.dtype == torch.bfloat16 and k.shape == v.shape
            and q.shape[1] <= MAX_TQ and q.shape[-1] in HEAD_DIMS and k.shape[-1] == q.shape[-1]
            and k.shape[0] == q.shape[0] and q.shape[2] % k.shape[2] == 0 and _whole_rows(k) and _whole_rows(v))


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """True: K9 takes this cached call (see :func:`fits`), on the card."""
    return q.is_cuda and fits(q, k, v)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def decode_attention_plain(q, k, v, mask, bias=None, *, scale=None) -> torch.Tensor:
    """K9's plain version: the einsum branch of ``Attention.forward`` over
    the first ``mask.shape[-1]`` cache columns (query head h on kv head h //
    rep), except that a row with no valid key gives 0.  Returns (B, Tq, H,
    D) f32."""
    n_keys = mask.shape[-1]
    k, v = k[:, :n_keys], v[:, :n_keys]
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", _bf16(q), _bf16(k)) * scale
    if bias is not None:
        logits = logits + bias
    keep = mask[:, None, :, :]
    probs = torch.softmax(torch.where(keep, logits, NEG_INF), dim=-1)
    probs = torch.where(keep.any(dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", _bf16(probs), _bf16(v))


def decode_attention(q, k, v, mask, bias=None, *, scale=None) -> torch.Tensor:
    """K9: q (B, Tq, H, D) over the cache buffers k, v (B, L, kvH, D) bf16
    (L >= n_keys; columns past them, the decode state's guard column among
    them, are never read), ``mask`` (B|1, Tq|1, n_keys) bool, True =
    attend, ``bias`` broadcastable to (B, H, Tq, n_keys) and added after the
    scaling (ALiBi's (1, H, 1, n_keys), a T5 decoder's (B, H, 1, n_keys)),
    ``scale`` (default D^-0.5).  Returns (B, Tq, H, D) f32.  On a CUDA
    tensor it launches the kernel or raises."""
    if not on_card(q):
        return decode_attention_plain(q, k, v, mask, bias, scale=scale)
    if not fits(q, k, v) or mask.dtype != torch.bool or mask.dim() != 3:
        raise ValueError(f"decode_attention: unsupported call q {tuple(q.shape)} {q.dtype}, cache "
                         f"{tuple(k.shape)} {k.dtype} strides {k.stride()}, mask {tuple(mask.shape)} {mask.dtype}")
    b, tq, h, d = q.shape
    kv_h, n_keys = k.shape[2], mask.shape[-1]
    if k.shape[1] < n_keys:
        raise ValueError(f"decode_attention: mask covers {n_keys} columns of a {k.shape[1]}-column cache")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    qb = q.to(torch.bfloat16).contiguous()
    m = mask.expand(b, tq, n_keys)
    bias_t = None if bias is None else bias.to(torch.float32).expand(b, h, tq, n_keys)
    p = plan(b, h, kv_h, tq, n_keys, _sm_count(q.device.index if q.device.index is not None else 0))
    out = torch.empty((b, tq, h, d), dtype=torch.float32, device=q.device)
    part_o = part_ml = None
    if p.splits > 1:
        part_o = torch.empty((p.splits, b, tq, h, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((p.splits, b, tq, h, 2), dtype=torch.float32, device=q.device)
    DECODE_ATTN.launch(
        qb.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), 0 if bias_t is None else bias_t.data_ptr(),
        out.data_ptr(), 0 if part_o is None else part_o.data_ptr(), 0 if part_ml is None else part_ml.data_ptr(),
        b, tq, h, kv_h, d, n_keys, 1 if mask.shape[1] == 1 else tq, p.splits, p.per, p.row_blocks, p.block_rows,
        *k.stride()[:3], *v.stride()[:3], *m.stride(), *((0, 0, 0, 0) if bias_t is None else bias_t.stride()),
        float(scale), stream_of(q), device=q.device)
    return out
