"""The collectives of the single-controller mesh (``core/mesh.py``).

One process drives every device, so a collective is a function over the
per-device tensors it holds: each part is copied to the device that
needs it and combined there.  ``Tensor.to(device)`` between two CUDA
devices runs the copy on the source device's current stream after the
destination's current stream, and makes the destination's current stream
wait for it, so a device never reads a part before its producer and the
copy have finished; between parts on one device (a repeated-device mesh)
it is a no-op.

Every form is made of differentiable ``.to`` / ``narrow`` / ``cat`` /
``+`` steps, so each carries a gradient: the backward of
:func:`broadcast` sums the copies' gradients on the source, the backward
of :func:`all_gather` hands each part its slice, and that of the sums
copies the gradient back to every addend.

The process-group forms of several processes (``torch.distributed``: the
process index and count, the all-gather of eval totals and records, the
barrier of a sharded checkpoint) are in ``core/distributed.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def all_gather(parts: Sequence[torch.Tensor], dst: torch.device, *, dim: int) -> torch.Tensor:
    """The parts on ``dst``, concatenated along ``dim`` in part order (a
    merge reads ``lax.all_gather``'s stacked layout this way: shard-major
    along its candidate axis; an fsdp-split leaf comes back whole)."""
    return torch.cat([p.to(dst) for p in parts], dim=dim)


def all_reduce_sum(parts: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The f32 sum of the parts on ``dst``, added in part order."""
    out = parts[0].to(dst, torch.float32)
    for p in parts[1:]:
        out = out + p.to(dst, torch.float32)
    return out


def broadcast(t: torch.Tensor, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """``t`` on every device of ``devices`` (one entry a position; on the
    tensor's own device the entry is ``t`` itself)."""
    return [t.to(d) for d in devices]


def reduce_scatter_sum(tensors: Sequence[torch.Tensor], devices: Sequence[torch.device], *,
                       dim: int) -> list[torch.Tensor]:
    """Part ``k`` of the f32 sum of ``tensors`` (whole, one a source) split
    into ``len(devices)`` equal parts along ``dim``, on ``devices[k]``:
    each part adds the sources' slices in source order."""
    n = len(devices)
    step = tensors[0].shape[dim] // n
    return [all_reduce_sum([t.narrow(dim, k * step, step) for t in tensors], dev) for k, dev in enumerate(devices)]
