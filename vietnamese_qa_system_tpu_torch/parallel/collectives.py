"""The collectives of the single-controller mesh (``core/mesh.py``).

One process drives every device, so a collective is a function over the
per-device tensors it holds: each part is copied to the lead device and
combined there.  ``Tensor.to(device)`` between two CUDA devices runs the
copy on the source device's current stream after the destination's
current stream, and makes the destination's current stream wait for it, so
the lead device never reads a part before its producer and the copy has
finished; between parts on one device (a repeated-device mesh) it is a
no-op.  The process-group forms of the training slice (``torch.distributed``)
belong beside these.
"""

from __future__ import annotations

from typing import Sequence

import torch


def all_gather(parts: Sequence[torch.Tensor], dst: torch.device, *, dim: int) -> torch.Tensor:
    """The parts on ``dst``, concatenated along ``dim`` in part order (a
    merge reads ``lax.all_gather``'s stacked layout this way: shard-major
    along its candidate axis)."""
    return torch.cat([p.to(dst) for p in parts], dim=dim)


def all_reduce_sum(parts: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The f32 sum of the parts on ``dst``, added in part order."""
    out = parts[0].to(dst, torch.float32)
    for p in parts[1:]:
        out = out + p.to(dst, torch.float32)
    return out
