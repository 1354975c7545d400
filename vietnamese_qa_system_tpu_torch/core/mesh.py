"""The device mesh: torch devices laid out on named axes.

Counterpart of ``vietnamese_qa_system_tpu/core/mesh.py``.  The JAX package
runs one SPMD program over a ``jax.sharding.Mesh`` and XLA inserts the
collectives; the port keeps the same single-controller shape: ONE process
holds the mesh, places a shard of each sharded tensor on each device, runs
every shard's kernels from the host loop and merges through the explicit
collectives of ``parallel/collectives.py``.  So ``serve`` stays one
process with one HTTP front end and needs no launcher.

The axes:

- ``data``  -- data parallelism (the training slice's);
- ``model`` -- tensor parallelism: attention heads, the MLP hidden and the
  vocabulary split over devices (``parallel/sharding.py``);
- ``shard`` -- retrieval-corpus sharding: each device owns a slab of the
  vector index; queries run a top-k per shard and merge the gathered
  candidates (``engine/store.py``, ``engine/ivf.py``).

A device list may name one device several times (``[cpu] * 4`` in the
tests, ``[cuda:0] * 4`` on a one-card machine): every shard then lives on
that device and the collectives' copies are no-ops, which is how a mesh of
four is checked where there is one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SHARD_AXIS = "shard"

# the host's repeat count where a ``--device cpu`` run of a command that
# takes every visible GPU (``serve --reader-strategy``) builds its mesh
CPU_MESH_DEVICES = 4


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape.  Axis sizes of -1 are inferred from the device
    count (at most one -1, like a reshape)."""

    axes: Mapping[str, int]

    def resolve(self, n_devices: int) -> dict[str, int]:
        axes = dict(self.axes)
        unknown = [k for k, v in axes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one inferred axis, got {unknown}")
        known = math.prod(v for v in axes.values() if v != -1)
        if unknown:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {axes}")
            axes[unknown[0]] = n_devices // known
        elif known > n_devices:
            raise ValueError(f"mesh {axes} needs {known} devices, only {n_devices} available")
        return axes


class Mesh:
    """An (axis sizes) array of torch devices with named axes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis: one
        device a shard of a tensor split on ``axis`` alone."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r} axis")
        at = [slice(None) if name == axis else 0 for name in self.axis_names]
        return list(self.devices[tuple(at)].reshape(-1))

    def grid(self) -> list[list[torch.device]]:
        """The devices by (data, model) position: ``grid()[i][j]`` is the
        device at data index ``i`` and model index ``j``, at index 0 of
        every other axis; an axis the mesh lacks counts as size 1.  The
        trainer places one replica row a data index (its tensor-parallel
        parts along the row)."""
        at = []
        for name in self.axis_names:
            at.append(slice(None) if name in (DATA_AXIS, MODEL_AXIS) else 0)
        sub = self.devices[tuple(at)]
        kept = [n for n in self.axis_names if n in (DATA_AXIS, MODEL_AXIS)]
        if kept == [MODEL_AXIS, DATA_AXIS]:
            sub = sub.T
        n_data, n_model = self.shape.get(DATA_AXIS, 1), self.shape.get(MODEL_AXIS, 1)
        sub = np.asarray(sub, dtype=object).reshape(n_data, n_model)
        return [list(row) for row in sub]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def visible_devices() -> list[torch.device]:
    """Every visible GPU, in index order (none without CUDA)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(axes: Mapping[str, int] | MeshSpec | None = None, *,
                devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """Build a mesh over the visible GPUs (or the given devices; a device
    may repeat).  Defaults to a 1-D ``data`` mesh covering every device;
    a mesh smaller than the device list takes a prefix, and one larger
    raises (:meth:`MeshSpec.resolve`)."""
    devs = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    if axes is None:
        axes = {DATA_AXIS: len(devs)}
    spec = axes if isinstance(axes, MeshSpec) else MeshSpec(axes)
    resolved = spec.resolve(len(devs))
    names = tuple(resolved)
    shape = tuple(resolved[n] for n in names)
    used = np.empty(math.prod(shape), dtype=object)
    for i, d in enumerate(devs[: used.size]):
        used[i] = d
    return Mesh(used.reshape(shape), names)


def mesh_on(device: torch.device | str, axes: Mapping[str, int]) -> Mesh:
    """The mesh a CLI command runs on: ``--device cpu`` repeats the host
    for every mesh position (a CPU run of the sharded code paths); a CUDA
    device takes the first visible GPUs and raises with fewer than the
    axes need."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return create_mesh(axes, devices=[dev] * math.prod(axes.values()))
    return create_mesh(axes)
