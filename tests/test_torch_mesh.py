"""The port's device mesh and collectives against the JAX package's mesh:
``MeshSpec.resolve`` and its errors, ``create_mesh`` over a repeated CPU
device list (the counterpart of the JAX tests' virtual 8-device mesh), the
CLI's mesh, and the collectives' layouts and f32 sums."""

import jax
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.core import mesh as jmesh
from vietnamese_qa_system_tpu_torch.core import mesh as tmesh
from vietnamese_qa_system_tpu_torch.parallel import all_gather, all_reduce_sum

CPU = torch.device("cpu")

SPECS = [
    ({"data": -1}, 8),
    ({"data": 2, "model": -1}, 8),
    ({"shard": 4}, 8),
    ({"data": 2, "model": 2}, 4),
    ({"model": 3}, 8),
    ({"data": -1, "model": -1}, 8),
    ({"data": 3, "model": -1}, 8),
    ({"shard": 16}, 8),
]


@pytest.mark.parametrize("axes,n", SPECS)
def test_mesh_spec_resolves_like_jax(axes, n):
    """Resolved sizes, or the error and its message, equal JAX's."""
    try:
        want = jmesh.MeshSpec(axes).resolve(n)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tmesh.MeshSpec(axes).resolve(n)
        assert str(got.value) == str(err)
        return
    assert tmesh.MeshSpec(axes).resolve(n) == want


@pytest.mark.parametrize("axes", [{"shard": 4}, {"data": 2, "model": 4}, {"model": -1}, None])
def test_create_mesh_over_repeated_devices_matches_jax_shape(axes):
    """A repeated CPU device list stands in for JAX's eight CPU devices:
    the same axis names and sizes, a prefix where the mesh is smaller."""
    want = jmesh.create_mesh(axes, devices=jax.devices())
    got = tmesh.create_mesh(axes, devices=[CPU] * 8)
    assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    assert got.size == want.devices.size and all(d == CPU for d in got.devices.flat)
    for name in got.axis_names:
        assert len(got.axis_devices(name)) == got.shape[name]


def test_create_mesh_raises_with_too_few_devices():
    """Too many positions for the devices raises as JAX's does; the
    default device list is the visible GPUs (none here)."""
    with pytest.raises(ValueError) as want:
        jmesh.create_mesh({"shard": 16}, devices=jax.devices())
    with pytest.raises(ValueError) as got:
        tmesh.create_mesh({"shard": 16}, devices=[CPU] * 8)
    assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 devices, only 0 available"):
            tmesh.create_mesh({"shard": 2})
        with pytest.raises(ValueError, match="needs 2 devices, only 0 available"):
            tmesh.mesh_on("cuda", {"shard": 2})
    with pytest.raises(ValueError, match="no 'model' axis"):
        tmesh.create_mesh({"shard": 2}, devices=[CPU] * 2).axis_devices("model")


def test_mesh_on_the_cpu_and_axis_devices():
    """``--device cpu``: the host at every position; ``axis_devices`` runs
    along one axis at index 0 of the others."""
    m = tmesh.mesh_on("cpu", {"data": 2, "model": 3})
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.axis_devices("model") == [CPU] * 3 and m.axis_devices("data") == [CPU] * 2
    assert "Mesh({'data': 2, 'model': 3}" in repr(m)


def test_collectives():
    """``all_gather`` concatenates in part order; ``all_reduce_sum`` adds
    in f32 in part order."""
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)) for _ in range(4)]
    np.testing.assert_array_equal(all_gather(parts, CPU, dim=1).numpy(),
                                  np.concatenate([p.numpy() for p in parts], axis=1))
    bf = [p.to(torch.bfloat16) for p in parts]
    s = all_reduce_sum(bf, CPU)
    want = ((bf[0].float() + bf[1].float()) + bf[2].float()) + bf[3].float()
    assert s.dtype == torch.float32 and torch.equal(s, want)
