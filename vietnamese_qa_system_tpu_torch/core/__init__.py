from .device import make_generator, resolve_device
from .mesh import DATA_AXIS, MODEL_AXIS, SHARD_AXIS, Mesh, MeshSpec, create_mesh, mesh_on

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "MeshSpec", "SHARD_AXIS", "create_mesh", "make_generator", "mesh_on",
           "resolve_device"]
