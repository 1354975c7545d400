"""Several processes: the process index and count, and the gathers and
barrier that eval and the sharded checkpoint need across them.

Counterpart of the ``jax.process_index()`` / ``jax.process_count()`` /
``multihost_utils`` uses of the JAX package (train/evaluate.py:74-82,
:131-162; train/checkpoint.py:250-292; data/loader.py:221-230).  One
process drives its mesh (``core/mesh.py``); ``torch.distributed`` joins
processes only, never the devices of one mesh.  Without an initialised
process group every function answers for one process.  The process group
is the caller's to make, with its address, world size and rank
(``torch.distributed.init_process_group("gloo", init_method=
"tcp://localhost:<port>", world_size=n, rank=r)``): nothing on a machine
announces a cluster.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def allgather_object(obj) -> list:
    """Every process's ``obj``, in rank order (one entry without a group)."""
    if not _active():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def allgather_rows(x: np.ndarray) -> np.ndarray:
    """Every process's rows of ``x`` concatenated in rank order
    (``multihost_utils.process_allgather`` then a concatenation)."""
    return np.concatenate(allgather_object(np.asarray(x)), axis=0)


def barrier() -> None:
    if _active():
        dist.barrier()
