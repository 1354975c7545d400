"""Checkpoint / resume.

Counterpart of ``vietnamese_qa_system_tpu/train/checkpoint.py:25-83,
207-370``, in the same on-disk layout: one ``step_N/`` directory per
checkpoint holding ``state.npz`` (the state's leaves as ``leaf_0`` ...
in the JAX package's flattening order, utils/tree.py), ``dtypes.json``
(bf16 leaves are stored as f32 and named "bfloat16" there) and
``meta.json``, written last as the commit marker.  A checkpoint of either
package restores into the other.

Sharded checkpoints (checkpoint.py:87-208) use the JAX package's per-host
layout: ``host_{h}.npz`` holds array ``l{i}_s{j}`` for shard ``j`` of leaf
``i``, and ``host_{h}.layout.json`` maps each to its leaf, global shape,
dtype and slice.  One process drives its whole mesh and saves every leaf
whole (a trainer over a mesh assembles them first), so one process writes
``host_0`` with every leaf whole.  Under several processes
(``core/distributed.py``) every process holds the whole state and each
writes ``host_{rank}``: leaf rows split evenly over the processes (leaves
with fewer rows than processes, and scalars, from rank 0), so each row is
written once; rank 0 clears a crashed save of the step before a barrier,
and writes ``meta.json`` after a second one (checkpoint.py:250-292).
``restore`` detects the format and reassembles a directory written by any
number of hosts of either package, raising on a leaf that no host file
holds or that the files do not fill.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core import distributed
from ..utils.tree import tree_leaves, tree_unflatten

_TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32, "int8": torch.int8, "int64": torch.int64,
                 "uint8": torch.uint8, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _to_savable(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.float().cpu().numpy(), "bfloat16"
        return x.cpu().numpy(), str(x.dtype).removeprefix("torch.")
    x = np.asarray(x)
    return x, x.dtype.name


def _sidecar(path: str) -> str:
    return os.path.join(os.path.dirname(path) or ".", "dtypes.json")


def save_pytree(path: str, tree) -> None:
    """The leaves of ``tree`` in the JAX order -> ``path`` (npz) and its
    ``dtypes.json`` sidecar."""
    arrays, dtypes = {}, []
    for i, leaf in enumerate(tree_leaves(tree)):
        arr, dt = _to_savable(leaf)
        arrays[f"leaf_{i}"] = arr
        dtypes.append(dt)
    np.savez(path, **arrays)
    with open(_sidecar(path), "w") as f:
        json.dump(dtypes, f)


def _restore_leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)  # 0-d leaves stay 0-d


def load_pytree(path: str, target=None):
    """Restore into the structure, dtypes and devices of ``target``; with
    ``target=None`` the flat list of CPU tensors in their saved dtypes."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz_path) as data:
        n = len(data.files)
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    if target is None:
        with open(_sidecar(npz_path)) as f:
            dtypes = json.load(f)
        if len(dtypes) != n:
            raise ValueError(f"dtypes.json has {len(dtypes)} entries for {n} leaves")
        return [torch.from_numpy(a).to(_TORCH_DTYPES[dt]) for a, dt in zip(arrays, dtypes)]
    t_leaves = tree_leaves(target)
    if len(t_leaves) != n:
        raise ValueError(f"checkpoint has {n} leaves but target structure has {len(t_leaves)} -- wrong "
                         "model/optimizer config for this checkpoint")
    leaves = []
    for arr, t in zip(arrays, t_leaves):
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf of shape {arr.shape} for a target of shape {tuple(t.shape)}")
        leaves.append(_restore_leaf(arr, t))
    return tree_unflatten(target, leaves)


def save_pytree_sharded(directory: str, tree, *, host_id: Optional[int] = None,
                        host_count: Optional[int] = None) -> None:
    """Write ``{directory}/host_{host_id}.npz`` and its
    ``host_{host_id}.layout.json`` (checkpoint.py:121-153): this host's
    share of every leaf of ``tree`` -- rows ``[h * n / H, (h + 1) * n / H)``
    of a leaf of n >= H rows for host h of H (the process index and count
    by default), a leaf of fewer rows or no dims from host 0 only."""
    host_id = distributed.process_index() if host_id is None else host_id
    host_count = distributed.process_count() if host_count is None else host_count
    os.makedirs(directory, exist_ok=True)
    leaves = tree_leaves(tree)
    arrays, layout = {}, []
    for i, leaf in enumerate(leaves):
        arr, dt = _to_savable(leaf)
        shape = [int(d) for d in arr.shape]
        if arr.ndim and arr.shape[0] >= host_count:
            lo, hi = host_id * arr.shape[0] // host_count, (host_id + 1) * arr.shape[0] // host_count
            arr = arr[lo:hi]
            index = [[lo, hi]] + [[0, d] for d in shape[1:]]
        elif host_id == 0:
            index = [[0, d] for d in shape]
        else:
            continue
        key = f"l{i}_s0"
        arrays[key] = arr
        layout.append({"leaf": i, "key": key, "shape": shape, "dtype": dt, "index": index})
    np.savez(os.path.join(directory, f"host_{host_id}.npz"), **arrays)
    with open(os.path.join(directory, f"host_{host_id}.layout.json"), "w") as f:
        json.dump({"n_leaves": len(leaves), "entries": layout}, f)


def _host_layouts(directory: str) -> list[str]:
    return sorted(f for f in os.listdir(directory) if re.fullmatch(r"host_\d+\.layout\.json", f))


def load_pytree_sharded(directory: str, target):
    """Reassemble every host file's shards into ``target``'s structure,
    dtypes and devices (checkpoint.py:156-200).  A leaf that no host file
    holds, or whose shards do not fill it (a host file is missing), raises
    ValueError."""
    host_files = _host_layouts(directory)
    if not host_files:
        raise FileNotFoundError(f"no host shard files under {directory}")
    t_leaves = tree_leaves(target)
    buffers: dict[int, np.ndarray] = {}
    filled: dict[int, int] = {}
    for name in host_files:
        with open(os.path.join(directory, name)) as f:
            layout = json.load(f)
        if layout["n_leaves"] != len(t_leaves):
            raise ValueError(f"checkpoint has {layout['n_leaves']} leaves but target has {len(t_leaves)}")
        with np.load(os.path.join(directory, name.replace(".layout.json", ".npz"))) as data:
            for e in layout["entries"]:
                i = e["leaf"]
                if i not in buffers:
                    buffers[i] = np.empty(e["shape"], np.float32 if e["dtype"] == "bfloat16" else e["dtype"])
                    filled[i] = 0
                shard = data[e["key"]]
                buffers[i][tuple(slice(a, b) for a, b in e["index"])] = shard
                filled[i] += int(shard.size)
    leaves = []
    for i, t in enumerate(t_leaves):
        if i not in buffers:
            raise ValueError(f"leaf {i} missing from every host shard file")
        if filled[i] < buffers[i].size:
            raise ValueError(f"leaf {i} incomplete: {filled[i]}/{buffers[i].size} elements written (a host shard "
                             "file is missing)")
        if tuple(buffers[i].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {i} of shape {buffers[i].shape} for a target of shape "
                             f"{tuple(t.shape)}")
        leaves.append(_restore_leaf(buffers[i], t))
    return tree_unflatten(target, leaves)


class CheckpointManager:
    """``step_N`` directories with latest-checkpoint discovery; meta.json
    is the commit marker, so a directory without it (a crashed write) is
    skipped by restore and swept by the next save.  ``sharded`` writes the
    per-host layout (``host_0``); restore reads either format."""

    def __init__(self, directory: str, keep: int = 3, *, sharded: bool = False):
        self.sharded = sharded
        self.directory = directory
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dirs(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "meta.json")):
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        self.wait()
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def save(self, step: int, state, metadata: Optional[dict] = None) -> str:
        path = os.path.join(self.directory, f"step_{step}")
        rank = distributed.process_index()
        if rank == 0:
            if os.path.isdir(path) and not os.path.exists(os.path.join(path, "meta.json")):
                shutil.rmtree(path, ignore_errors=True)  # a crashed save of this step
            os.makedirs(path, exist_ok=True)
        distributed.barrier()  # every process writes after the clean-up
        os.makedirs(path, exist_ok=True)
        if self.sharded:
            save_pytree_sharded(path, state)
        elif rank == 0:
            save_pytree(os.path.join(path, "state.npz"), state)  # one writer of the one file
        distributed.barrier()  # every host file is on disk before the marker
        if rank == 0:
            meta: dict[str, Any] = {"step": step}
            if metadata:
                meta.update(metadata)
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f)
            self._gc()
        distributed.barrier()
        return path

    def restore(self, state_like, step: Optional[int] = None):
        """(state, metadata), or (None, None) when there is no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, f"step_{step}")
        if _host_layouts(path):
            state = load_pytree_sharded(path, state_like)
        else:
            state = load_pytree(os.path.join(path, "state.npz"), state_like)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return state, meta

    def save_async(self, step: int, state, metadata: Optional[dict] = None) -> threading.Thread:
        """Snapshot the state to host memory now (the live tensors are
        updated in place by the next step), write it from a thread; at
        most one save is in flight."""
        self.wait()
        snap = tree_unflatten(state, [leaf.detach().cpu().clone() for leaf in tree_leaves(state)])
        self._pending = threading.Thread(target=self.save, args=(step, snap, metadata), daemon=True)
        self._pending.start()
        return self._pending

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        dirs = self._step_dirs()
        for _, path in dirs[: max(0, len(dirs) - self.keep)]:
            shutil.rmtree(path, ignore_errors=True)
        complete = {p for _, p in dirs}
        for name in os.listdir(self.directory):
            p = os.path.join(self.directory, name)
            if re.fullmatch(r"step_(\d+)", name) and p not in complete:
                shutil.rmtree(p, ignore_errors=True)
