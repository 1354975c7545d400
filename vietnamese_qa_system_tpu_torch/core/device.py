"""Device resolution and seeded generators.

Counterpart of the device and seed parts of ``core/mesh.py`` and
``core/rng.py``.  An entry point runs on one device unless it is given a
mesh (``core/mesh.py``: the sharded store and IVF index, the
tensor-parallel reader).
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` -> ``torch.device``.

    A CUDA device that is not available raises: the port never quietly
    runs on the CPU in its place.  Resolving a CUDA device also switches
    TF32 off for float32 products: the port's plain versions are the
    references its kernels are held against, and TF32 would round their
    inputs to ten mantissa bits."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


def make_generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded explicitly.  The default
    draws on the host, so one seed gives the same weights on every device;
    a device generator lets a multi-billion-parameter reader be drawn
    where it lives."""
    return torch.Generator(device=device).manual_seed(int(seed))
