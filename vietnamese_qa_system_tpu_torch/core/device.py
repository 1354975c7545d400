"""Device resolution and seeded generators.

Counterpart of the device and seed parts of ``core/mesh.py`` and
``core/rng.py``.  The port runs on one device; there is no mesh.
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


def make_generator(seed: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded explicitly (random init draws on the
    host, so one seed gives the same weights on every device)."""
    return torch.Generator(device="cpu").manual_seed(int(seed))
