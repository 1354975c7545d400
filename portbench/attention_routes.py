"""Which route the cached-attention calls of the traced window took: the
decode-attention kernel K9 (its launches, tallied by
``trace.instrument_kernels`` while the device-only window runs), or the
einsum (the port's ``attention.cached_einsum`` counter of the same
profiler session, ``vietnamese_qa_system_tpu_torch/core/tracing.py``
``counts()``).  A program without that counter gives nothing."""

from __future__ import annotations

KERNEL = "decode_attention"
EINSUM = "attention.cached_einsum"


def kernel_share(rec) -> float | None:
    """K9's launches over every cached-attention call of the window, in %."""
    tr = rec.get("trace")
    if not tr:
        return None
    from vietnamese_qa_system_tpu_torch.core import tracing

    counts = getattr(tracing, "counts", None)
    if counts is None:
        return None
    kernel = sum(1 for name, _ in tr.get("tally") or () if name == KERNEL)
    total = kernel + counts().get(EINSUM, 0)
    return 100.0 * kernel / total if total else None
