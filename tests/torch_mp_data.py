"""The inputs that tests/torch_mp_worker.py and
tests/test_torch_multiprocess.py share (not a test file)."""

import numpy as np
import torch


def ppl_batches():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(4):
        ids = rng.integers(4, 260, (4, 16)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids})
    return out


def gen_batches():
    rng = np.random.default_rng(2)
    out = []
    for _ in range(2):
        ids = rng.integers(4, 260, (2, 8)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids)})
    return out


def model_state():
    """A state of mixed leaves: an f32 matrix, a bf16 vector, a matrix of
    one row (fewer rows than processes) and a scalar."""
    g = torch.Generator().manual_seed(3)
    return {"w": torch.randn(9, 6, generator=g), "bias": torch.arange(5, dtype=torch.bfloat16),
            "one": torch.randn(1, 4, generator=g), "step": torch.tensor(7, dtype=torch.int32)}
