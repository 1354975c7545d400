"""The port's trainer over a mesh against the JAX ``Trainer`` on the same
mesh shape (test_torch_mesh_train.py's helpers and tolerances): LoRA over
a float base under the five strategies, and a seq2seq model (the tiny
native encoder-decoder, LoRA) under dp and fsdp."""

import numpy as np
import pytest
import torch

from test_torch_mesh_train import (STRATEGIES, _leaves_np, adapter_from_jax, assert_metrics_close, check_lora_step,
                                   setup, train_both)
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)


@pytest.mark.parametrize("strategy,axes", STRATEGIES)
def test_float_lora_step_matches_jax_trainer(tmp_path, strategy, axes):
    check_lora_step(tmp_path, strategy, axes, None)


@pytest.mark.parametrize("strategy", ["dp", "fsdp"])
def test_seq2seq_step_matches_jax_trainer(tmp_path, strategy):
    """The losses and ``grad_norm`` of the tolerances above; the adapter's
    move by the norm rule (no JAX gradient mask for this family here)."""
    import jax

    cfg, params, adapter, data = setup(arch="seq2seq")
    tm, jm, tt, jt = train_both(cfg, params, adapter, data, strategy, {"data": 4}, None, tmp_path)
    assert_metrics_close(tm, jm)
    before = [x.detach().numpy() for x in tree_leaves(adapter_from_jax(adapter, "cpu"))]
    mine = _leaves_np(tree_leaves(tt.whole_state()["adapter"]))
    theirs = [x.detach().numpy() for x in tree_leaves(adapter_from_jax(jax.tree.map(np.asarray,
                                                                                    jt.state["adapter"]), "cpu"))]
    d = np.concatenate([(m - b0 - (j - b0)).ravel() for b0, m, j in zip(before, mine, theirs)])
    moved = np.concatenate([(j - b0).ravel() for b0, j in zip(before, theirs)])
    assert np.linalg.norm(d) <= 0.25 * np.linalg.norm(moved)
