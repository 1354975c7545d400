"""Host offload over a mesh (``TrainConfig.host_offload`` under zero2,
fsdp, tp and fsdp_tp):

- "optimizer" and "params" (full fine-tuning) and "all" (LoRA over an int8
  base) give bit-equal losses, grad_norm and trained leaves to the same
  run without offload (staging is placement, not arithmetic);
- between steps every distinct piece of the model and every leaf of the
  optimizer units' state is its persistent host buffer (one buffer a
  tensor, however many rows alias it), and the step stages them back;
- JAX tests/test_host_offload.py:28-97's ``fsdp`` on ``{"data": 2}`` case
  (``tiny_test("causal")``, optimizer offload, full fine-tuning) against
  the JAX ``Trainer`` with the same offload, by test_torch_mesh_train.py's
  tolerances.

The port's meshes repeat the CPU device (pinning is for a GPU's host)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mesh_train import LORA, _leaves_np, assert_metrics_close, setup
from vietnamese_qa_system_tpu.core.mesh import create_mesh as jcreate_mesh
from vietnamese_qa_system_tpu.train import trainer as jtrainer
from vietnamese_qa_system_tpu_torch.models import LoraConfig, ModelConfig, adapter_from_jax, causal_from_jax
from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer, params_tree
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
STRATEGIES = [("zero2", {"data": 4}), ("fsdp", {"data": 4}), ("tp", {"model": 4}),
              ("fsdp_tp", {"data": 2, "model": 2})]


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, float params, int8 params, adapter, batches)."""
    cfg, params, adapter, data = setup()
    _, qparams, _, _ = setup(quantize="int8")
    return cfg, params, qparams, adapter, data


def _trainer(tiny, tmp_path, strategy, axes, offload, lora):
    cfg, params, qparams, adapter, _ = tiny
    mcfg = ModelConfig.from_dict(dataclasses.asdict(cfg))
    tc = TrainConfig(model=mcfg, strategy=strategy, mesh_axes=axes, host_offload=offload, lr=1e-2, grad_accum=2,
                     lora=LoraConfig(**LORA) if lora else None, quantize_base="int8" if lora else None,
                     log_dir=str(tmp_path / "logs"))
    t = Trainer(tc, params=causal_from_jax(qparams if lora else params, mcfg, device="cpu"), device="cpu",
                total_steps=10)
    if lora:
        t.load_state(dict(t.whole_state(), adapter=adapter_from_jax(adapter, device="cpu")))
    return t


def _on_host(t) -> bool:
    """Every offloaded tensor is its persistent host buffer."""
    ok = True
    if t._host_params is not None:
        ok &= all(h is None or p.data_ptr() == h.data_ptr()
                  for p, h in zip(t.placed.param_tensors(), t._host_params))
    if t._host_opt is not None:
        ok &= all(h is None or x is h for x, h in zip(tree_leaves(t.placed.opt_state), t._host_opt))
    return bool(ok)


@pytest.mark.parametrize("offload,lora", [("optimizer", False), ("params", False), ("all", True)])
@pytest.mark.parametrize("strategy,axes", STRATEGIES)
def test_offload_is_bit_equal_to_the_device_run(tiny, tmp_path, strategy, axes, offload, lora):
    data = tiny[-1]
    runs = {}
    for off in (None, offload):
        t = _trainer(tiny, tmp_path, strategy, axes, off, lora)
        if off is not None:
            n = len(t._host_params or t._host_opt)
            assert _on_host(t)
        metrics = []
        for b in data:
            metrics.append({k: float(v) for k, v in t.train_step(b).items()})
            if off is not None:
                assert _on_host(t)  # back on the host between steps
        state = t.whole_state()
        runs[off] = metrics, _leaves_np(tree_leaves(state["adapter"] if lora else state["params"]))
    assert n > 0
    (m0, l0), (m1, l1) = runs[None], runs[offload]
    assert m0 == m1
    assert len(l0) == len(l1) and all(np.array_equal(a, b) for a, b in zip(l0, l1))


def test_offload_copies_an_aliased_piece_once(tiny, tmp_path):
    """dp over ``[cpu] * 4`` with params offload: the four rows' frozen
    tensors are one, so one host buffer holds each; the rows still share
    it after a step."""
    t = _trainer(tiny, tmp_path, "dp", {"data": 4}, "params", True)
    rows = t.placed.rows
    assert rows[1].blocks[0].mlp.wi.w_q is rows[0].blocks[0].mlp.wi.w_q
    assert len(t._host_params) == len({id(x) for x in t.placed.param_tensors()})
    t.train_step(tiny[-1][0])
    assert rows[1].blocks[0].mlp.wi.w_q.data_ptr() == rows[0].blocks[0].mlp.wi.w_q.data_ptr()
    assert _on_host(t)


def test_fsdp_optimizer_offload_matches_jax_trainer(tiny, tmp_path):
    """JAX test_host_offload.py's fsdp {"data": 2} run (full fine-tuning,
    optimizer offload, lr 1e-3) against the JAX trainer with the same
    offload: losses and grad_norm by the tolerances, every leaf of the
    parameters by the move rule's norm bound over the whole tree."""
    cfg, params, _, _, data = tiny
    axes = {"data": 2}
    common = dict(lr=1e-3, grad_accum=2, max_grad_norm=1.0, strategy="fsdp", mesh_axes=axes,
                  host_offload="optimizer")
    jt = jtrainer.Trainer(jtrainer.TrainConfig(model=cfg, log_dir=str(tmp_path / "j"), **common),
                          params=jax.tree.map(jnp.array, params), mesh=jcreate_mesh(axes), total_steps=10)
    mcfg = ModelConfig.from_dict(dataclasses.asdict(cfg))
    tt = Trainer(TrainConfig(model=mcfg, log_dir=str(tmp_path / "t"), **common),
                 params=causal_from_jax(params, mcfg, device="cpu"), device="cpu", total_steps=10)
    jm, tm = [], []
    for b in data:
        jt.state, m = jt._run_step(jt.state, jt._device_batch(b))
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in tt.train_step(b).items()})
        assert _on_host(tt)
    assert_metrics_close(tm, jm)

    def leaves(tree):
        return _leaves_np(tree_leaves(params_tree(causal_from_jax(jax.tree.map(np.asarray, tree), mcfg, "cpu"))))

    before, theirs = leaves(params), leaves(jt.state["params"])
    mine = _leaves_np(tree_leaves(tt.whole_state()["params"]))
    d = np.concatenate([(m - j).ravel() for m, j in zip(mine, theirs)])
    moved = np.concatenate([(j - b).ravel() for j, b in zip(theirs, before)])
    assert np.linalg.norm(d) <= 0.25 * np.linalg.norm(moved)
