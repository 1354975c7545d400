"""Full fine-tuning over a mesh against the JAX ``Trainer`` on the same
mesh shape (test_torch_mesh_train.py's helpers and tolerances: the trained
leaves are every parameter), and where each strategy keeps the state:
the counterparts of JAX ``tests/test_trainer.py::
test_zero2_shards_optimizer_state_only`` and ``::test_fsdp_shards_params``
(as per-position parts between steps, and as the bytes a position
holds), and the vocabulary-split loss of a tensor-parallel head."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_mesh_train import (LR, STRATEGIES, _common, _leaves_np, assert_metrics_close, assert_moves_close,
                                   jax_grads, setup, train_both)
from vietnamese_qa_system_tpu_torch.core.mesh import create_mesh
from vietnamese_qa_system_tpu_torch.models import LoraConfig, ModelConfig, causal_from_jax, init_causal_lm
from vietnamese_qa_system_tpu_torch.ops.xent import masked_mean_xent
from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer, params_tree
from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths, nest, tree_leaves

torch.set_num_threads(2)


@pytest.mark.parametrize("strategy,axes", STRATEGIES)
def test_full_finetune_step_matches_jax_trainer(tmp_path, strategy, axes):
    cfg, params, _, data = setup(lora=False)
    tm, jm, tt, jt = train_both(cfg, params, None, data, strategy, axes, None, tmp_path)
    assert_metrics_close(tm, jm)
    mcfg = tt.cfg.model
    before = _leaves_np(tree_leaves(params_tree(causal_from_jax(params, mcfg, "cpu"))))
    theirs = _leaves_np(tree_leaves(params_tree(causal_from_jax(jax.tree.map(np.asarray, jt.state["params"]), mcfg,
                                                                "cpu"))))
    mine = _leaves_np(tree_leaves(tt.whole_state()["params"]))
    grads = jax_grads(cfg, params, None, {k: v[:4] for k, v in data[0].items()})
    # the key bias's true gradient is zero (it shifts each query's logits by
    # one constant): its entries move by Adam-normalised rounding noise
    names = tree_leaves(nest({k: k for k in flatten_paths(tt.whole_state()["params"])}))
    keep = [i for i, n in enumerate(names) if not n.endswith("attn.wk.b")]
    assert len(keep) == len(names) - cfg.n_layers
    assert_moves_close(*([x[i] for i in keep] for x in (before, mine, theirs, grads)))


def _trainer(tmp_path, strategy, axes, lora=False):
    cfg = ModelConfig.from_dict(dataclasses.asdict(setup(lora=False)[0]))
    tc = TrainConfig(model=cfg, strategy=strategy, mesh_axes=axes, log_dir=str(tmp_path),
                     lora=LoraConfig(r=4, alpha=8) if lora else None, **_common(None))
    return Trainer(tc, params=init_causal_lm(cfg, torch.Generator().manual_seed(0)), device="cpu", total_steps=4)


def test_zero2_shards_optimizer_state_only(tmp_path):
    """ZeRO-2: every position holds the whole parameters; the optimizer's
    moments are parts, one a data position, on the fsdp spec's dim."""
    dp, z2 = _trainer(tmp_path, "dp", {"data": 4}), _trainer(tmp_path, "zero2", {"data": 4})
    m = z2.placed
    assert all(p.index == tuple(slice(0, d) for d in m.param_shapes[n][0]) for n in m.pieces for p in m.pieces[n])
    split = [n for n in m.train_names if len(m.units_of[n]) == 4]
    assert split, "zero2 must shard optimizer state across the data axis"
    w = "blocks.0.mlp.wi.w"  # (128, 512): its moments split on the 512 columns
    assert [tuple(s.stop - s.start for s in u.index) for u in m.units_of[w]] == [(128, 128)] * 4
    mu = m.opt_state[1].mu  # clip, adam, lr: the moments mirror the units
    assert [tuple(mu[k].shape) for k, u in enumerate(m.units) if u.leaf == w] == [(128, 128)] * 4
    bd, bz = dp.position_bytes(), z2.position_bytes()
    for pos in bz:
        assert bz[pos]["param_bytes"] == bd[pos]["param_bytes"]
        assert bz[pos]["opt_bytes"] < 0.3 * bd[pos]["opt_bytes"]


def test_fsdp_shards_params(tmp_path):
    """fsdp: between steps each row's module holds only its part of every
    divisible leaf (a tensor of its own), gathered whole while its layer
    runs; a position holds about a quarter of dp's parameter bytes."""
    dp, fs = _trainer(tmp_path, "dp", {"data": 4}), _trainer(tmp_path, "fsdp", {"data": 4})
    rows = fs.placed.rows
    shapes = [tuple(r.blocks[0].mlp.wi.w.shape) for r in rows]
    assert shapes == [(128, 128)] * 4
    assert len({r.blocks[0].mlp.wi.w.data_ptr() for r in rows}) == 4
    assert tuple(rows[2].tok_embed.shape) == (128, 128)  # (512, 128) split on the vocabulary
    data = setup(lora=False)[3]
    m = fs.train_step(data[0])
    assert np.isfinite(float(m["loss"])) and tuple(rows[0].blocks[1].attn.wq.w.shape) == (32, 128)
    bd, bf = dp.position_bytes(), fs.position_bytes()
    for pos in bf:
        assert bf[pos]["param_bytes"] <= bd[pos]["param_bytes"] / 3
        assert bf[pos]["opt_bytes"] <= bd[pos]["opt_bytes"] / 3


def test_split_vocabulary_loss_matches_whole(tmp_path):
    """The chunked loss over a vocabulary split in four parts (the
    tensor-parallel head at a vocabulary of 16,384, where the loss streams)
    against the whole classifier: loss, dH and every part's dW (within
    1e-4 of the largest entry)."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((16, 16384)).astype(np.float32) * 0.1).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, 16384, (2, 9)))
    labels[0, :3] = -100
    whole, n = masked_mean_xent(h, w, labels, chunk=1024)
    gh, gw = torch.autograd.grad(whole, [h, w])
    parts = [w[:, j * 4096:(j + 1) * 4096] for j in range(4)]
    split, n2 = masked_mean_xent(h, parts, labels, chunk=1024)
    sh, sw = torch.autograd.grad(split, [h, w])
    assert int(n) == int(n2)
    # the parts' logsumexps combine in another order: ulps of f32
    np.testing.assert_allclose(float(split.detach()), float(whole.detach()), rtol=1e-6)
    for mine, want in ((sh, gh), (sw, gw)):
        assert np.abs(mine.numpy() - want.numpy()).max() <= 1e-4 * np.abs(want.numpy()).max()


def test_tp_chunked_loss_step_matches_one_device(tmp_path):
    """A PhoGPT-like model (MPT ALiBi, tied head, vocabulary 16,384: the
    chunked loss) under tp on ``{"model": 4}`` and fsdp_tp on ``{"data": 2,
    "model": 2}``, int8 base + LoRA, against the one-device trainer: the
    heads, the vocabulary-split head and the split loss on every part."""
    from vietnamese_qa_system_tpu.models import config as jcfg

    cfg = ModelConfig.from_dict(dataclasses.asdict(dataclasses.replace(
        jcfg.phogpt_4b_class(), vocab_size=16384, d_model=64, n_heads=8, n_layers=2, d_ff=256, max_seq_len=64,
        scan_layers=True, remat_policy="proj_bf16")))
    rng = np.random.default_rng(1)
    ids = rng.integers(3, cfg.vocab_size, (8, 24)).astype(np.int32)
    labels = ids.copy()
    labels[:, :6] = -100
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels}
    out = {}
    for strategy, axes in (("dp", None), ("tp", {"model": 4}), ("fsdp_tp", {"data": 2, "model": 2})):
        base = init_causal_lm(cfg, torch.Generator().manual_seed(0), quantize="int8")
        tc = TrainConfig(model=cfg, strategy=strategy, mesh_axes=axes, log_dir=str(tmp_path), quantize_base="int8",
                         lora=LoraConfig(r=4, alpha=8), lr=LR, grad_accum=2)
        t = Trainer(tc, params=base, device="cpu", total_steps=4)
        m = t.train_step(batch)
        out[strategy] = {k: float(v) for k, v in m.items()}
    for strategy in ("tp", "fsdp_tp"):
        np.testing.assert_allclose(out[strategy]["loss"], out["dp"]["loss"], rtol=1e-4)
        np.testing.assert_allclose(out[strategy]["grad_norm"], out["dp"]["grad_norm"], rtol=5e-2)


def test_mesh_grid_positions():
    """``Mesh.grid`` lists the devices by (data, model) position whatever
    the axis order; an absent axis counts as one."""
    mesh = create_mesh({"model": 2, "data": 3}, devices=[torch.device("cpu")] * 6)
    assert [len(r) for r in mesh.grid()] == [2, 2, 2]
    assert [len(r) for r in create_mesh({"data": 4}, devices=["cpu"] * 4).grid()] == [1, 1, 1, 1]
    assert [len(r) for r in create_mesh({"model": 4}, devices=["cpu"] * 4).grid()] == [4]
