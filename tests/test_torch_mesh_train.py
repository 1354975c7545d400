"""The port's trainer over a mesh against the JAX ``Trainer`` on the same
mesh shape, on the CPU: each strategy of JAX ``tests/test_trainer.py::
test_sharded_train_step`` at 4 positions (dp, zero2 and fsdp on
``{"data": 4}``, tp on ``{"model": 4}``, fsdp_tp on ``{"data": 2,
"model": 2}``): LoRA over an int8 base here, full fine-tuning (with the
placement checks) in test_torch_mesh_train_full.py.  The JAX side runs on the
conftest's virtual CPU devices, the port on ``[cpu] * 4``; both take the
same ``tiny_test("causal")`` weights, adapter and numpy batches (global
batch 8, ``grad_accum`` 2: one row a data position).  LoRA over a float
base and the seq2seq cases are in test_torch_mesh_train_float.py; the
helpers here serve both files.

Tolerances, as test_torch_train_step.py's: the loss 1e-4 relative at step
1 and 1e-3 at step 2; ``grad_norm`` 5e-2 relative; the trained leaves
after two adamw steps: over the elements whose first JAX gradient exceeds
5% of the leaf's largest entry, the median difference of the moves within
5% of lr, and the norm of the difference within 25% of the JAX move's
norm (Adam moves a noise-level element by about lr either way).  Splits
sum the same f32 products in another order (row-parallel sums, the
vocabulary-split loss, gradients summed over rows)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.core.mesh import create_mesh as jcreate_mesh
from vietnamese_qa_system_tpu.models import causal_lm as jcl
from vietnamese_qa_system_tpu.models import config as jcfg
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models.quantize import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu.train import trainer as jtrainer
from vietnamese_qa_system_tpu_torch.models import LoraConfig, ModelConfig, adapter_from_jax, causal_from_jax
from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer, params_tree
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

LR = 1e-2
LORA = dict(r=4, alpha=8)
STRATEGIES = [("dp", {"data": 4}), ("zero2", {"data": 4}), ("fsdp", {"data": 4}), ("tp", {"model": 4}),
              ("fsdp_tp", {"data": 2, "model": 2})]


def batches(vocab, seed=0, n=2, b=8, t=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(3, vocab, (b, t)).astype(np.int32)
        labels = ids.copy()
        labels[:, : t // 4] = -100
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels})
    return out


def setup(arch="causal", quantize=None, lora=True, seed=0):
    """(JAX config, numpy params, numpy adapter or None, batches)."""
    cfg = jcfg.tiny_test(arch)
    init = jcl.init_causal_lm if arch == "causal" else jtrainer.init_model_params
    params = init(jax.random.key(seed), cfg) if arch == "causal" else init(cfg, jax.random.key(seed))
    if quantize:
        params = jquant(params, quantize)
    params = jax.tree.map(np.asarray, params)
    adapter = None
    if lora:
        rng = np.random.default_rng(seed)
        # B != 0, so the gradients of A are not zero at the first step
        adapter = jax.tree.map(lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
                               jlora.init_lora(jax.random.key(seed + 1), params, jlora.LoraConfig(**LORA)))
    return cfg, params, adapter, batches(cfg.vocab_size, seed)


def _common(quantize):
    return dict(lr=LR, grad_accum=2, quantize_base=quantize, max_grad_norm=1.0)


def jax_trainer(cfg, params, adapter, strategy, axes, quantize, tmp_path):
    lc = jlora.LoraConfig(**LORA) if adapter is not None else None
    jt = jtrainer.Trainer(jtrainer.TrainConfig(model=cfg, strategy=strategy, mesh_axes=axes, lora=lc,
                                               log_dir=str(tmp_path / "jlogs"), **_common(quantize)),
                          params=jax.tree.map(jnp.array, params), mesh=jcreate_mesh(axes), total_steps=10)
    if adapter is not None:
        jt.state["adapter"] = jax.device_put(jax.tree.map(jnp.array, adapter), jt._state_shardings["adapter"])
    return jt


def port_trainer(cfg, params, adapter, strategy, axes, quantize, tmp_path):
    mcfg = ModelConfig.from_dict(dataclasses.asdict(cfg))
    from_jax = causal_from_jax if cfg.arch == "causal" else _s2s_from_jax
    tc = TrainConfig(model=mcfg, strategy=strategy, mesh_axes=axes,
                     lora=LoraConfig(**LORA) if adapter is not None else None, log_dir=str(tmp_path / "tlogs"),
                     **_common(quantize))
    t = Trainer(tc, params=from_jax(params, mcfg, device="cpu"), device="cpu", total_steps=10)
    if adapter is not None:
        t.load_state(dict(t.whole_state(), adapter=adapter_from_jax(adapter, device="cpu")))
    return t


def _s2s_from_jax(params, cfg, device):
    from vietnamese_qa_system_tpu_torch.models import seq2seq_from_jax

    return seq2seq_from_jax(params, cfg, device=device)


def jax_grads(cfg, params, adapter, mb):
    """The first microbatch's JAX gradient of the trained tree (jitted), as
    the port's leaf list."""
    if adapter is not None:
        def loss(ad):
            return jcl.loss_fn(jlora.merge_lora(params, ad, jlora.LoraConfig(**LORA)), cfg, mb)

        grads = jax.jit(jax.grad(lambda a: loss(a)[0]))(jax.tree.map(jnp.array, adapter))
        return [x.detach().numpy() for x in tree_leaves(adapter_from_jax(jax.tree.map(np.asarray, grads), "cpu"))]
    grads = jax.jit(jax.grad(lambda p: jcl.loss_fn(p, cfg, mb)[0]))(jax.tree.map(jnp.array, params))
    port = causal_from_jax(jax.tree.map(np.asarray, grads), ModelConfig.from_dict(dataclasses.asdict(cfg)), "cpu")
    return [t.detach().numpy() for t in tree_leaves(params_tree(port))]


def train_both(cfg, params, adapter, data, strategy, axes, quantize, tmp_path):
    """(port metrics, JAX metrics, port trainer, JAX trainer) after a step a batch."""
    jt = jax_trainer(cfg, params, adapter, strategy, axes, quantize, tmp_path)
    tt = port_trainer(cfg, params, adapter, strategy, axes, quantize, tmp_path)
    jm, tm = [], []
    for b in data:
        jt.state, m = jt._run_step(jt.state, jt._device_batch(b))
        jm.append({k: float(v) for k, v in m.items()})
        m = tt.train_step(b)
        tm.append({k: float(v) for k, v in m.items()})
    return tm, jm, tt, jt


def assert_metrics_close(tm, jm):
    for i, (mine, theirs) in enumerate(zip(tm, jm)):
        np.testing.assert_allclose(mine["loss"], theirs["loss"], rtol=1e-4 if i == 0 else 1e-3)
        np.testing.assert_allclose(mine["grad_norm"], theirs["grad_norm"], rtol=5e-2)


def assert_moves_close(before, mine, theirs, grads):
    """The trained leaves' moves by the rule of the module docstring."""
    assert len(before) == len(mine) == len(theirs) == len(grads)
    checked = 0
    for b0, m, j, g in zip(before, mine, theirs, grads):
        moved_j = j - b0
        sure = np.abs(g) > 0.05 * np.abs(g).max() if np.abs(g).max() > 0 else np.zeros(g.shape, bool)
        if not sure.any():
            continue
        d = np.abs((m - b0) - moved_j)
        assert np.median(d[sure]) <= 0.05 * LR, np.median(d[sure]) / LR
        assert np.linalg.norm(d) <= 0.25 * np.linalg.norm(moved_j) + 1e-9, \
            np.linalg.norm(d) / np.linalg.norm(moved_j)
        checked += 1
    assert checked


def _leaves_np(tree):
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.detach().float().numpy()
            for x in tree]


def check_lora_step(tmp_path, strategy, axes, quantize):
    cfg, params, adapter, data = setup(quantize=quantize)
    tm, jm, tt, jt = train_both(cfg, params, adapter, data, strategy, axes, quantize, tmp_path)
    assert_metrics_close(tm, jm)
    assert int(tt.whole_state()["step"]) == 2
    before = [x.detach().numpy() for x in tree_leaves(adapter_from_jax(adapter, "cpu"))]
    mb0 = {k: v[:4] for k, v in data[0].items()}
    grads = jax_grads(cfg, params, adapter, mb0)
    mine = _leaves_np(tree_leaves(tt.whole_state()["adapter"]))
    theirs = [x.detach().numpy() for x in tree_leaves(adapter_from_jax(jax.tree.map(np.asarray,
                                                                                    jt.state["adapter"]), "cpu"))]
    assert_moves_close(before, mine, theirs, grads)
    # the frozen base is untouched
    assert all(np.array_equal(a, b) for a, b in zip(_leaves_np(tree_leaves(tt.whole_state()["params"])),
                                                    _leaves_np(tree_leaves(params_tree(causal_from_jax(
                                                        params, tt.cfg.model, "cpu"))))))


@pytest.mark.parametrize("strategy,axes", STRATEGIES)
def test_lora_step_matches_jax_trainer(tmp_path, strategy, axes):
    check_lora_step(tmp_path, strategy, axes, "int8")


def test_no_replicated_leaf_is_updated_more_than_once(tmp_path):
    """dp over ``[cpu] * 4``: the rows' parameters are the same tensors (a
    repeated device keeps one copy), yet full fine-tuning moves them once:
    as far as the one-device trainer moves them (an update applied once a
    row would move them four times as far), and every row still holds the
    first row's values."""
    cfg, params, _, data = setup(lora=False)
    mcfg = ModelConfig.from_dict(dataclasses.asdict(cfg))
    runs = {}
    for axes in (None, {"data": 4}):
        t = Trainer(TrainConfig(model=mcfg, strategy="dp", mesh_axes=axes, log_dir=str(tmp_path), **_common(None)),
                    params=causal_from_jax(params, mcfg, device="cpu"), device="cpu", total_steps=10)
        t.train_step(data[0])
        runs[str(axes)] = t
    mesh_t = runs[str({"data": 4})]
    rows = mesh_t.placed.rows
    assert rows[1].blocks[0].mlp.wi.w is rows[0].blocks[0].mlp.wi.w  # one tensor for four rows
    before = _leaves_np(tree_leaves(params_tree(causal_from_jax(params, mcfg, "cpu"))))
    one = _leaves_np(tree_leaves(runs["None"].whole_state()["params"]))
    mesh = _leaves_np(tree_leaves(mesh_t.whole_state()["params"]))
    for b0, o, m in zip(before, one, mesh):
        ratio = np.linalg.norm(m - b0) / np.linalg.norm(o - b0)
        assert 0.75 < ratio < 1.25, ratio
    for row in rows[1:]:
        for a, b in zip(row.state_dict().values(), rows[0].state_dict().values()):
            assert torch.equal(a, b)


def test_tp_seq2seq_is_refused(tmp_path):
    """A seq2seq model under tp over a model axis is no longer refused: its
    rows are the family's tensor-parallel form, and its first loss is the
    one of tp without a model axis (which is dp) within 1e-4 (the
    parity with JAX is test_torch_mesh_train_s2s.py's)."""
    from vietnamese_qa_system_tpu_torch.models.families import TPEncoderDecoder

    cfg, params, adapter, data = setup(arch="seq2seq")
    split = port_trainer(cfg, params, adapter, "tp", {"model": 4}, None, tmp_path)
    assert isinstance(split.placed.rows[0], TPEncoderDecoder) and split.placed.rows[0].groups is not None
    t = port_trainer(cfg, params, adapter, "tp", {"data": 4}, None, tmp_path)
    m = t.train_step(data[0])
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(split.train_step(data[0])["loss"]), float(m["loss"]), rtol=1e-4)
