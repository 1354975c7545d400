"""Parity of the port's QLoRA training over nf4 / nf4-dq bases with the JAX
package, on the CPU: the loss and adapter gradients under each dequant
placement (fused, once, once_folded), a whole step (grad accumulation,
adamw), once / once_folded against fused over a short run, host offload,
profiler traces and sharded checkpoints both ways.

Tolerances: loss 1e-4 relative, each adapter gradient leaf within 5e-2 of
its largest entry, grad_norm 5e-2 relative (tests/test_torch_train_step.py
states why: bf16-rounded products).  Short runs: eval loss within 0.1 and
each adapter leaf within 0.25 of its largest entry of the fused run, the
JAX package's own bound (test_quantize_base.py:94-134).  Host offload and
checkpoints: bit-equal.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import causal_lm as jcl
from vietnamese_qa_system_tpu.models import config as jcfg
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models import quantize as jq
from vietnamese_qa_system_tpu.train import checkpoint as jckpt
from vietnamese_qa_system_tpu.train import optim as jopt
from vietnamese_qa_system_tpu.train import trainer as jtrainer
from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, adapter_from_jax, causal_from_jax,
                                                   clear_lora, dequantize_tree, loss_fn, merge_lora)
from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer, make_train_step, params_tree, perplexity_eval
from vietnamese_qa_system_tpu_torch.train import optim as topt
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
LR = 1e-2
LORA = dict(r=4, alpha=8)
CFG = dataclasses.replace(jcfg.phogpt_4b_class(), vocab_size=512, d_model=128, n_heads=4, n_layers=2, d_ff=256,
                          max_seq_len=128, use_flash_attention=False, scan_layers=False)


def _setup(mode, seed):
    params = jax.tree.map(np.asarray, jq.quantize_dense_tree(jcl.init_causal_lm(jax.random.key(seed), CFG), mode))
    rng = np.random.default_rng(seed)
    # B != 0, so the gradients of A are not zero
    adapter = jax.tree.map(lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
                           jlora.init_lora(jax.random.key(seed + 1), params, jlora.LoraConfig(**LORA)))
    return params, adapter, rng


def _batch(rng, shape):
    ids = rng.integers(3, CFG.vocab_size, shape).astype(np.int32)
    labels = ids.copy()
    labels[..., : shape[-1] // 4] = -100
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels}


def _grads_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), (np.abs(g - w).max(), np.abs(w).max())


@pytest.mark.parametrize("placement", ["fused", "once", "once_folded"])
@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
def test_loss_and_adapter_grads_match_jax(mode, placement):
    params, adapter, rng = _setup(mode, 0)
    mb = _batch(rng, (2, 40))
    lc = jlora.LoraConfig(**LORA)

    def jloss(ad):
        p = jlora.merge_lora(params, ad, lc)
        if placement != "fused":  # trainer.py:184-199
            p = jq.dequantize_tree(p, dtype=jnp.bfloat16, fold_lora=placement == "once_folded")
        return jcl.loss_fn(p, CFG, mb)

    # jitted, as the JAX trainer runs it
    (want, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(adapter)
    jgrads = [x.detach().numpy() for x in tree_leaves(adapter_from_jax(jax.tree.map(np.asarray, jgrads), "cpu"))]
    model = causal_from_jax(params, ModelConfig.from_dict(dataclasses.asdict(CFG)), device="cpu")
    tad = adapter_from_jax(adapter, device="cpu")
    merge_lora(model, tad, LoraConfig(**LORA))
    if placement != "fused":
        dequantize_tree(model, torch.bfloat16, fold_lora=placement == "once_folded")
    loss, _ = loss_fn(model, {k: torch.from_numpy(v.astype(np.int64)) for k, v in mb.items()})
    grads = torch.autograd.grad(loss, tree_leaves(tad))
    clear_lora(model)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    _grads_close([g.numpy() for g in grads], jgrads)


@pytest.mark.parametrize("placement", ["fused", "once_folded"])
@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
def test_train_step_matches_jax(mode, placement):
    """One step of the JAX package's jitted ``make_train_step`` (grad_accum
    2, adamw) and the port's: loss, grad_norm, and the base untouched."""
    params, adapter, rng = _setup(mode, 1)
    batch = _batch(rng, (2, 2, 40))
    lc = jlora.LoraConfig(**LORA)
    tx = jopt.make_optimizer("adamw", jopt.make_schedule("linear", LR, 10, 0))
    jstep = jtrainer.make_train_step(jtrainer.TrainConfig(model=CFG, lora=lc, quantize_base=mode, grad_accum=2,
                                                          qlora_dequant=placement), tx)
    jstate = {"params": jax.tree.map(jnp.array, params), "adapter": jax.tree.map(jnp.array, adapter),
              "opt_state": tx.init(jax.tree.map(jnp.array, adapter)), "step": jnp.zeros([], jnp.int32)}
    _, jm = jstep(jstate, {k: jnp.array(v) for k, v in batch.items()})
    tcfg = TrainConfig(model=ModelConfig.from_dict(dataclasses.asdict(CFG)), lora=LoraConfig(**LORA),
                       quantize_base=mode, grad_accum=2, qlora_dequant=placement)
    model = causal_from_jax(params, tcfg.model, device="cpu")
    tad = adapter_from_jax(adapter, device="cpu")
    ttx = topt.make_optimizer("adamw", topt.make_schedule("linear", LR, 10, 0))
    state = {"params": params_tree(model), "adapter": tad, "opt_state": ttx.init(tad),
             "step": torch.zeros((), dtype=torch.int32)}
    codes = model.blocks[0].mlp.wi.w_q.clone()
    state, m = make_train_step(tcfg, ttx, model)(state, {k: torch.from_numpy(v.astype(np.int64))
                                                         for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=5e-2)
    assert torch.equal(model.blocks[0].mlp.wi.w_q, codes)
    assert all(d.w_dequant is None for d in model.modules() if hasattr(d, "w_dequant"))


def _toy_batches(vocab, b=8, t=16, n=6, seed=0):
    """A memorizable dataset of fixed random sequences (tests/test_trainer.py)."""
    data = np.random.default_rng(seed).integers(4, vocab, (n, b, t)).astype(np.int32)
    return lambda: ({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids} for ids in data)


def _tiny(tmp_path, **kw):
    model = ModelConfig.from_dict(dataclasses.asdict(jcfg.tiny_test("causal")))
    return TrainConfig(**{"model": model, "lr": 5e-3, "log_dir": str(tmp_path), "seed": 3, **kw})


@pytest.mark.parametrize("placement", ["once", "once_folded"])
def test_once_placements_train_like_fused(tmp_path, placement):
    """The port's runs over an nf4 base end where the fused run does
    (test_quantize_base.py:94-134): same math, another schedule."""
    base = dict(lora=LoraConfig(r=8), epochs=4, quantize_base="nf4")
    batches = _toy_batches(512)
    runs = {}
    for name in ("fused", placement):
        t = Trainer(_tiny(tmp_path / name, qlora_dequant=name, **base), total_steps=24, device="cpu")
        t.fit(batches)
        runs[name] = (perplexity_eval(t.merged_params(), t.cfg.model, batches())["eval_loss"],
                      [x.detach().numpy() for x in tree_leaves(t.whole_state()["adapter"])])
    (loss_f, ad_f), (loss_o, ad_o) = runs["fused"], runs[placement]
    assert abs(loss_o - loss_f) <= 0.1, (loss_o, loss_f)
    for a, b in zip(ad_f, ad_o):
        assert np.abs(a - b).max() / max(np.abs(a).max(), 1e-6) <= 0.25


@pytest.mark.parametrize("offload", ["optimizer", "params", "all"])
def test_host_offload_matches_the_device_run(tmp_path, offload):
    """The persistent copies live in host memory (pinned only for a GPU)
    and the training is the device run's, bit for bit
    (test_host_offload.py:41-99): LoRA over an nf4-dq base, or a full
    fine-tune for ``params``."""
    kw = dict(epochs=2) if offload == "params" else dict(epochs=2, lora=LoraConfig(r=4), quantize_base="nf4-dq")
    batches = _toy_batches(512, n=3)
    dev = Trainer(_tiny(tmp_path / "a", **kw), total_steps=6, device="cpu")
    dev.fit(batches)
    off = Trainer(_tiny(tmp_path / "b", host_offload=offload, **kw), total_steps=6, device="cpu")
    hosts = (off._host_params or []) + (off._host_opt or [])
    assert hosts and all(h is None or (h.device.type == "cpu" and not h.is_pinned()) for h in hosts)
    off.fit(batches)
    for a, b in zip(tree_leaves(dev.whole_state()), tree_leaves(off.whole_state())):
        assert torch.equal(a.detach(), b.detach())
    if off._host_opt is not None:  # the state's leaves are the persistent copies
        assert all(h is None or leaf is h
                   for leaf, h in zip(tree_leaves(off.whole_state()["opt_state"]), off._host_opt))
    if off._host_params is not None:
        assert all(h is None or leaf.data_ptr() == h.data_ptr()
                   for leaf, h in zip(tree_leaves(off.whole_state()["params"]), off._host_params))
    ppl = perplexity_eval(off.merged_params(), off.cfg.model, batches())["eval_loss"]
    assert ppl == perplexity_eval(dev.merged_params(), dev.cfg.model, batches())["eval_loss"]


def test_invalid_offload_value(tmp_path):
    with pytest.raises(ValueError, match="host_offload"):
        Trainer(_tiny(tmp_path, host_offload="gpu"), total_steps=1, device="cpu")


def test_profile_steps_writes_a_trace(tmp_path, capsys):
    """The first step's torch.profiler trace (host operators on the CPU),
    with the step's span in it; the run goes on untraced."""
    prof_dir = str(tmp_path / "prof")
    t = Trainer(_tiny(tmp_path, lora=LoraConfig(r=4), quantize_base="nf4", profile_steps=1, profile_dir=prof_dir),
                total_steps=3, device="cpu")
    t.fit(_toy_batches(512, n=3))
    files = glob.glob(os.path.join(prof_dir, "trace_*.json"))
    assert len(files) == 1 and f"profiler trace written to {files[0]}" in capsys.readouterr().out
    with open(files[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("train.step") == 1 and int(t.whole_state()["step"]) == 3


def _jax_trainer(tmp_path, **kw):
    common = dict(lora=jlora.LoraConfig(r=4, alpha=8), quantize_base="nf4-dq", lr=1e-2,
                  log_dir=str(tmp_path / "logs"), log_every=1)
    return jtrainer.Trainer(jtrainer.TrainConfig(model=jcfg.tiny_test("causal"), **common, **kw), total_steps=4)


def _port_trainer(tmp_path, jt, **kw):
    tcfg = TrainConfig(model=ModelConfig.from_dict(dataclasses.asdict(jcfg.tiny_test("causal"))),
                       lora=LoraConfig(r=4, alpha=8), quantize_base="nf4-dq", lr=1e-2,
                       log_dir=str(tmp_path / "logs"), log_every=1, **kw)
    base = causal_from_jax(jax.tree.map(np.asarray, jt.state["params"]), tcfg.model, device="cpu")
    return Trainer(tcfg, params=base, total_steps=4, device="cpu")


def test_sharded_checkpoints_move_between_packages(tmp_path):
    """A JAX state over an nf4-dq base, sharded over 8 devices and written
    as two simulated hosts' files (``host_of``), restores into the port's
    trainer bit for bit; the port's sharded checkpoint (``host_0``) of its
    next step restores in the JAX trainer."""
    ids = np.random.default_rng(9).integers(4, 200, (8, 16)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids}
    jt = _jax_trainer(tmp_path, mesh_axes={"data": 8}, strategy="fsdp")
    jt.fit(lambda: [batch], max_steps=1)
    jdir = str(tmp_path / "jax")
    jckpt.CheckpointManager(jdir, sharded=True, host_of=lambda d: d.id // 4).save(1, jt.state, {"config": "jax"})
    assert sorted(f for f in os.listdir(os.path.join(jdir, "step_1")) if f.startswith("host_")) == [
        "host_0.layout.json", "host_0.npz", "host_1.layout.json", "host_1.npz"]
    with open(os.path.join(jdir, "step_1", "host_1.layout.json")) as f:
        assert any(e["index"][0] != [0, e["shape"][0]] for e in json.load(f)["entries"] if e["shape"])
    tt = _port_trainer(tmp_path, jt, checkpoint_dir=jdir, resume=True, sharded_checkpoint=True)
    assert tt.start_step == 1
    for a, b in zip(tree_leaves(tt.whole_state()), jax.tree.leaves(jt.state)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    pdir = str(tmp_path / "port")
    tt.cfg.checkpoint_dir = pdir
    tt.ckpt = type(tt.ckpt)(pdir, sharded=True)
    tt.fit(lambda: [batch, batch], max_steps=2)  # one more step, saved as step_2
    assert sorted(os.listdir(os.path.join(pdir, "step_2"))) == ["host_0.layout.json", "host_0.npz", "meta.json"]
    jt2 = _jax_trainer(tmp_path, checkpoint_dir=pdir, resume=True, mesh_axes={"data": 1})
    assert jt2.start_step == 2
    for a, b in zip(tree_leaves(tt.whole_state()), jax.tree.leaves(jt2.state)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_sharded_restore_refuses_missing_and_incomplete_leaves(tmp_path):
    from vietnamese_qa_system_tpu_torch.train.checkpoint import load_pytree_sharded, save_pytree_sharded

    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4), "b": torch.ones(5, dtype=torch.bfloat16),
            "s": torch.tensor(7, dtype=torch.int32)}
    save_pytree_sharded(str(tmp_path), tree)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    back = load_pytree_sharded(str(tmp_path), like)
    assert all(torch.equal(back[k], tree[k]) and back[k].dtype == tree[k].dtype for k in tree)
    path = tmp_path / "host_0.layout.json"
    layout = json.loads(path.read_text())
    layout["entries"][0]["index"][0] = [0, 2]  # leaf 0 covers 2 of its 3 rows
    layout["entries"][0]["key"] = "short"
    with np.load(tmp_path / "host_0.npz") as data:
        arrays = dict(data)
    arrays["short"] = arrays["l0_s0"][:2]
    np.savez(tmp_path / "host_0.npz", **arrays)
    path.write_text(json.dumps(layout))
    with pytest.raises(ValueError, match="leaf 0 incomplete"):
        load_pytree_sharded(str(tmp_path), like)
    layout["entries"] = layout["entries"][1:]
    path.write_text(json.dumps(layout))
    with pytest.raises(ValueError, match="leaf 0 missing"):
        load_pytree_sharded(str(tmp_path), like)


def test_profiling_and_tracing_utilities_match_jax(tmp_path):
    """The port's copies of core/profiling.py and core/tracing.py against
    the JAX package's on the CPU, where neither device has memory
    statistics."""
    from vietnamese_qa_system_tpu.core import profiling as jprof
    from vietnamese_qa_system_tpu_torch.core import profiling as tprof
    from vietnamese_qa_system_tpu_torch.core import tracing as ttrace

    for n in (0, 1 << 20, 123456789, 2.5e9):
        assert tprof.bytes_to_mb(n) == jprof.bytes_to_mb(n)
    timed = tprof.timeit(lambda x: sum(range(x)))
    assert timed(10_000) == sum(range(10_000)) and timed.last_seconds > 0
    stats = tprof.device_memory_stats("cpu")
    assert stats == {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0, "supported": False}
    assert jprof.device_memory_stats(jax.devices("cpu")[0])["supported"] is False
    with tprof.MemoryTracker("cpu") as mem:
        block = bytearray(3 << 20)
    assert not mem.device_supported and mem.peaked == 0 and mem.cpu_peaked >= 3.0 and len(block) == 3 << 20
    err = tmp_path / "err.json"

    @ttrace.record_errors(error_file=str(err))
    def boom():
        raise RuntimeError("xảy ra lỗi")

    with pytest.raises(RuntimeError):
        boom()
    rec = json.loads(err.read_text())
    assert rec["type"] == "RuntimeError" and rec["message"] == "xảy ra lỗi" and rec["process_index"] == 0
    with ttrace.trace(str(tmp_path / "prof"), device="cpu"):
        torch.ones(8) @ torch.ones(8)
    files = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    assert len(files) == 1 and any(e.get("name") == "aten::matmul" for e in json.load(open(files[0]))["traceEvents"])
