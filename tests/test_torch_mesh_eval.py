"""Eval over a mesh's data axis and checkpoints across meshes, on the CPU:
the counterparts of JAX ``tests/test_eval_multidevice.py`` (the port's
``perplexity_eval(mesh=)`` and ``generative_eval(mesh=)`` over ``[cpu] *
4`` give the one-device numbers and predictions, which match the JAX
package's), the eval of a trainer's own rows, and the counterpart of JAX
``tests/test_sharded_checkpoint.py::test_trainer_sharded_checkpoint_resume``:
a trainer's checkpoint saved under fsdp restores bit for bit on one
device, and that one's under tp, in both checkpoint formats.

Tolerances: perplexity 1e-5 relative between the one-device and the split
run (the same per-row f32 sums added in another order); 1e-4 against the
JAX package (bf16-rounded products, as test_torch_train.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import causal_lm as jcl
from vietnamese_qa_system_tpu.models import config as jcfg
from vietnamese_qa_system_tpu.train import perplexity_eval as jperplexity
from vietnamese_qa_system_tpu_torch.core.mesh import create_mesh
from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
from vietnamese_qa_system_tpu_torch.models import (GenerationConfig, LoraConfig, ModelConfig, causal_from_jax,
                                                   init_seq2seq_model)
from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer, generative_eval, perplexity_eval
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
MESH = create_mesh({"data": 4}, devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def causal():
    cfg = jcfg.tiny_test("causal")
    params = jax.tree.map(np.asarray, jcl.init_causal_lm(jax.random.key(0), cfg))
    mcfg = ModelConfig.from_dict(dataclasses.asdict(cfg))
    return cfg, params, causal_from_jax(params, mcfg, device="cpu")


def _ppl_batches(n=3, b=8, t=16):
    rng = np.random.default_rng(1)
    for _ in range(n):
        ids = rng.integers(4, 260, (b, t)).astype(np.int32)
        labels = ids.copy()
        labels[:2, :9] = -100  # rows of unequal target counts
        yield {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels}


def _prompt_batches(tok, n=2, b=8, t=12):
    rng = np.random.default_rng(2)
    for _ in range(n):
        ids = rng.integers(4, 260, (b, t)).astype(np.int32)
        mask = np.ones_like(ids)
        ids[0, :3] = tok.pad_id
        mask[0, :3] = 0
        yield {"input_ids": ids, "attention_mask": mask}


def test_perplexity_identical_single_vs_data_sharded(causal):
    cfg, params, model = causal
    single = perplexity_eval(model, model.cfg, _ppl_batches())
    sharded = perplexity_eval(model, model.cfg, _ppl_batches(), mesh=MESH)
    assert single["eval_tokens"] == sharded["eval_tokens"] == 3 * (8 * 15 - 2 * 8)
    np.testing.assert_allclose(sharded["eval_loss"], single["eval_loss"], rtol=1e-5)
    np.testing.assert_allclose(sharded["perplexity"], single["perplexity"], rtol=1e-5)
    want = jperplexity(params, cfg, _ppl_batches())
    assert want["eval_tokens"] == sharded["eval_tokens"]
    np.testing.assert_allclose(sharded["eval_loss"], want["eval_loss"], rtol=1e-4)


def test_perplexity_seq2seq_sharded():
    cfg = ModelConfig.from_dict(dataclasses.asdict(jcfg.tiny_test("seq2seq")))
    model = init_seq2seq_model(cfg, torch.Generator().manual_seed(3))

    def batches():
        rng = np.random.default_rng(4)
        for _ in range(2):
            enc = rng.integers(4, 260, (8, 12)).astype(np.int32)
            lab = rng.integers(4, 260, (8, 10)).astype(np.int32)
            yield {"input_ids": enc, "attention_mask": np.ones_like(enc), "labels": lab}

    single = perplexity_eval(model, cfg, batches())
    sharded = perplexity_eval(model, cfg, batches(), mesh=MESH)
    assert single["eval_tokens"] == sharded["eval_tokens"]
    np.testing.assert_allclose(sharded["eval_loss"], single["eval_loss"], rtol=1e-5)


def test_generative_eval_identical_single_vs_data_sharded(causal):
    _, _, model = causal
    tok = ByteTokenizer()
    gen = GenerationConfig(max_new_tokens=8, temperature=0.0)
    single = generative_eval(model, model.cfg, tok, _prompt_batches(tok), gen_config=gen)
    sharded = generative_eval(model, model.cfg, tok, _prompt_batches(tok), gen_config=gen, mesh=MESH)
    assert [r["prediction"] for r in single["records"]] == [r["prediction"] for r in sharded["records"]]
    assert sharded["n_examples"] == 16


def test_generative_eval_flash_model_sharded():
    """The flagship config (flash + per-layer remat) through the split path."""
    cfg = ModelConfig.from_dict(dataclasses.asdict(dataclasses.replace(
        jcfg.tiny_test("causal"), use_flash_attention=True, scan_layers=True)))
    from vietnamese_qa_system_tpu_torch.models import init_causal_lm

    model = init_causal_lm(cfg, torch.Generator().manual_seed(5))
    tok = ByteTokenizer()
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0)
    out = generative_eval(model, cfg, tok, _prompt_batches(tok, n=1), gen_config=gen, mesh=MESH)
    single = generative_eval(model, cfg, tok, _prompt_batches(tok, n=1), gen_config=gen)
    assert out["n_examples"] == 8 and out["records"] == single["records"]


@pytest.mark.parametrize("strategy,axes", [("fsdp", {"data": 4}), ("fsdp_tp", {"data": 2, "model": 2})])
def test_eval_on_the_trainers_rows(causal, tmp_path, strategy, axes):
    """A LoRA trainer's rows (fsdp: each gathers its layers as it runs)
    evaluate as the one-device trainer's merged model does."""
    _, params, _ = causal
    mcfg = ModelConfig.from_dict(dataclasses.asdict(jcfg.tiny_test("causal")))
    outs = []
    for ax in (None, axes):
        tc = TrainConfig(model=mcfg, strategy=strategy, mesh_axes=ax, lora=LoraConfig(r=4, alpha=8), lr=1e-2,
                         log_dir=str(tmp_path))
        t = Trainer(tc, params=causal_from_jax(params, mcfg, device="cpu"), device="cpu", total_steps=4)
        batch = next(_ppl_batches(n=1))
        t.train_step(batch)
        rows = t.merged_replicas()
        outs.append(perplexity_eval(rows if t.mesh is not None else rows[0], mcfg, _ppl_batches(), mesh=t.mesh))
    np.testing.assert_allclose(outs[1]["eval_loss"], outs[0]["eval_loss"], rtol=1e-4)
    assert outs[1]["eval_tokens"] == outs[0]["eval_tokens"]


@pytest.mark.parametrize("sharded", [False, True])
def test_checkpoint_roundtrip_fsdp_one_device_tp(causal, tmp_path, sharded):
    """Full fine-tuning under fsdp on ``{"data": 4}`` saves every leaf whole
    (one host file); a one-device trainer resumes it bit for bit and saves
    again; a tp trainer on ``{"model": 4}`` resumes that bit for bit and
    trains on."""
    _, params, _ = causal
    mcfg = ModelConfig.from_dict(dataclasses.asdict(jcfg.tiny_test("causal")))
    batch = next(_ppl_batches(n=1))

    def trainer(strategy, axes, ck, resume=False):
        tc = TrainConfig(model=mcfg, strategy=strategy, mesh_axes=axes, lr=1e-2, log_dir=str(tmp_path),
                         checkpoint_dir=str(tmp_path / ck), sharded_checkpoint=sharded, resume=resume)
        return Trainer(tc, params=causal_from_jax(params, mcfg, device="cpu"), device="cpu", total_steps=8)

    fs = trainer("fsdp", {"data": 4}, "a")
    fs.fit(lambda: [batch], max_steps=1)
    saved = [x.detach().clone() for x in tree_leaves(fs.whole_state())]
    one = trainer("dp", None, "a", resume=True)
    assert one.start_step == 1
    assert all(torch.equal(a, b.cpu()) for a, b in zip(saved, tree_leaves(one.whole_state())))
    one.ckpt = type(one.ckpt)(str(tmp_path / "b"), sharded=sharded)
    one.save(1)
    tp = trainer("tp", {"model": 4}, "b", resume=True)
    assert tp.start_step == 1
    assert all(torch.equal(a, b) for a, b in zip(saved, tree_leaves(tp.whole_state())))
    m = tp.train_step(batch)
    m1 = one.train_step(batch)
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]), rtol=1e-4)
