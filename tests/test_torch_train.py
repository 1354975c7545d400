"""Parity of the port's training pieces with the JAX package, on the CPU:
the chunked cross-entropy, LoRA init / merge, the four optimizers and the
schedules (against optax), the blockwise 8-bit moments, the data loader
(bit-identical batches), checkpoints (a JAX checkpoint resumes in the port
and back), and ``cli train``.  The model-level train step is in
test_torch_train_step.py.  Tolerances are stated per test."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vietnamese_qa_system_tpu.data import loader as jloader
from vietnamese_qa_system_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from vietnamese_qa_system_tpu.etl.parsers.builtin import GenericInstructParser
from vietnamese_qa_system_tpu.models import config as jcfg
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models import causal_lm as jcl
from vietnamese_qa_system_tpu.models.quantize import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu.ops import xent as jxent
from vietnamese_qa_system_tpu.train import optim as jopt
from vietnamese_qa_system_tpu.train import trainer as jtrainer
from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main
from vietnamese_qa_system_tpu_torch.data import ByteTokenizer, DataFileSpec, QADataLoader
from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, adapter_from_jax, adapter_to_jax,
                                                   causal_from_jax, clear_lora, count_params, init_causal_lm,
                                                   init_lora, merge_lora)
from vietnamese_qa_system_tpu_torch.models import loss_fn as causal_loss
from vietnamese_qa_system_tpu_torch.ops import xent as txent
from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer
from vietnamese_qa_system_tpu_torch.train import optim as topt
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "examples", "sample_instruct.jsonl")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------- xent


@pytest.mark.parametrize("v,chunk", [(1000, 256), (512, 512), (300, 4096)])
def test_chunked_xent_matches_jax(v, chunk):
    """Loss and both gradients, the clamped overlapping last chunk
    included (1000 = 3 x 256 + 232).  Tolerance 1e-4 (abs) on the f32 NLL
    and 1e-4 relative to the largest gradient entry: the same bf16-rounded
    products, f32 sums in another order."""
    rng = np.random.default_rng(v)
    h = rng.standard_normal((24, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal((64, v))).astype(np.float32)
    tgt = rng.integers(0, v, 24).astype(np.int32)
    g = rng.standard_normal(24).astype(np.float32)
    want = np.asarray(jxent.chunked_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt), chunk))
    jdh, jdw = jax.grad(lambda a, b: jnp.sum(jxent.chunked_xent(a, b, jnp.asarray(tgt), chunk) * g),
                        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    got = txent.chunked_xent(th, tw, torch.from_numpy(tgt).long(), chunk)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)
    for mine, theirs in ((th.grad, jdh), (tw.grad, jdw)):
        theirs = np.asarray(theirs)
        assert np.abs(mine.numpy() - theirs).max() <= 1e-4 * np.abs(theirs).max()


def test_masked_mean_xent_matches_jax():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 9, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal((32, 700))).astype(np.float32)
    labels = rng.integers(0, 700, (2, 9)).astype(np.int32)
    labels[0, :4] = -100
    jl, jn = jxent.masked_mean_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), -100, 256)
    tl, tn = txent.masked_mean_xent(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels).long(), -100,
                                    256)
    assert int(tn) == int(jn) == 14
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)


# ------------------------------------------------------------------- lora


def _tiny_params(quantize=None, seed=0):
    cfg = jcfg.tiny_test("causal")
    params = jcl.init_causal_lm(jax.random.key(seed), cfg)
    if quantize:
        params = jquant(params, quantize)
    return cfg, _np_tree(params)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_init_and_merge_lora_match_jax(quantize):
    """init_lora targets the same leaves with the same shapes (A ~ N(0,
    1/r^2), B = 0); with the same adapter the merged forward equals the JAX
    package's merged forward (logits max abs 2e-2, mean 1e-3: bf16-rounded
    products, as in test_torch_causal.py)."""
    cfg, params = _tiny_params(quantize)
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    jad = _np_tree(jlora.init_lora(jax.random.key(1), params, lcfg))
    model = causal_from_jax(params, ModelConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tad = init_lora(torch.Generator().manual_seed(1), model, LoraConfig(r=4, alpha=8))
    assert jax.tree.structure(adapter_to_jax(tad)) == jax.tree.structure(jad)
    assert [x.shape for x in jax.tree.leaves(adapter_to_jax(tad))] == [x.shape for x in jax.tree.leaves(jad)]
    assert count_params(tad) == sum(x.size for x in jax.tree.leaves(jad))
    a0 = tad["blocks"][0]["attn"]["wq"]["a"]
    assert a0.requires_grad and abs(a0.std().item() - 1 / 4) < 0.05
    assert all(not leaf.any() for leaf in tree_leaves(tad)[1::2])  # every B is zero
    rng = np.random.default_rng(2)
    jad = jax.tree.map(lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), jad)
    ids = rng.integers(0, cfg.vocab_size, (2, 12))
    want = np.asarray(jcl.forward(jlora.merge_lora(params, jad, lcfg), cfg, jnp.asarray(ids, jnp.int32)))
    merge_lora(model, adapter_from_jax(jad, device="cpu"), LoraConfig(r=4, alpha=8))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2e-2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())
    dense = model.blocks[0].attn.wq
    assert (dense.lora_a is not None) == (quantize is not None) and (dense.w_merged is None) == (quantize is not None)
    clear_lora(model)
    assert dense.lora_a is None and dense.w_merged is None


def test_remat_policies_give_the_same_gradients():
    """Per-layer remat (scan_layers) changes memory, not numbers: none,
    full and dots give bit-identical loss and adapter gradients; proj_bf16
    rounds every dense output to bf16 in the forward (as the JAX package
    does), so it agrees to 1e-3 of the loss and to 5e-2 of the largest
    gradient entry (some leaves' exact gradients nearly cancel)."""
    base = ModelConfig.from_dict(dataclasses.asdict(dataclasses.replace(
        jcfg.tiny_test("causal"), scan_layers=True, positional="alibi", alibi_mode="mpt", use_flash_attention=True)))
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, base.vocab_size, (2, 24)))
    batch = {"input_ids": ids, "labels": ids}
    out = {}
    for policy in ("none", "full", "dots", "proj_bf16"):
        model = init_causal_lm(dataclasses.replace(base, remat_policy=policy), torch.Generator().manual_seed(0),
                               quantize="int8")
        ad = init_lora(torch.Generator().manual_seed(1), model, LoraConfig(r=4, alpha=8))
        with torch.no_grad():
            for leaf in tree_leaves(ad):
                leaf.add_(0.05)
        merge_lora(model, ad, LoraConfig(r=4, alpha=8))
        loss, _ = causal_loss(model, batch)
        out[policy] = (loss.item(), torch.autograd.grad(loss, tree_leaves(ad)))
    for policy in ("full", "dots"):
        assert out[policy][0] == out["none"][0]
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["none"][1]))
    assert abs(out["proj_bf16"][0] - out["none"][0]) <= 1e-3 * abs(out["none"][0])
    scale = max(g.abs().max() for g in out["none"][1])
    for a, b in zip(out["proj_bf16"][1], out["none"][1]):
        assert (a - b).abs().max() <= 5e-2 * scale


# ------------------------------------------------------------- optimizers


@pytest.mark.parametrize("name", ["adamw", "lion", "adamw8bit", "lion8bit"])
def test_optimizers_match_optax(name):
    """Three steps of each optimizer (clipping, weight decay, a warmup +
    cosine schedule) on the same parameters and gradients as the JAX
    package's optax chain.  Gradients are drawn with |g| in [0.5, 1.5], so
    Adam's first step (~lr * sign(g)) is far from its eps; parameters agree
    to 1e-6 (f32 arithmetic in another order), and to 0.1 lr with 8-bit
    moments (a log-coded moment may round to the neighbouring code)."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((40, 30)).astype(np.float32), "b": [rng.standard_normal(300).astype(np.float32)]}
    grads = [jax.tree.map(lambda p: (np.sign(rng.standard_normal(p.shape)) * rng.uniform(0.5, 1.5, p.shape)).astype(
        np.float32), params) for _ in range(3)]
    lr, kw = 1e-2, dict(weight_decay=0.01, max_grad_norm=20.0)
    jtx = jopt.make_optimizer(name, jopt.make_schedule("cosine", lr, 10, 2), **kw)
    ttx = topt.make_optimizer(name, topt.make_schedule("cosine", lr, 10, 2), **kw)
    jp, js = params, jtx.init(params)
    tp = jax.tree.map(torch.from_numpy, params)
    tp = {"w": tp["w"], "b": tp["b"]}
    ts = ttx.init(tp)
    tol = 0.1 * lr if name.endswith("8bit") else 1e-6
    for g in grads:
        upd, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = ttx.update({"w": torch.from_numpy(g["w"]), "b": [torch.from_numpy(g["b"][0])]}, ts, tp)
        topt.apply_updates(tp, tu)
        for mine, theirs in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=tol, rtol=0)
    # the states flatten to the same leaves in the same order (checkpoints)
    assert [tuple(x.shape) for x in tree_leaves(ts)] == [x.shape for x in jax.tree.leaves(js)]


def test_schedules_and_blockwise_quant_match_jax():
    """Schedules to 1e-7 relative (python f64 vs f32); the log-coded int8
    moments: codes equal but for rounding ties (<= 1 code apart), scales
    equal, dequantized values within one code step (8.5% relative)."""
    for name, warm in (("linear", 0), ("linear", 3), ("cosine", 2), ("constant", 3)):
        js, ts = jopt.make_schedule(name, 0.1, 20, warm), topt.make_schedule(name, 0.1, 20, warm)
        for c in range(0, 25, 3):
            np.testing.assert_allclose(ts(c), float(js(c)), rtol=1e-6, atol=1e-9)
    assert topt.make_schedule("constant", 0.1, 20, 0) == 0.1
    x = (np.random.default_rng(6).standard_normal(1000) * np.logspace(-6, 0, 1000)).astype(np.float32)
    x[:7] = 0.0
    jq = jopt.quantize_blockwise(jnp.asarray(x))
    tq = topt.quantize_blockwise(torch.from_numpy(x))
    assert np.abs(tq.q.numpy().astype(int) - np.asarray(jq.q).astype(int)).max() <= 1
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    back = topt.dequantize_blockwise(tq).numpy()
    assert (back[:7] == 0).all()
    np.testing.assert_allclose(back, np.asarray(jopt.dequantize_blockwise(jq)), rtol=0.09, atol=0)


# ------------------------------------------------------------------ loader


def _write(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return str(path)


def _batches_equal(jdl, tdl, jfiles, tfiles, **kw):
    jex = jdl.load_examples(jfiles, **kw)
    tex = tdl.load_examples(tfiles, **kw)
    assert jex == tex and jdl.stats == tdl.stats
    for epoch in (0, 1):
        jb = list(jdl.batches(jex, epoch=epoch))
        tb = list(tdl.batches(tex, epoch=epoch))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("pack", [False, True])
def test_loader_batches_bit_identical(tmp_path, pack):
    """The same files give the same examples, stats and batches (every
    epoch's shuffle, the bucket widths, completion-only labels, packing),
    instruct and qa schemas mixed by fraction.  Raw alpaca records (the
    layout of examples/sample_instruct.jsonl, which the JAX loader
    refuses) load as the JAX parser's records with an empty system prompt."""
    raw = [json.loads(line) for line in open(SAMPLE, encoding="utf-8")]
    parser = GenericInstructParser("alpaca", output_dir=str(tmp_path))
    parser.raw = raw
    parser.convert()
    converted = _write(tmp_path / "instruct.jsonl", parser.converted)
    qa = _write(tmp_path / "qa.jsonl", [
        {"id": str(i), "question": f"câu hỏi {i}?", "documents": [f"đoạn {i}", f"đoạn {i + 1}"],
         "answer": None if i % 3 == 0 else f"trả lời {i}", "is_trivial": i % 4 == 1} for i in range(20)])
    kw = dict(max_len=256, batch_size=4, seed=3, pack=pack)
    jdl, tdl = jloader.QADataLoader(JByteTokenizer(), **kw), QADataLoader(ByteTokenizer(), **kw)
    _batches_equal(jdl, tdl, [jloader.DataFileSpec(converted, "instruct", 0.5), jloader.DataFileSpec(qa, "qa")],
                   [DataFileSpec(converted, "instruct", 0.5), DataFileSpec(qa, "qa")], max_examples=30)
    mapped = _write(tmp_path / "mapped.jsonl", [dict(r, system_prompt="") for r in parser.converted])
    jdl, tdl = jloader.QADataLoader(JByteTokenizer(), **kw), QADataLoader(ByteTokenizer(), **kw)
    _batches_equal(jdl, tdl, [jloader.DataFileSpec(mapped)], [DataFileSpec(SAMPLE)])


# ------------------------------------------------------------- checkpoints


def test_checkpoints_resume_across_packages(tmp_path):
    """A JAX trainer's checkpoint (int8 base + LoRA, adamw after one step)
    restores into the port's trainer leaf for leaf, bit for bit; the port
    trains a step and saves, and the JAX trainer restores that."""
    cfg = jcfg.tiny_test("causal")
    lc = jlora.LoraConfig(r=4, alpha=8)
    rng = np.random.default_rng(9)
    ids = rng.integers(4, cfg.vocab_size, (4, 16)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids}
    common = dict(lora=lc, quantize_base="int8", lr=1e-2, log_dir=str(tmp_path / "logs"), log_every=1)
    jt = jtrainer.Trainer(jtrainer.TrainConfig(model=cfg, checkpoint_dir=str(tmp_path / "a"), mesh_axes={"data": 1},
                                               **common), total_steps=4)
    jt.fit(lambda: [batch], max_steps=1)  # saves step_1
    base = _np_tree(jt.state["params"])
    tcfg = TrainConfig(model=ModelConfig.from_dict(dataclasses.asdict(cfg)), lora=LoraConfig(r=4, alpha=8),
                       quantize_base="int8", lr=1e-2, log_dir=str(tmp_path / "logs"), log_every=1,
                       checkpoint_dir=str(tmp_path / "a"), resume=True)
    tt = Trainer(tcfg, params=causal_from_jax(base, tcfg.model, device="cpu"), total_steps=4, device="cpu")
    assert tt.start_step == 1
    mine, theirs = tree_leaves(tt.whole_state()), jax.tree.leaves(jt.state)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    tt.cfg.checkpoint_dir = str(tmp_path / "b")
    tt.ckpt = type(tt.ckpt)(str(tmp_path / "b"))
    tt.fit(lambda: [batch, batch], max_steps=2)  # one more step, saved as step_2
    jt2 = jtrainer.Trainer(jtrainer.TrainConfig(model=cfg, checkpoint_dir=str(tmp_path / "b"), resume=True,
                                                mesh_axes={"data": 1}, **common), total_steps=4)
    assert jt2.start_step == 2
    for a, b in zip(tree_leaves(tt.whole_state()), jax.tree.leaves(jt2.state)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


# --------------------------------------------------------------------- cli


def test_cli_train_on_the_cpu(tmp_path):
    """``cli train`` (tiny preset, int8 base + LoRA) over the repo's sample
    file exits 0, logs each step and writes the adapter in the JAX
    layout; without --device it asks for the card; with ``--strategy
    fsdp --mesh '{"data": 2}' --host-offload optimizer`` it trains too."""
    argv = ["train", "--model-size", "tiny", "--use-lora", "--quantize-base", "int8", "--train-files", SAMPLE,
            "--max-steps", "2", "--log-every", "1", "--log-dir", str(tmp_path / "logs"), "--checkpoint-dir",
            str(tmp_path / "ck"), "--run-name", "cli"]
    assert cli_main([*argv, "--device", "cpu"]) == 0
    logged = [json.loads(line) for line in open(tmp_path / "logs" / "cli.jsonl")]
    assert [r["step"] for r in logged] == [1, 2] and all(np.isfinite(r["loss"]) for r in logged)
    from vietnamese_qa_system_tpu.train.checkpoint import load_pytree as jload

    leaves = jload(str(tmp_path / "ck" / "adapter.npz"))
    assert len(leaves) == 2 * 6 * 2  # (a, b) x 6 targets x 2 layers
    assert sorted(os.listdir(tmp_path / "ck")) == ["adapter.npz", "dtypes.json", "step_2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli_main(argv)
    # host offload under a strategy over a mesh runs (it was refused before it was ported)
    off = [a if a != str(tmp_path / "ck") else str(tmp_path / "ck_off") for a in argv]
    off = [a if a != "cli" else "cli_off" for a in off]
    assert cli_main([*off, "--device", "cpu", "--strategy", "fsdp", "--mesh", '{"data": 2}', "--host-offload",
                     "optimizer"]) == 0
    logged = [json.loads(line) for line in open(tmp_path / "logs" / "cli_off.jsonl")]
    assert [r["step"] for r in logged] == [1, 2] and all(np.isfinite(r["loss"]) for r in logged)


def test_cli_train_over_a_mesh_on_the_cpu(tmp_path):
    """``train --device cpu --strategy fsdp_tp --mesh '{"data": 2, "model":
    2}'`` (a mesh of four host repeats; int8 base + LoRA, eval split over the
    data axis) takes a step and saves; ``train --resume`` on one device
    restores that checkpoint and takes the second step."""
    argv = ["train", "--model-size", "tiny", "--use-lora", "--quantize-base", "int8", "--train-files", SAMPLE,
            "--log-every", "1", "--log-dir", str(tmp_path / "logs"), "--checkpoint-dir", str(tmp_path / "ck"),
            "--device", "cpu", "--batch-size", "4", "--grad-accum", "2", "--eval-files", SAMPLE, "--do-eval"]
    assert cli_main([*argv, "--max-steps", "1", "--run-name", "mesh", "--strategy", "fsdp_tp", "--mesh",
                     '{"data": 2, "model": 2}']) == 0
    assert os.listdir(tmp_path / "ck" / "step_1")
    assert cli_main([*argv, "--max-steps", "2", "--run-name", "one", "--resume"]) == 0
    logged = [json.loads(line) for line in open(tmp_path / "logs" / "mesh.jsonl")]
    resumed = [json.loads(line) for line in open(tmp_path / "logs" / "one.jsonl")]
    assert [r["step"] for r in logged if "loss" in r] == [1] and [r["step"] for r in resumed if "loss" in r] == [2]
    assert any("eval_eval_loss" in r for r in logged)
    with pytest.raises(ValueError, match="data mesh axis"):
        cli_main([*argv, "--max-steps", "1", "--run-name", "odd", "--strategy", "fsdp", "--mesh", '{"data": 4}',
                  "--batch-size", "6", "--grad-accum", "1"])


def test_cli_train_and_chat_seq2seq_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``cli train --arch seq2seq`` (the tiny native stack, int8 base + LoRA,
    perplexity and beam generative eval) writes an adapter that the JAX
    package's tree of the same model takes leaf for leaf; ``chat --arch
    seq2seq`` and ``serve --reader-size tiny-s2s`` answer on the CPU."""
    from vietnamese_qa_system_tpu.models import seq2seq as jnative
    from vietnamese_qa_system_tpu.train.checkpoint import load_pytree as jload

    argv = ["train", "--arch", "seq2seq", "--model-size", "tiny", "--use-lora", "--quantize-base", "int8",
            "--train-files", SAMPLE, "--eval-files", SAMPLE, "--max-examples", "8", "--batch-size", "4", "--max-len", "200",
            "--max-steps", "2", "--log-every", "1", "--log-dir", str(tmp_path / "logs"), "--checkpoint-dir",
            str(tmp_path / "ck"), "--run-name", "s2s", "--do-eval", "--do-generative-eval", "--max-new-tokens", "4",
            "--num-beams", "2", "--device", "cpu"]
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    assert "eval @ epoch 0" in out and "gen_tokens_per_s" in out
    logged = [json.loads(line) for line in open(tmp_path / "logs" / "s2s.jsonl")]
    assert [r["step"] for r in logged if "loss" in r] == [1, 2] and all(
        np.isfinite(r["loss"]) for r in logged if "loss" in r)
    assert os.listdir(tmp_path / "logs" / "predictions")
    cfg = dataclasses.replace(jcfg.tiny_test("seq2seq"), vocab_size=ByteTokenizer().vocab_size)
    like = jlora.init_lora(jax.random.key(0), jquant(jnative.init_seq2seq(jax.random.key(0), cfg), "int8"),
                           jlora.LoraConfig())
    leaves = jload(str(tmp_path / "ck" / "adapter.npz"))
    assert [np.shape(x) for x in leaves] == [x.shape for x in jax.tree.leaves(like)]

    lines = iter(["xin chào", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert cli_main(["chat", "--arch", "seq2seq", "--max-new-tokens", "3", "--num-beams", "2", "--device",
                     "cpu"]) == 0
    assert "model> " in capsys.readouterr().out
    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": f"Tài liệu số {i} về Hà Nội."}, ensure_ascii=False)
                              for i in range(6)), encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli_main(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--batch-size",
                     "8", "--max-len", "32"]) == 0
    lines = iter(["Tài liệu số 2 về Hà Nội.", ""])
    assert cli_main(["serve", "--index", idx, "--db", db, "--device", "cpu", "--max-len", "32", "--reader-size",
                     "tiny-s2s", "--reader-quantize", "int8c", "--max-new-tokens", "3", "--min-score", "-1"]) == 0
    assert "answer> " in capsys.readouterr().out
