"""The port's seq2seq trainer over a model axis against the JAX ``Trainer``
on the same mesh shape (test_torch_mesh_train.py's helpers and
tolerances: the loss 1e-4 relative at step 1 and 1e-3 at step 2,
``grad_norm`` 5e-2, the trained leaves by the median and norm move rules
against JAX's first-microbatch gradient):

- T5 with mt5-small's 6 heads and an untied head, under ``tp`` on
  ``{"model": 2}`` (heads split 3 + 3) and ``{"model": 4}`` (attention
  whole, the MLP and vocabulary split: the documented difference from
  JAX's column split of the inner width), and under ``fsdp_tp {"data": 2,
  "model": 2}``;
- T5 with a tied head at a vocabulary of 16,384, where the loss streams the
  split head chunk by chunk over its input scaled by ``d_model ** -0.5``;
- mBART without a logits bias (a vocabulary of 130 splits over 2, as
  mbart-large-50's 250,054 does) and the native stack;
- LoRA over float and int8 bases; T5 full fine-tuning without flash under
  ``tp`` (JAX tests/test_t5.py:272-309), whose relative-bias tables train
  through each part's head slice;
- a ``tp`` checkpoint reloaded under ``dp`` and on one device,
  ``perplexity_eval(mesh=)`` over the ``fsdp_tp`` rows, ``cli train
  --arch seq2seq --strategy tp --mesh`` with ``--device cpu``, and its
  generative eval under fsdp / fsdp_tp with host offload over nf4.

The JAX side runs on the conftest's virtual CPU devices, the port on
``["cpu"] * n``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mesh_train import (LORA, LR, _leaves_np, assert_metrics_close, assert_moves_close, batches,
                                   train_both)
from vietnamese_qa_system_tpu.models import config as jcfg
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models.config import ModelConfig as JConfig
from vietnamese_qa_system_tpu.models.quantize import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu.train import trainer as jtrainer
from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main
from vietnamese_qa_system_tpu_torch.models import ModelConfig, adapter_from_jax, seq2seq_from_jax
from vietnamese_qa_system_tpu_torch.models.families import TPEncoderDecoder
from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer, params_tree, perplexity_eval
from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)
SAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "sample_instruct.jsonl")
FAMILIES = {
    # mt5-small's 6 heads x d_kv 64 (inner 384: the int8 blocks of wo's rows split over 2), gated FFN, untied head
    "t5": JConfig(arch="seq2seq", seq2seq_family="t5", vocab_size=128, d_model=64, n_heads=6, d_kv=64, n_layers=1,
                  n_decoder_layers=1, d_ff=128, max_seq_len=512, mlp_gated=True, tie_embeddings=False,
                  relative_attention_buckets=8, relative_attention_max_distance=32, attention_bias=False),
    # a tied head (T5 v1.0) at a vocabulary where the loss streams the split head in chunks
    "t5_tied": JConfig(arch="seq2seq", seq2seq_family="t5", vocab_size=16384, d_model=32, n_heads=4, d_kv=8,
                       n_layers=1, n_decoder_layers=1, d_ff=64, max_seq_len=512, mlp_gated=False, tie_embeddings=True,
                       relative_attention_buckets=8, relative_attention_max_distance=32, attention_bias=False),
    "bart": JConfig(arch="seq2seq", seq2seq_family="bart", vocab_size=130, d_model=64, n_heads=4, n_layers=1,
                    n_decoder_layers=1, d_ff=128, max_seq_len=64, positional="learned", scale_embedding=True,
                    norm_eps=1e-5),
    "native": jcfg.tiny_test("seq2seq"),
}
CASES = [("t5", "tp", {"model": 2}, "int8"), ("t5", "tp", {"model": 4}, None),
         ("t5", "fsdp_tp", {"data": 2, "model": 2}, "int8"), ("t5_tied", "tp", {"model": 2}, None),
         ("bart", "tp", {"model": 2}, "int8"), ("bart", "fsdp_tp", {"data": 2, "model": 2}, None),
         ("native", "tp", {"model": 4}, "int8"), ("native", "fsdp_tp", {"data": 2, "model": 2}, None)]


def s2s_setup(cfg, quantize=None, lora=True, seed=0):
    """(JAX config, numpy params, numpy adapter or None, batches), as
    test_torch_mesh_train.setup for a seq2seq config."""
    params = jtrainer.init_model_params(cfg, jax.random.key(seed))
    if quantize:
        params = jquant(params, quantize)
    params = jax.tree.map(np.asarray, params)
    adapter = None
    if lora:
        rng = np.random.default_rng(seed)
        adapter = jax.tree.map(lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
                               jlora.init_lora(jax.random.key(seed + 1), params, jlora.LoraConfig(**LORA)))
    return cfg, params, adapter, batches(cfg.vocab_size, seed)


def _port_cfg(cfg):
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def jax_s2s_grads(cfg, params, adapter, mb):
    """The first microbatch's jitted JAX gradient of the trained tree, as
    the port's leaf list."""
    loss = jtrainer.model_loss_fn(cfg)
    if adapter is not None:
        grads = jax.jit(jax.grad(lambda a: loss(jlora.merge_lora(params, a, jlora.LoraConfig(**LORA)),
                                                batch=mb)[0]))(jax.tree.map(jnp.array, adapter))
        return [x.detach().numpy() for x in tree_leaves(adapter_from_jax(jax.tree.map(np.asarray, grads), "cpu"))]
    grads = jax.jit(jax.grad(lambda p: loss(p, batch=mb)[0]))(jax.tree.map(jnp.array, params))
    port = seq2seq_from_jax(jax.tree.map(np.asarray, grads), _port_cfg(cfg), device="cpu")
    return [t.detach().numpy() for t in tree_leaves(params_tree(port))]


@pytest.mark.parametrize("family,strategy,axes,quantize", CASES)
def test_s2s_lora_step_matches_jax_trainer(tmp_path, family, strategy, axes, quantize):
    """Losses, grad_norm and the adapter's moves against JAX; the rows are
    the family's tensor-parallel form; the frozen base comes back whole."""
    cfg, params, adapter, data = s2s_setup(FAMILIES[family], quantize)
    tm, jm, tt, jt = train_both(cfg, params, adapter, data, strategy, axes, quantize, tmp_path)
    assert isinstance(tt.placed.rows[0], TPEncoderDecoder)
    if family == "t5":
        assert (tt.placed.rows[0].groups is not None) == (axes.get("model") == 2)  # 6 heads split over 2, not 4
    assert_metrics_close(tm, jm)
    before = [x.detach().numpy() for x in tree_leaves(adapter_from_jax(adapter, "cpu"))]
    grads = jax_s2s_grads(cfg, params, adapter, {k: v[:4] for k, v in data[0].items()})
    mine = _leaves_np(tree_leaves(tt.whole_state()["adapter"]))
    theirs = [x.detach().numpy() for x in tree_leaves(adapter_from_jax(jax.tree.map(np.asarray,
                                                                                    jt.state["adapter"]), "cpu"))]
    assert_moves_close(before, mine, theirs, grads)
    whole = _leaves_np(tree_leaves(tt.whole_state()["params"]))
    want = _leaves_np(tree_leaves(params_tree(seq2seq_from_jax(params, tt.cfg.model, "cpu"))))
    assert len(whole) == len(want) and all(np.array_equal(a, b) for a, b in zip(whole, want))


def test_t5_full_finetune_under_tp_matches_jax_trainer(tmp_path):
    """JAX tests/test_t5.py:272-309's T5 (2 heads, untied, relative bias)
    fully fine-tuned under tp over {"model": 2}, dense attention: every
    leaf moves as JAX's, the relative-bias tables included (their gradient
    arrives through each part's head slice)."""
    cfg = JConfig(arch="seq2seq", seq2seq_family="t5", vocab_size=64, d_model=32, n_heads=2, d_kv=16, n_layers=1,
                  n_decoder_layers=1, d_ff=64, mlp_gated=True, tie_embeddings=False, relative_attention_buckets=8,
                  attention_bias=False)
    _, params, _, data = s2s_setup(cfg, lora=False)
    tm, jm, tt, jt = train_both(cfg, params, None, data, "tp", {"model": 2}, None, tmp_path)
    assert tt.placed.rows[0].groups is not None
    assert_metrics_close(tm, jm)
    before = _leaves_np(tree_leaves(params_tree(seq2seq_from_jax(params, tt.cfg.model, "cpu"))))
    grads = jax_s2s_grads(cfg, params, None, {k: v[:4] for k, v in data[0].items()})
    mine = _leaves_np(tree_leaves(tt.whole_state()["params"]))
    port_j = seq2seq_from_jax(jax.tree.map(np.asarray, jt.state["params"]), tt.cfg.model, "cpu")
    theirs = _leaves_np(tree_leaves(params_tree(port_j)))
    assert_moves_close(before, mine, theirs, grads)
    for table in ("enc_rel_bias", "dec_rel_bias"):  # the tables train, through the parts' head slices
        assert not np.array_equal(params[table], tt.whole_state()["params"][table].detach().numpy())


def test_tp_checkpoint_reloads_under_dp_and_one_device(tmp_path):
    """A T5 LoRA run under tp over {"model": 2} saves its whole state; dp
    over {"data": 2} and the one-device trainer resume it leaf for leaf
    (the base, the adapter, the optimizer state, the step) and take the
    next step with the tp run's loss."""
    from vietnamese_qa_system_tpu_torch.models import LoraConfig

    cfg, params, adapter, data = s2s_setup(FAMILIES["t5"], "int8")
    mcfg = _port_cfg(cfg)

    def trainer(ck, **kw):
        tc = TrainConfig(model=mcfg, lora=LoraConfig(**LORA), quantize_base="int8", lr=LR, grad_accum=2,
                         log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / ck), **kw)
        return Trainer(tc, params=seq2seq_from_jax(params, mcfg, device="cpu"), device="cpu", total_steps=10)

    tp = trainer("tp", strategy="tp", mesh_axes={"model": 2})
    tp.load_state(dict(tp.whole_state(), adapter=adapter_from_jax(adapter, device="cpu")))
    tp.train_step(data[0])
    tp.save(1)
    tp.ckpt.wait()
    saved = [a.copy() for a in _leaves_np(tree_leaves(tp.whole_state()))]  # the live leaves move at the next step
    want = float(tp.train_step(data[1])["loss"])
    for kw in (dict(strategy="dp", mesh_axes={"data": 2}), dict()):
        t = trainer("tp", resume=True, **kw)
        assert t.start_step == 1
        got = _leaves_np(tree_leaves(t.whole_state()))
        assert len(got) == len(saved) and all(np.array_equal(a, b) for a, b in zip(got, saved))
        np.testing.assert_allclose(float(t.train_step(data[1])["loss"]), want, rtol=1e-4)


def test_perplexity_eval_over_tp_seq2seq_rows(tmp_path):
    """``perplexity_eval(mesh=)`` over the fsdp_tp trainer's rows (T5
    parts on each data row) against the one-device eval of the same
    merged weights."""
    from vietnamese_qa_system_tpu_torch.models import LoraConfig, merge_lora

    cfg, params, adapter, data = s2s_setup(FAMILIES["t5"], "int8")
    mcfg = _port_cfg(cfg)
    tc = TrainConfig(model=mcfg, lora=LoraConfig(**LORA), quantize_base="int8", lr=LR, grad_accum=2,
                     strategy="fsdp_tp", mesh_axes={"data": 2, "model": 2}, log_dir=str(tmp_path / "logs"))
    t = Trainer(tc, params=seq2seq_from_jax(params, mcfg, device="cpu"), device="cpu", total_steps=10)
    t.train_step(data[0])
    rows = t.merged_replicas()
    assert len(rows) == 2 and all(isinstance(r, TPEncoderDecoder) for r in rows)
    split = perplexity_eval(rows, mcfg, data, mesh=t.mesh)
    one = seq2seq_from_jax(params, mcfg, device="cpu")
    merge_lora(one, tree_map(lambda x: x.detach(), t.adapter), LoraConfig(**LORA))
    whole = perplexity_eval(one, mcfg, data)
    assert split["eval_tokens"] == whole["eval_tokens"]
    np.testing.assert_allclose(split["eval_loss"], whole["eval_loss"], rtol=1e-4)
    # the next step releases what eval gathered
    assert np.isfinite(float(t.train_step(data[1])["loss"]))


def test_cli_train_seq2seq_over_a_model_axis_on_the_cpu(tmp_path):
    """``train --arch seq2seq --strategy tp --mesh '{"model": 2}' --device
    cpu`` (the tiny native stack, int8 base + LoRA, eval split over the
    rows) takes two steps and saves an adapter the one-device run loads."""
    argv = ["train", "--arch", "seq2seq", "--model-size", "tiny", "--use-lora", "--quantize-base", "int8",
            "--train-files", SAMPLE, "--eval-files", SAMPLE, "--max-examples", "8", "--batch-size", "4",
            "--max-len", "200", "--max-steps", "2", "--log-every", "1", "--log-dir", str(tmp_path / "logs"),
            "--checkpoint-dir", str(tmp_path / "ck"), "--run-name", "tp", "--do-eval", "--device", "cpu",
            "--strategy", "tp", "--mesh", '{"model": 2}']
    assert cli_main(argv) == 0
    logged = [json.loads(line) for line in open(tmp_path / "logs" / "tp.jsonl")]
    assert [r["step"] for r in logged if "loss" in r] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in logged if "loss" in r)
    assert any("eval_eval_loss" in r for r in logged)
    assert "adapter.npz" in os.listdir(tmp_path / "ck")


@pytest.mark.parametrize("strategy,axes", [("fsdp", '{"data": 2}'), ("fsdp_tp", '{"data": 2, "model": 2}')])
def test_cli_generative_eval_over_fsdp_seq2seq_rows(tmp_path, strategy, axes):
    """``train --arch seq2seq --strategy fsdp|fsdp_tp --host-offload all
    --do-generative-eval`` over an nf4 base: generation projects each
    decoder layer's cross K/V once a sequence, outside the layer's
    forward, and gathers the data-split weights for it too."""
    argv = ["train", "--arch", "seq2seq", "--model-size", "tiny", "--use-lora", "--quantize-base", "nf4",
            "--train-files", SAMPLE, "--eval-files", SAMPLE, "--max-examples", "8", "--batch-size", "4",
            "--max-len", "200", "--max-steps", "1", "--log-every", "1", "--log-dir", str(tmp_path / "logs"),
            "--run-name", "gen", "--do-eval", "--do-generative-eval", "--max-new-tokens", "4", "--num-beams", "2",
            "--device", "cpu", "--strategy", strategy, "--mesh", axes, "--host-offload", "all"]
    assert cli_main(argv) == 0
    logged = [json.loads(line) for line in open(tmp_path / "logs" / "gen.jsonl")]
    assert any("eval_gen_tokens_per_s" in r for r in logged)
    assert os.listdir(tmp_path / "logs" / "predictions")
