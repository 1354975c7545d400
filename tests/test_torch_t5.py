"""The port's T5 / mT5 family against the JAX package's models/t5.py:

- bucket ids bit-equal to JAX's, bidirectional (the encoder) and causal
  (the decoder), over relative distances -4,096..4,096; the decoder bias
  of per-row cursors (the slot engine's) and of a scalar one bit-equal to
  JAX ``_dec_bias``;
- a scan-stacked JAX tree carries over as the list-form one does, and
  ``mt5_small_class`` equals JAX's;
- the flash route (the kernels' plain versions on the CPU) against the
  dense path at T 256 with right padding on both sides: decoder logits at
  the valid positions within atol 0.1 / rtol 0.05 (JAX test_t5.py:337's
  bound), LoRA gradients within 5e-2 of each leaf's largest entry;
- a QLoRA step over an int8 base: loss and adapter gradients against
  jitted JAX (loss 1e-4 relative, gradients within 5e-2 of each leaf's
  largest entry, test_torch_qlora.py's bounds), one jitted JAX
  ``make_train_step`` against the port's (loss 1e-4, grad_norm 5e-2
  relative), the codes untouched;
- the full fine-tuning flash guard.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seq2seq import CONFIGS, _flat, port_cfg, port_model, torch_batch
from vietnamese_qa_system_tpu.models import config as jcfg
from vietnamese_qa_system_tpu.models import encoder as jenc
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models import quantize as jq
from vietnamese_qa_system_tpu.models import t5 as jt5
from vietnamese_qa_system_tpu.train import optim as jopt
from vietnamese_qa_system_tpu.train import trainer as jtrainer
from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, adapter_from_jax, clear_lora, families,
                                                   merge_lora, mt5_small_class, seq2seq_from_jax)
from vietnamese_qa_system_tpu_torch.models import t5 as tt5
from vietnamese_qa_system_tpu_torch.models.encoder import relative_position_bucket
from vietnamese_qa_system_tpu_torch.ops import attention as A
from vietnamese_qa_system_tpu_torch.train import TrainConfig, Trainer
from vietnamese_qa_system_tpu_torch.train import optim as topt
from vietnamese_qa_system_tpu_torch.train.trainer import make_train_step, params_tree

torch.set_num_threads(2)
CFG = CONFIGS["t5"]
LORA = dict(r=4, alpha=8)
FLASH_ATOL, FLASH_RTOL = 0.1, 0.05


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 32)])
def test_bucket_ids_bit_equal_jax(buckets, max_distance):
    rel = np.arange(-4096, 4097)
    want_c = np.asarray(jt5._causal_bucket(jnp.asarray(rel), buckets, max_distance))
    want_b = np.asarray(jenc._relative_position_bucket(jnp.asarray(rel), buckets, max_distance))
    assert np.array_equal(tt5.causal_bucket(rel, buckets, max_distance), want_c)
    assert np.array_equal(relative_position_bucket(rel, buckets, max_distance), want_b)


def test_decoder_bias_bit_equal_jax():
    cfg = dataclasses.replace(CFG, relative_attention_buckets=32, relative_attention_max_distance=128)
    table = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
    total = 300
    cursors = np.array([0, 1, 17, 299, 300], np.int32)  # 300 = total: a finished slot's cursor
    want = np.asarray(jt5._dec_bias(jnp.asarray(table), jnp.asarray(cursors), total, cfg, per_row=True))
    got = tt5.decoder_bias(torch.from_numpy(table), torch.from_numpy(cursors), total, port_cfg(cfg))
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(jt5._dec_bias(jnp.asarray(table), jnp.zeros((1,), jnp.int32) + 41, total, cfg))
    assert np.array_equal(tt5.decoder_bias(torch.from_numpy(table), 41, total, port_cfg(cfg)).numpy(), want)
    want = np.asarray(jt5._dec_bias(jnp.asarray(table), jnp.arange(total), total, cfg))
    assert np.array_equal(tt5.full_decoder_bias(torch.from_numpy(table), total, port_cfg(cfg)).numpy(), want)


def test_stacked_tree_and_preset():
    params = jt5.init_t5(jax.random.key(3), CFG)
    stacked = jt5.stack_t5(params)
    a = port_model(params, CFG).state_dict()
    b = seq2seq_from_jax(jax.tree.map(np.asarray, stacked), port_cfg(dataclasses.replace(CFG, scan_layers=True)),
                         device="cpu").state_dict()
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert dataclasses.asdict(mt5_small_class()) == dataclasses.asdict(jcfg.mt5_small_class())


def _long_batch():
    rng = np.random.default_rng(0)
    b, te, td = 2, 256, 256
    enc = rng.integers(1, CFG.vocab_size, (b, te)).astype(np.int32)
    em = np.ones((b, te), np.int32)
    em[1, 200:] = 0
    labels = rng.integers(1, CFG.vocab_size, (b, td)).astype(np.int32)
    labels[1, 180:] = -100
    return {"input_ids": enc * em, "attention_mask": em, "labels": labels}


def test_flash_route_matches_dense(monkeypatch):
    """The encoder (bidirectional, kv_lens) and the decoder (causal, kv_lens
    from its mask) through the flash kernels' plain versions, full bias
    and scale 1, against the dense path and the JAX dense forward."""
    params = jt5.init_t5(jax.random.key(0), CFG)
    batch = _long_batch()
    dec = np.concatenate([np.zeros((2, 1), np.int32), np.where(batch["labels"] < 0, 0, batch["labels"])[:, :-1]], 1)
    fwd = dict(batch, decoder_input_ids=dec, decoder_attention_mask=(batch["labels"] >= 0).astype(np.int32))
    fwd.pop("labels")
    want = np.asarray(jt5.forward(params, CFG, {k: jnp.asarray(v) for k, v in fwd.items()}))
    dense = port_model(params, CFG)
    flash = port_model(params, dataclasses.replace(CFG, use_flash_attention=True))
    calls = []
    orig = A.flash_fwd

    def count(*a):
        calls.append(a[5:7])  # (n_heads, causal)
        return orig(*a)

    with torch.inference_mode():
        got_d = dense(torch_batch(fwd)).numpy()
        monkeypatch.setattr(A, "flash_fwd", count)
        got_f = flash(torch_batch(fwd)).numpy()
    assert sorted(set(calls)) == [(4, False), (4, True)] and len(calls) == 4
    for got in (got_d, got_f):
        np.testing.assert_allclose(got[0], want[0], atol=FLASH_ATOL, rtol=FLASH_RTOL)
        np.testing.assert_allclose(got[1, :180], want[1, :180], atol=FLASH_ATOL, rtol=FLASH_RTOL)
    # LoRA gradients through K7's plain version against the dense backward
    adapter = _adapter(params, 5)
    grads = []
    for model in (dense, flash):
        tad = adapter_from_jax(adapter, device="cpu")
        merge_lora(model, tad, LoraConfig(**LORA))
        loss, _ = families.loss_fn(model, torch_batch(batch))
        grads.append(dict(zip(sorted(_flat(tad)), torch.autograd.grad(loss, [v for _, v in sorted(_flat(tad).items())]))))
        clear_lora(model)
    for path, w in grads[0].items():
        assert (grads[1][path] - w).abs().max() <= 5e-2 * w.abs().max(), path


def _adapter(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
                        jlora.init_lora(jax.random.key(seed), params, jlora.LoraConfig(**LORA)))


def _short_batch(seed, shape=(2, 12)):
    rng = np.random.default_rng(seed)
    enc = rng.integers(3, CFG.vocab_size, shape).astype(np.int32)
    labels = rng.integers(3, CFG.vocab_size, shape[:-1] + (8,)).astype(np.int32)
    labels[..., 6:] = -100
    return {"input_ids": enc, "attention_mask": np.ones_like(enc), "labels": labels}


def test_qlora_int8_base_matches_jax():
    params = jq.quantize_dense_tree(jt5.init_t5(jax.random.key(1), CFG), "int8")
    adapter = _adapter(params, 2)
    batch = _short_batch(3)
    lc = jlora.LoraConfig(**LORA)

    def jloss(ad):
        return jt5.loss_fn(jlora.merge_lora(params, ad, lc), CFG, {k: jnp.array(v) for k, v in batch.items()})

    (want, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jax.tree.map(jnp.array, adapter))
    model = port_model(params, CFG)
    assert model.enc_blocks[0].attn.wq.w_q.dtype == torch.int8
    tad = adapter_from_jax(adapter, device="cpu")
    merge_lora(model, tad, LoraConfig(**LORA))
    loss, _ = families.loss_fn(model, torch_batch(batch))
    got = dict(zip(sorted(_flat(tad)), torch.autograd.grad(loss, [v for _, v in sorted(_flat(tad).items())])))
    clear_lora(model)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    for path, w in _flat(jax.tree.map(np.asarray, jgrads)).items():
        assert np.abs(got[path].numpy() - w).max() <= 5e-2 * np.abs(w).max(), path

    # one whole step (grad_accum 2, adamw) of each package's trainer
    fparams = jt5.init_t5(jax.random.key(1), CFG)
    qparams = jax.tree.map(np.asarray, jq.quantize_dense_tree(fparams, "int8"))
    step_batch = _short_batch(4, (2, 2, 12))
    tx = jopt.make_optimizer("adamw", jopt.make_schedule("linear", 1e-2, 10, 0))
    jstep = jtrainer.make_train_step(jtrainer.TrainConfig(model=CFG, lora=lc, quantize_base="int8", grad_accum=2), tx)
    jstate = {"params": jax.tree.map(jnp.array, qparams), "adapter": jax.tree.map(jnp.array, adapter),
              "opt_state": tx.init(jax.tree.map(jnp.array, adapter)), "step": jnp.zeros([], jnp.int32)}
    _, jm = jstep(jstate, {k: jnp.array(v) for k, v in step_batch.items()})
    tcfg = TrainConfig(model=port_cfg(CFG), lora=LoraConfig(**LORA), quantize_base="int8", grad_accum=2)
    model = port_model(qparams, CFG)
    tad = adapter_from_jax(adapter, device="cpu")
    ttx = topt.make_optimizer("adamw", topt.make_schedule("linear", 1e-2, 10, 0))
    state = {"params": params_tree(model), "adapter": tad, "opt_state": ttx.init(tad),
             "step": torch.zeros((), dtype=torch.int32)}
    codes = model.dec_blocks[0].cross_attn.wk.w_q.clone()
    state, m = make_train_step(tcfg, ttx, model)(state, {k: torch.from_numpy(v.astype(np.int64))
                                                         for k, v in step_batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=5e-2)
    assert torch.equal(model.dec_blocks[0].cross_attn.wk.w_q, codes)


def test_trainer_fits_a_quantized_seq2seq_and_guards_full_ft_flash(tmp_path):
    cfg = port_cfg(CFG)
    trainer = Trainer(TrainConfig(model=cfg, lora=LoraConfig(**LORA), quantize_base="int8", log_every=1,
                                  log_dir=str(tmp_path)), device="cpu")
    assert isinstance(trainer.model, tt5.T5) and trainer.model.enc_blocks[0].mlp.wg.w_q is not None
    batch = {k: v[None] for k, v in _short_batch(6, (4, 12)).items()}
    before = [t.detach().clone() for t in trainer.adapter["dec_blocks"][0]["cross_attn"]["wq"].values()]
    assert trainer.fit(lambda: [{k: v[0] for k, v in batch.items()}], max_steps=1) == 1
    after = list(trainer.adapter["dec_blocks"][0]["cross_attn"]["wq"].values())
    assert any(not torch.equal(x, y) for x, y in zip(before, after))
    with pytest.raises(ValueError, match="freeze the bias tables"):
        Trainer(TrainConfig(model=dataclasses.replace(cfg, use_flash_attention=True)), device="cpu")
    bart = ModelConfig.from_dict(dataclasses.asdict(CONFIGS["bart"]))
    with pytest.raises(ValueError, match="scan-over-layers"):
        Trainer(TrainConfig(model=dataclasses.replace(bart, scan_layers=True), lora=LoraConfig()), device="cpu")
