"""Parity of the port's nf4 / nf4-dq quantized weights with the JAX package
(``models/quantize.py``, ``layers.dense``) on the same numpy inputs, on the
CPU.

- Quantization: nf4 codes and scales bit-equal to JAX's eager
  ``quantize_weight`` and to its jitted form; nf4-dq's codes bit-equal, its
  second level (``s_m``, ``s_s``, ``s_q``) within the stated bounds.  The
  offset ``s_m`` is a mean over d_out: JAX sums in XLA's f32 order, the port
  in f64 (one value on every device), so they differ by a few ulps (4 at
  most here); ``c = absmax - s_m`` cancels, which moves the step ``s_s`` by
  up to ~8 ulps (relative 4e-6 allowed), and a code of ``s_q`` may step by
  one where ``c / s_s`` sits on a rounding edge (at most 1% of them).
- Dequantization of the same leaf: bit-equal.
- ``dense`` (quantized base, 2-D and per-row LoRA) and a 2-layer causal
  reader carried by ``causal_from_jax`` (prefill and cached step: max abs
  2e-2, mean abs 1e-3, as tests/test_torch_causal.py; greedy tokens by the
  top-2 margin rule, as tests/test_torch_generate.py).
- ``dequantize_tree`` with and without ``fold_lora``: each weight within 1
  bf16 ulp of JAX's (f32 sums of A @ B in another order before the cast).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.models import layers as jl
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models import quantize as jq
from vietnamese_qa_system_tpu_torch.core import make_generator
from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, adapter_from_jax, causal_from_jax,
                                                   causal_from_state_dict, clear_lora, dequantize_tree,
                                                   init_causal_lm, make_cache, merge_lora, quantize_dense_tree,
                                                   tree_bytes)
from vietnamese_qa_system_tpu_torch.models import generate as tg
from vietnamese_qa_system_tpu_torch.models import layers as tl
from vietnamese_qa_system_tpu_torch.models import quantize as tq

torch.set_num_threads(2)
MAX_TOL, MEAN_TOL = 2e-2, 1e-3
MARGIN_TOL = 5e-2
S_M_ULPS, S_S_RTOL, S_Q_FLIPS = 4, 4e-6, 0.01
LORA = dict(r=4, alpha=8)
READER = dataclasses.replace(jc.phogpt_4b_class(), vocab_size=512, d_model=384, n_heads=6, d_ff=768, n_layers=2,
                             max_seq_len=256, use_flash_attention=False, scan_layers=False)
SHAPES = [(128, 96), (64, 48), (256, 200), (192, 384), (3072, 64)]


def _weight(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    w[3, 7] = 0.9  # an outlier
    w[:, 5] = 0.0  # an all-zero column: the 1e-12 absmax floor
    return w


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max()


def _assert_leaf_matches(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
    assert got["w_q"].dtype == torch.uint8
    if "w_s" in want:
        np.testing.assert_array_equal(got["w_s"].numpy(), np.asarray(want["w_s"]))
        return
    assert _ulps(got["s_m"].numpy(), np.asarray(want["s_m"])) <= S_M_ULPS
    np.testing.assert_allclose(got["s_s"].numpy(), np.asarray(want["s_s"]), rtol=S_S_RTOL, atol=0)
    d = np.abs(got["s_q"].numpy().astype(int) - np.asarray(want["s_q"]).astype(int))
    assert got["s_q"].dtype == torch.int8 and d.max() <= 1 and (d > 0).mean() <= S_Q_FLIPS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
def test_quantize_matches_eager_and_jitted_jax(mode, shape):
    w = _weight(shape, shape[0] + shape[1])
    got = tq.quantize_weight(torch.from_numpy(w), mode)
    _assert_leaf_matches(got, jq.quantize_weight(jnp.asarray(w), mode))
    # quantize_dense_tree jits every leaf: the scale divisions become products
    jitted = jax.jit(jq.quantize_weight, static_argnums=(1, 2))(jnp.asarray(w), mode, 64)
    _assert_leaf_matches(got, jitted)


@pytest.mark.parametrize("mode", ["nf4", "nf4-dq", "int8"])
def test_dequantize_of_the_same_leaf_is_bit_equal(mode):
    leaf = jq.quantize_weight(jnp.asarray(_weight((256, 96), 1)), mode)
    carried = {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}
    got = tl.dequantize_weight(carried["w_q"], carried.get("w_s"), torch.float32, s_q=carried.get("s_q"),
                               s_s=carried.get("s_s"), s_m=carried.get("s_m"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.dequantize_weight(leaf, jnp.float32)))
    bf = tl.dequantize_weight(carried["w_q"], carried.get("w_s"), torch.bfloat16, s_q=carried.get("s_q"),
                              s_s=carried.get("s_s"), s_m=carried.get("s_m"))
    np.testing.assert_array_equal(bf.float().numpy(), np.asarray(jq.dequantize_weight(leaf, jnp.bfloat16),
                                                                 np.float32))


def test_searchsorted_codes_match_argmin():
    """The midpoint searchsorted coder gives the nearest level (test_quantize_base.py:204)."""
    w = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32) * 0.07
    q = tq.quantize_weight(torch.from_numpy(w), "nf4", block=32)
    codes = torch.stack([q["w_q"] & 0xF, q["w_q"] >> 4], dim=1).reshape(64, 32).numpy()
    wb = w.reshape(2, 32, 32)
    normed = (wb / np.maximum(np.abs(wb).max(axis=1), 1e-12)[:, None, :]).reshape(64, 32)
    ref = np.argmin(np.abs(normed[..., None] - np.asarray(jq.NF4_LEVELS)), axis=-1)
    np.testing.assert_array_equal(codes, ref)
    np.testing.assert_array_equal(np.asarray(tl.NF4_LEVELS, np.float32), jq.NF4_LEVELS)


@pytest.mark.parametrize("d_in,block", [(256, 64), (96, 64), (384, 96), (64, 64), (6, 64), (130, 64)])
def test_pick_block_matches_jax(d_in, block):
    assert tq._pick_block(d_in, block) == jq._pick_block(d_in, block)
    with pytest.raises(ValueError, match="power-of-two"):
        tq._pick_block(7, 64)


@pytest.mark.parametrize("mode", ["nf4", "nf4-dq", "int8c"])
def test_one_scale_row_reaches_k6_only_as_int8c(monkeypatch, mode):
    """A leaf quantized in one block has one scale row whatever its mode;
    only int8c codes take K6's route (JAX checks the dtype,
    layers.py:131-137).  At d_in 256 the packed nf4 codes have 128 rows, a
    K that K6 takes: read from the codes' shape, d_in would route them."""
    calls = []
    real = tl.w8_matmul
    monkeypatch.setattr(tl, "w8_matmul", lambda *a, **k: calls.append(a[1].dtype) or real(*a, **k))
    dense = tl.Dense(256, 128, device="cpu")
    with torch.no_grad():
        dense.w.copy_(torch.from_numpy(_weight((256, 128), 3)))
        dense.b.zero_()
    leaf = tq.quantize_weight(dense.w.detach(), mode, block=256)
    assert leaf.get("w_s", leaf.get("s_q")).shape[0] == 1
    dense.set_quantized(**leaf)
    assert dense.shape == (256, 128)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 256)).astype(np.float32))
    y = dense(x)
    if mode == "int8c":  # K6's plain version: the scale after the K sum
        want = (x.to(torch.bfloat16).float() @ dense.w_q.float()) * dense.w_s
    else:
        want = x.to(torch.bfloat16).float() @ dense.dequantized(torch.bfloat16).float()
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    assert calls == ([torch.int8] if mode == "int8c" else [])


def _jax_dense_leaf(mode, seed, d_in=128, d_out=96):
    p = jl.init_dense(jax.random.key(seed), d_in, d_out)
    p["b"] = jnp.asarray(np.random.default_rng(seed).standard_normal(d_out).astype(np.float32) * 0.1)
    return {"b": p["b"], **jq.quantize_weight(p["w"], mode)}


def _port_dense(leaf):
    d_out = leaf["b"].shape[0]
    dense = tl.Dense(1, d_out, device="cpu")
    with torch.no_grad():
        dense.b = torch.nn.Parameter(torch.from_numpy(np.asarray(leaf["b"])))
    dense.set_quantized(**{k: torch.from_numpy(np.asarray(v)) for k, v in leaf.items() if k != "b"})
    return dense


@pytest.mark.parametrize("lora", [None, "2d", "rows"])
@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
def test_dense_matches_jax(mode, lora):
    leaf = _jax_dense_leaf(mode, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    dense = _port_dense(leaf)
    factors = None
    if lora == "2d":
        a, b = (rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((128, 4), (4, 96)))
        leaf = dict(leaf, lora_a=jnp.asarray(a), lora_b=jnp.asarray(b))
        dense.lora_a, dense.lora_b = torch.from_numpy(a), torch.from_numpy(b)
    elif lora == "rows":
        a, b = (rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((3, 128, 4), (3, 4, 96)))
        leaf = dict(leaf, lora_a=jnp.asarray(a), lora_b=jnp.asarray(b))
        factors = {dense: (torch.from_numpy(a), torch.from_numpy(b))}
    want = np.asarray(jl.dense(leaf, jnp.asarray(x)))
    if factors is None:
        got = dense(torch.from_numpy(x))
    else:
        with tl.row_adapters(factors):
            got = dense(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=1e-5)


def _reader(mode, seed=0):
    params = jq.quantize_dense_tree(jlm.init_causal_lm(jax.random.key(seed), READER), mode)
    port = causal_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_dict(dataclasses.asdict(READER)),
                           device="cpu")
    return params, port


def _close(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= MAX_TOL and diff.mean() <= MEAN_TOL, (diff.max(), diff.mean())


@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
def test_reader_prefill_and_cached_step_match_jax(mode):
    params, model = _reader(mode, 3)
    blk = model.blocks[0].mlp.wi
    assert blk.w_q.dtype == torch.uint8 and (blk.w_s is None) == (mode == "nf4-dq")
    assert tree_bytes(model) == jq.tree_bytes(params)
    rng = np.random.default_rng(4)
    ids = rng.integers(4, 512, (3, 20)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, :7] = 0
    ids = ids * mask
    b, t = ids.shape
    total = t + 4
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    key_valid = np.concatenate([mask.astype(bool), np.zeros((b, 4), bool)], axis=1)
    prefill_mask = (np.arange(total)[None, None, :] <= np.arange(t)[None, :, None]) & key_valid[:, None, :]
    step_ids = np.array([[7], [300], [11]], np.int32)
    step_pos = mask.sum(1, keepdims=True)
    step_mask = key_valid[:, None, :] | (np.arange(total) == t)[None, None, :]
    jcache = jg._make_cache(READER, b, total, READER.n_layers)
    want0, jcache = jlm.forward(params, READER, jnp.asarray(ids), jnp.asarray(prefill_mask),
                                positions=jnp.asarray(positions), cache=jcache, cache_index=0)
    want1, _ = jlm.forward(params, READER, jnp.asarray(step_ids), jnp.asarray(step_mask),
                           positions=jnp.asarray(step_pos), cache=jcache, cache_index=t)
    cache = make_cache(model.cfg, b, total, "cpu")
    with torch.inference_mode():
        got0 = model(torch.from_numpy(ids).long(), torch.from_numpy(prefill_mask),
                     positions=torch.from_numpy(positions).long(), cache=cache, cache_index=0).numpy()
        got1 = model(torch.from_numpy(step_ids).long(), torch.from_numpy(step_mask),
                     positions=torch.from_numpy(step_pos).long(), cache=cache, cache_index=t).numpy()
    _close(got0, np.asarray(want0))
    _close(got1, np.asarray(want1))


@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
def test_reader_greedy_generate_matches_jax(mode):
    params, model = _reader(mode, 1)
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 260, (4, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1::2, :5] = 0
    ids = ids * mask
    want = np.asarray(jg.generate(params, READER, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=8, eos_id=2))
    got = tg.generate(model, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=8, eos_id=2).numpy()
    if np.array_equal(got, want):
        return
    # rows agree until the first near-tie of the JAX stream
    full = np.concatenate([mask, np.ones((4, want.shape[1] - 17), mask.dtype)], axis=1)
    logits = np.asarray(jlm.forward(params, READER, jnp.asarray(want[:, :-1]), jnp.asarray(full),
                                    positions=jnp.asarray(np.maximum(np.cumsum(full, axis=1) - 1, 0))))
    for r in range(4):
        diff = np.nonzero(got[r, 16:] != want[r, 16:])[0]
        if len(diff):
            top2 = np.sort(logits[r, 16 + diff[0] - 1])[-2:]
            assert top2[1] - top2[0] < MARGIN_TOL, (r, diff[0], top2)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("mode", ["nf4", "nf4-dq", "int8"])
def test_dequantize_tree_matches_jax(mode, fold):
    params, model = _reader(mode, 2)
    rng = np.random.default_rng(3)
    lc = jlora.LoraConfig(**LORA)
    adapter = jax.tree.map(lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape)).astype(np.float32),
                           jlora.init_lora(jax.random.key(5), params, lc))
    want = jq.dequantize_tree(jlora.merge_lora(params, adapter, lc), jnp.bfloat16, fold_lora=fold)
    merge_lora(model, adapter_from_jax(adapter, device="cpu"), LoraConfig(**LORA))
    dequantize_tree(model, torch.bfloat16, fold_lora=fold)
    wq = model.blocks[1].attn.wq
    assert wq.w_dequant.dtype == torch.bfloat16 and wq.lora_folded == fold and wq.lora_a is not None
    for i, blk in enumerate(want["blocks"]):
        for group, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wo"))):
            for name in names:
                got = model.get_submodule(f"blocks.{i}.{group}.{name}").w_dequant.detach().float().numpy()
                ref = np.asarray(blk[group][name]["w"], np.float32)
                # within one bf16 ulp (f32 sums of A @ B in another order before the cast)
                assert np.all(np.abs(got - ref) <= np.abs(ref) * 2.0 ** -7 + 1e-12), (i, group, name)
                if not fold:
                    np.testing.assert_array_equal(got, ref)
    ids = rng.integers(4, 512, (2, 12)).astype(np.int32)
    logits = np.asarray(jlm.forward(want, READER, jnp.asarray(ids), jnp.ones((2, 12), jnp.int32)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.ones(2, 12, dtype=torch.int32)).numpy()
    _close(got, logits)
    clear_lora(model)
    assert all(m.w_dequant is None and not m.lora_folded for m in model.modules() if isinstance(m, tl.Dense))


@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
def test_layer_by_layer_quantization_and_state_dict(mode):
    """init_causal_lm(quantize=) equals quantizing the drawn model after,
    and a quantized state_dict rebuilds through the meta-tensor path."""
    cfg = ModelConfig.from_dict(dataclasses.asdict(READER))
    drawn = quantize_dense_tree(init_causal_lm(cfg, make_generator(7)), mode)
    layered = init_causal_lm(cfg, make_generator(7), quantize=mode)
    sd = layered.state_dict()
    assert sd.keys() == drawn.state_dict().keys()
    assert all(torch.equal(v, drawn.state_dict()[k]) for k, v in sd.items())
    rebuilt = causal_from_state_dict(dict(sd), cfg)
    ids = torch.randint(4, 512, (2, 9), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(rebuilt(ids), layered(ids), rtol=0, atol=0)
    keys = {k.rsplit(".", 1)[1] for k in sd if k.startswith("blocks.0.attn.wq.")}
    assert keys == ({"w_q", "w_s"} if mode == "nf4" else {"w_q", "s_q", "s_s", "s_m"})  # MPT: no biases
