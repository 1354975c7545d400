"""Parity of the port's sentence encoder with the JAX package on the same
weights (``init_encoder`` pytree carried across by ``encoder_from_jax``):
BERT and MPNet layouts, the dense path (T=32) and the flash path (T=256,
``use_flash_attention=True``), f32 and bf16 activation policies.

Tolerance: per-row cos >= 0.9999 and max abs <= 2e-3 (f32 policy: 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import encoder as je
from vietnamese_qa_system_tpu_torch.core import make_generator
from vietnamese_qa_system_tpu_torch.models import ModelConfig, encoder_from_jax, init_encoder
from vietnamese_qa_system_tpu_torch.models.encoder import _relative_position_buckets

torch.set_num_threads(2)

SMALL = dict(vocab_size=300, d_model=128, n_heads=4, n_layers=2, d_ff=256, max_seq_len=300,
             use_flash_attention=True)
LAYOUTS = {
    "bert": dataclasses.replace(jc.minilm_class(), norm_position="post", bert_embeddings=True, **SMALL),
    "mpnet": dataclasses.replace(jc.mpnet_class(), **SMALL),
    "pre_ln": dataclasses.replace(jc.tiny_test("encoder"), **SMALL),
}


def _port_cfg(cfg):
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def _batch(t, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 260, (5, t)).astype(np.int32)
    lens = np.array([t, t // 2, 7, 1, 0])
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("t", [32, 256])
@pytest.mark.parametrize("layout", ["bert", "mpnet", "pre_ln"])
def test_sentence_embed_matches_jax(layout, t, bf16):
    cfg = dataclasses.replace(LAYOUTS[layout], activations_bf16=bf16)
    params = je.init_encoder(jax.random.key(0), cfg)
    ids, mask = _batch(t, 1)
    want = np.asarray(je.sentence_embed(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    model = encoder_from_jax(jax.tree.map(np.asarray, params), _port_cfg(cfg))
    with torch.inference_mode():
        got = model.sentence_embed(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    live = mask.sum(1) > 0
    cos = (got * want).sum(1)[live] / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))[live]
    assert cos.min() >= 0.9999
    np.testing.assert_allclose(got, want, atol=2e-3 if bf16 else 1e-4, rtol=0)


def test_relative_buckets_match_jax():
    for t in (16, 256, 514):
        pos = jnp.arange(t)
        want = np.asarray(je._relative_position_bucket(pos[None, :] - pos[:, None], 32, 128))
        np.testing.assert_array_equal(_relative_position_buckets(t, 32, 128), want)


def test_encoder_from_jax_is_strict():
    cfg = LAYOUTS["mpnet"]
    params = jax.tree.map(np.asarray, je.init_encoder(jax.random.key(0), cfg))
    del params["rel_bias"]
    with pytest.raises(RuntimeError, match="rel_bias"):
        encoder_from_jax(params, _port_cfg(cfg))


def test_init_encoder_seeded():
    cfg = _port_cfg(LAYOUTS["mpnet"])
    a = init_encoder(cfg, make_generator(3))
    b = init_encoder(cfg, make_generator(3))
    c = init_encoder(cfg, make_generator(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[n], sb[n]) for n in sa)
    assert not torch.equal(sa["blocks.0.attn.wq.w"], sc["blocks.0.attn.wq.w"])
    w = sa["blocks.0.mlp.wi.w"]
    assert w.abs().max() <= 1 / cfg.d_model ** 0.5 and abs(sa["tok_embed"].std().item() - 0.02) < 2e-3
    assert torch.equal(sa["blocks.1.ln2.scale"], torch.ones(cfg.d_model))
