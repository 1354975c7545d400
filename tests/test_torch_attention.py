"""Parity of the port's flash attention forward (plain CPU path of kernel
K4) with the JAX package's flash_attention (Pallas, interpret mode on the
CPU) and its XLA reference.  Non-causal, with kv_lens (including 0) and
with and without an (H, T, T) bias.  Tolerance: max abs 2e-2 on the bf16
outputs (a few bf16 ulps at |o| < 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.ops import attention as ja
from vietnamese_qa_system_tpu_torch.ops import attention as ta

torch.set_num_threads(2)

BF16_TOL = 2e-2


def _qkv(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


def _port(q, k, v, **kw):
    out = ta.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("with_bias", [False, True])
def test_matches_jax_flash_interpret(with_bias):
    b, t, h, d = 3, 256, 4, 32
    q, k, v = _qkv(b, t, h, d, 0)
    lens = np.array([t, 100, 0], np.int32)
    bias = np.random.default_rng(1).standard_normal((h, t, t)).astype(np.float32) if with_bias else None
    got = _port(q, k, v, kv_lens=torch.from_numpy(lens), bias=None if bias is None else torch.from_numpy(bias))
    want = np.asarray(ja.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lens=jnp.asarray(lens), causal=False,
        bias=None if bias is None else jnp.asarray(bias),
    ), np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("t", [64, 200])
def test_matches_jax_reference(t):
    b, h, d = 2, 2, 64
    q, k, v = _qkv(b, t, h, d, 2)
    lens = np.array([0, t // 3], np.int32)
    got = _port(q, k, v, kv_lens=torch.from_numpy(lens))
    want = np.asarray(ja.flash_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lens=jnp.asarray(lens), causal=False), np.float32)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 16)])
def test_port_reference_matches_jax_reference(causal, window):
    b, t, h, d = 2, 48, 2, 16
    q, k, v = _qkv(b, t, h, d, 3)
    lens = np.array([t, 20], np.int32)
    got = ta.flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                       kv_lens=torch.from_numpy(lens), causal=causal, window=window)
    want = ja.flash_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lens=jnp.asarray(lens),
                                        causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_plain_lse_and_zero_length_rows():
    """lse = log sum exp of the masked scores; a kv_len == 0 row averages V
    over all keys (finite NEG_INF), never NaN."""
    bh, t, d = 4, 96, 32
    rng = np.random.default_rng(4)
    qb, kb, vb = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(np.float32)).bfloat16() for _ in range(3))
    lens = torch.tensor([t, 50, 1, 0], dtype=torch.int32)
    o, lse = ta.flash_fwd(qb, kb, vb, lens, None, 2)
    s = qb.float() @ kb.float().transpose(1, 2)
    for r in range(3):
        want = torch.logsumexp(s[r, :, : int(lens[r])], dim=-1)
        torch.testing.assert_close(lse[r], want, atol=1e-2, rtol=0)
    torch.testing.assert_close(o[3].float(), vb[3].float().mean(0).expand(t, d), atol=BF16_TOL, rtol=0)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()


def test_unported_forms_raise():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError):
        ta.flash_attention(q, q, q)  # causal is the default
    with pytest.raises(NotImplementedError):
        ta.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(NotImplementedError):
        ta.flash_attention(q, q, q, causal=False, bias=torch.zeros(2, 1, 8))
