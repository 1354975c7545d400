"""Parity of the port's flash attention forward (plain CPU path of kernel
K4) with the JAX package's flash_attention (Pallas, interpret mode on the
CPU) and its XLA reference.  Non-causal, with kv_lens (including 0) and
with and without an (H, T, T) bias; the causal, window and key-only forms
and the backward are in test_torch_flash_bwd.py.  Tolerance: max abs 2e-2 on the bf16
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
    """Every form of the kernel is ported now: causal (the default), the
    window and the key-only bias run; a window without causal masking is
    refused, as in the JAX package."""
    q = torch.zeros(1, 8, 2, 16)
    assert ta.flash_attention(q, q, q).shape == (1, 8, 2, 16)
    assert ta.flash_attention(q, q, q, window=4).shape == (1, 8, 2, 16)
    assert ta.flash_attention(q, q, q, causal=False, bias=torch.zeros(2, 1, 8)).shape == (1, 8, 2, 16)
    with pytest.raises(ValueError, match="window requires causal"):
        ta.flash_attention(q, q, q, causal=False, window=4)


# the kernels' tiles: K4 128 query rows x 128 keys (64 with the full bias),
# K7 dK/dV 128 keys x 64 queries, dQ 128 rows x 64 keys; 64 is a consumer
# warpgroup's own rows
TILES = ((128, 128), (128, 64), (64, 64), (64, 128))
RANGE_CASES = [(False, None), (True, None), (True, 1), (True, 16), (True, 64), (True, 100)]


def _lens(t, seed):
    """kv_lens at every tile edge, 0, 1, T and a few random ones."""
    edges = [0, 1, 63, 64, 65, 127, 128, 129, t - 1, t]
    rand = np.random.default_rng(seed).integers(0, t + 1, 6).tolist()
    return sorted({x for x in edges + rand if 0 <= x <= t})


@pytest.mark.parametrize("causal,window", RANGE_CASES)
@pytest.mark.parametrize("t", [128, 200])
def test_key_tile_range_skips_only_tiles_without_kept_keys(causal, window, t):
    """K4's and dQ's key tiles against the plain mask ``_keep``: a skipped
    tile holds no key that a row of the query tile keeps; a tile of rows in
    which some row keeps no key at all (kv_len == 0, or past the window's
    reach of kv_len) visits every tile in the forward, where such a row
    averages V over all keys."""
    lens = _lens(t, t + (window or 0))
    keep = ta._keep(t, t, torch.tensor(lens), causal, window, "cpu")
    for bq, bk in TILES:
        nk = -(-t // bk)
        for b, kv_len in enumerate(lens):
            for r0 in range(0, t, bq):
                rows = keep[b, r0: r0 + bq]
                fwd = ta.key_tile_range(r0, bq, bk, t, t, kv_len, causal, window)
                dq = ta.key_tile_range(r0, bq, bk, t, t, kv_len, causal, window, all_if_empty=False)
                for lo, hi in (fwd, dq):
                    for tile in range(nk):
                        if not lo <= tile <= hi:
                            assert not rows[:, tile * bk: (tile + 1) * bk].any(), (kv_len, r0, bq, bk, tile)
                if (~rows.any(dim=1)).any():
                    assert fwd == (0, nk - 1), (kv_len, r0, bq, bk)
                if kv_len == 0:
                    assert dq[0] > dq[1], "dQ of a row with no kept key is zero: no tile"


@pytest.mark.parametrize("causal,window", RANGE_CASES)
@pytest.mark.parametrize("t", [128, 200])
def test_query_tile_range_skips_only_tiles_without_kept_pairs(causal, window, t):
    """K7 dK/dV's query tiles against ``_keep``: a skipped query tile holds
    no kept pair with the block's keys; keys at or past kv_len meet none."""
    lens = _lens(t, 7 * t + (window or 0))
    keep = ta._keep(t, t, torch.tensor(lens), causal, window, "cpu")
    for bk, bq in TILES:
        nq = -(-t // bq)
        for b, kv_len in enumerate(lens):
            for k0 in range(0, t, bk):
                cols = keep[b, :, k0: k0 + bk]
                lo, hi = ta.query_tile_range(k0, bk, bq, t, t, kv_len, causal, window)
                for tile in range(nq):
                    if not lo <= tile <= hi:
                        assert not cols[tile * bq: (tile + 1) * bq].any(), (kv_len, k0, bk, bq, tile)
                if k0 >= kv_len:
                    assert lo > hi


@pytest.mark.parametrize("causal,window,with_bias", [(False, None, True), (True, None, False), (True, 24, True)])
def test_tile_skip_reproduces_the_plain_forward(causal, window, with_bias):
    """An online softmax over only the key tiles ``key_tile_range`` leaves
    (the kernel's loop, in f32 here) equals the plain forward, rows with
    kv_len == 0 and windowed rows that keep no key included."""
    bh, h, t, d, bq, bk = 6, 2, 200, 32, 64, 32
    rng = np.random.default_rng(11)
    qb, kb, vb = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(np.float32)).bfloat16() for _ in range(3))
    lens = torch.tensor([0, 1, 37, 64, 150, t], dtype=torch.int32)
    bias = torch.from_numpy(rng.standard_normal((h, t, t)).astype(np.float32)) if with_bias else None
    want_o, want_lse = ta.flash_fwd_plain(qb, kb, vb, lens, bias, h, causal, window)
    s_all = ta._scores(qb, kb, bias, h)
    keep = ta._keep(t, t, lens, causal, window, "cpu")
    s_all = torch.where(keep, s_all, ta.NEG_INF)
    for b in range(bh):
        for r0 in range(0, t, bq):
            lo, hi = ta.key_tile_range(r0, bq, bk, t, t, int(lens[b]), causal, window)
            m = torch.full((min(bq, t - r0), 1), ta.NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros(m.shape[0], d)
            for tile in range(lo, hi + 1):
                s = s_all[b, r0: r0 + bq, tile * bk: (tile + 1) * bk]
                m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new).bfloat16().float()
                l = l * alpha + p.sum(dim=1, keepdim=True)
                acc = acc * alpha + p @ vb[b, tile * bk: (tile + 1) * bk].float()
                m = m_new
            got = (acc / l.clamp_min(1e-30)).bfloat16()
            torch.testing.assert_close(got.float(), want_o[b, r0: r0 + bq].float(), atol=BF16_TOL, rtol=0)
            torch.testing.assert_close((m + torch.log(l.clamp_min(1e-30))).squeeze(1), want_lse[b, r0: r0 + bq],
                                       atol=1e-2, rtol=0)


def test_tma_operand_rules():
    """The kernels read q, k, v, the bias, lse and dd by TMA: a misaligned
    operand is refused with a message before any launch, and the rows of
    the f32 operands are padded to a multiple of 4 floats (values kept,
    padding masked as keys past Tk or rows past Tq); the plain CPU path
    needs neither."""
    bh, t, d = 2, 9, 32
    base = torch.zeros(bh * t * d + 1, dtype=torch.bfloat16)
    q = torch.zeros(bh, t, d, dtype=torch.bfloat16)
    lens = torch.full((bh,), t, dtype=torch.int32)
    shifted = base[1:].view(bh, t, d)  # contiguous, 2 bytes past an aligned address
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ta._check(shifted, q, q, lens, None, 1, False, None)
    with pytest.raises(ValueError, match="head dims 32, 64 and 128"):
        ta._check(q[..., :16].contiguous(), q[..., :16].contiguous(), q[..., :16].contiguous(), lens, None, 1,
                  False, None)
    bias = torch.randn(2, t, t)
    padded = ta._f32_rows(bias)
    assert padded.shape == (2, t, 12) and padded.data_ptr() % 16 == 0
    assert torch.equal(padded[..., :t], bias) and not padded[..., t:].any()
    lse = torch.randn(bh, t)  # lse and dd rows: 1-D TMA boxes start at 16-byte multiples
    assert ta._f32_rows(lse).shape == (bh, 12) and torch.equal(ta._f32_rows(lse)[:, :t], lse)
    aligned = torch.randn(2, 1, 16)
    assert ta._f32_rows(aligned) is aligned and ta._f32_rows(None) is None
    # odd T with a full bias on the CPU: the plain path, as the JAX reference
    qf, kf, vf = _qkv(1, 9, 2, 32, 5)
    got = _port(qf, kf, vf, bias=bias)
    assert np.isfinite(got).all() and got.shape == (1, 9, 2, 32)
