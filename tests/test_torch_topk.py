"""Parity of the port's fused matmul + top-k (plain CPU path of kernels
K1-K3) with the JAX package.

- bf16: ids pass bench.py's rank-count rule against f32 scores, like the
  JAX exact mode and reference; scores agree within 1e-5 relative.
- int8 / int8_global: ids and scores equal the JAX exact mode exactly
  (integer products are exact; the scaling runs in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.ops import quant as jq
from vietnamese_qa_system_tpu.ops import topk as jt
from vietnamese_qa_system_tpu_torch.ops import topk as tt

torch.set_num_threads(2)


def _bf16_inputs(b, n, d, seed):
    """bf16-representable f32 arrays, so every path sees the same values."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).bfloat16().float().numpy()
    c = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).bfloat16().float().numpy()
    return q, c


def _rank_ok(q, c, ids, k, valid_n=None):
    """bench.py rule: fewer than k rows score strictly higher than each id."""
    scores = q.astype(np.float64) @ c[:valid_n].astype(np.float64).T
    picked = np.take_along_axis(scores, np.asarray(ids, np.int64), axis=1)
    counts = (scores[:, :, None] > picked[:, None, :]).sum(axis=1)
    return bool((counts < k).all())


@pytest.mark.parametrize("b,n,d,k", [(8, 1000, 64, 10), (3, 300, 128, 5), (16, 2048, 32, 40)])
def test_bf16_matches_jax_exact_and_reference(b, n, d, k):
    q, c = _bf16_inputs(b, n, d, 0)
    ts, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(c).bfloat16(), k)
    js, ji = jt.matmul_topk(jnp.asarray(q), jnp.asarray(c, jnp.bfloat16), k, mode="exact", tile_n=256)
    rs, ri = jt.matmul_topk_reference(jnp.asarray(q), jnp.asarray(c), k)
    assert ti.dtype == torch.int32 and ts.shape == (b, k)
    for ids in (ti.numpy(), np.asarray(ji), np.asarray(ri)):
        assert _rank_ok(q, c, ids, k)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
    assert (np.diff(ts.numpy(), axis=1) <= 0).all()


def test_bf16_reference_matches_jax_reference():
    q, c = _bf16_inputs(4, 500, 64, 1)
    ts, ti = tt.matmul_topk_reference(torch.from_numpy(q), torch.from_numpy(c), 7, valid_n=400)
    js, ji = jt.matmul_topk_reference(jnp.asarray(q), jnp.asarray(c), 7, valid_n=400)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)


def _int8_inputs(b, n, d, seed, *, global_scale):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if global_scale:
        codes, scales = jq.quantize_int8_global(jnp.asarray(x))
    else:
        codes, scales = jq.quantize_int8_reference(jnp.asarray(x))
    return q, np.asarray(codes), np.asarray(scales)


@pytest.mark.parametrize("global_scale", [False, True])
@pytest.mark.parametrize("mode", ["fast", "turbo", "exact"])
@pytest.mark.parametrize("valid_n", [None, 777])
def test_int8_equals_jax_exact(global_scale, mode, valid_n):
    b, n, d, k = 8, 1024, 64, 10
    q, codes, scales = _int8_inputs(b, n, d, 2, global_scale=global_scale)
    ts, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(codes), k,
                            corpus_scales=torch.from_numpy(np.asarray(scales)), valid_n=valid_n, mode=mode)
    js, ji = jt.matmul_topk(jnp.asarray(q), jnp.asarray(codes), k, corpus_scales=jnp.asarray(scales),
                            valid_n=valid_n, mode="exact")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_query_quantization_bit_identical():
    q = np.random.default_rng(3).standard_normal((6, 48)).astype(np.float32)
    q[2] = 0.0
    q_i8, qscale = tt.quantize_queries(torch.from_numpy(q))
    qf = jnp.asarray(q)
    js = jnp.maximum(jnp.max(jnp.abs(qf), axis=1, keepdims=True), 1e-12) / 127.0
    jcodes = jnp.clip(jnp.round(qf / js), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(q_i8.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(qscale.numpy(), np.asarray(js))


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_ties_resolve_to_lowest_index(mode):
    d = 32
    c = np.zeros((600, d), np.float32)
    c[::7] = 1.0  # 86 identical best rows
    q = np.ones((3, d), np.float32)
    _, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(c).bfloat16(), 12, mode=mode)
    _, ji = jt.matmul_topk_reference(jnp.asarray(q), jnp.asarray(c), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == list(range(0, 84, 7))


def test_int8_ties_resolve_to_lowest_index():
    c = np.zeros((500, 16), np.int8)
    c[3::5] = 9
    q = np.ones((2, 16), np.float32)
    scales = np.ones(500, np.float32)
    _, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(c), 6, corpus_scales=torch.from_numpy(scales))
    _, ji = jt.matmul_topk(jnp.asarray(q), jnp.asarray(c), 6, corpus_scales=jnp.asarray(scales), mode="exact")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [3, 8, 13, 18, 23, 28]


def test_valid_n_masks_trailing_rows():
    q, c = _bf16_inputs(4, 700, 64, 4)
    c[650:] = 100.0  # would win every query if it were not masked
    _, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(c), 10, valid_n=600)
    _, ri = jt.matmul_topk_reference(jnp.asarray(q), jnp.asarray(c), 10, valid_n=600)
    assert ti.max().item() < 600
    assert _rank_ok(q, c, ti.numpy(), 10, valid_n=600)
    np.testing.assert_array_equal(np.sort(ti.numpy(), 1), np.sort(np.asarray(ri), 1))


def test_error_paths_match_jax():
    q = np.zeros((2, 16), np.float32)
    codes = np.zeros((64, 16), np.int8)
    for fn, arr in ((tt.matmul_topk, torch.from_numpy), (jt.matmul_topk, jnp.asarray)):
        with pytest.raises(ValueError, match="corpus_scales"):
            fn(arr(q), arr(codes), 5)
        with pytest.raises(ValueError, match="valid rows"):
            fn(arr(q), arr(np.zeros((64, 16), np.float32)), 10, valid_n=5)
        with pytest.raises(ValueError, match="mode"):
            fn(arr(q), arr(np.zeros((64, 16), np.float32)), 5, mode="bogus")


def test_k_above_kernel_limit_raises():
    q = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="k must be"):
        tt.matmul_topk(q, torch.zeros(1000, 16), tt.MAX_K + 1)
    s, i = tt.matmul_topk(q, torch.randn(1000, 16), tt.MAX_K)
    assert i.shape == (2, tt.MAX_K) and len(set(i[0].tolist())) == tt.MAX_K
