"""Parity of the port's fused matmul + top-k (plain CPU path of kernels
K1-K3) with the JAX package, and the cluster scan's shape rules.

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


@pytest.mark.parametrize("b,ctas", [(1, 1), (8, 1), (64, 1), (65, 2), (128, 2), (129, 4), (200, 4), (256, 4),
                                    (257, 4), (512, 4)])
def test_cluster_size_holds_the_query_tiles(b, ctas):
    """K1's cluster: the power of two of 64-query CTAs that holds the
    batch, at most 4 (256 queries); larger batches run in groups of 256."""
    assert tt.cluster_size(b) == ctas
    assert ctas * 64 >= min(b, 256) and (ctas == 1 or (ctas // 2) * 64 < min(b, 256))


# (k, D, route, ring stages of the form the route picks): the serving
# shape, the largest list k at D 768, the k past it and the rerank's k
# (the pool form), the widths that leave too little shared memory or do
# not fill whole 64-column panels
ROUTE_CASES = [(10, 768, "cluster", 7), (40, 768, "cluster", 5), (60, 768, "cluster", 4), (61, 768, "large", 7),
               (64, 768, "large", 7), (256, 768, "large", 7), (10, 64, "cluster", 8), (64, 512, "cluster", 5),
               (10, 1024, "cluster", 5), (10, 1536, "scan", 1), (10, 32, "scan", None), (10, 96, "scan", None),
               (100, 768, "large", 7), (256, 1024, "large", 5), (256, 1536, "scan", None)]
_FIXED = 8 * 25  # the barriers


def _smem(k, d, stages, *, int8=False, pools=False, scales=None):
    """The cluster scan's shared memory: queries, the ring (K2: and each
    stage's 512 B of scales; K3 none), the lists and queues (int8 at k >
    16: and the floors' state) or the floors' state alone (pools: rows'
    counts, thresholds, floors, 8 published maxima, histograms), the
    barriers."""
    scales = int8 if scales is None else scales
    queries = 64 * 128 * -(-d * (1 if int8 else 2) // 128)
    floors = 2 * 64 * (16 + 4 * 8) + 8 * 256 * 4
    select = floors if pools else 1024 * k + 8 * 64 * 12 + (floors if int8 and k > 16 else 0)
    return queries + select + _FIXED + stages * (16384 + (512 if scales else 0))


@pytest.mark.parametrize("k,d,route,stages", ROUTE_CASES)
def test_bf16_route_rule(k, d, route, stages):
    """The list form where its shared memory (queries, a ring of 4-8 16 KB
    stages, two warpgroups' lists, queues, barriers) fits a block; the pool
    form where the ring fits beside the queries alone; the tile scan
    otherwise."""
    assert tt.bf16_route(k, d) == route
    if stages is not None:
        assert tt.cluster_stages(k, d, pools=route == "large") == stages
    if route != "scan":
        assert 4 <= stages <= 8 and _smem(k, d, stages, pools=route == "large") <= 232_448 and d % 64 == 0
        assert _smem(k, d, stages + 1, pools=route == "large") > 232_448 or stages == 8
    if route == "cluster":
        assert k <= tt.CLUSTER_MAX_K
    if route == "large":  # the list form would not leave 4 stages
        assert k > tt.CLUSTER_MAX_K or tt.cluster_stages(k, d) < 4


# K2's route: int8 panels of 128 columns (the queries take d bytes a row),
# 512 B of scales a stage, the lists' floors; D <= 1024 (exact f32
# scores), D % 64 == 0
INT8_ROUTE_CASES = [(10, 768, "cluster", 8), (40, 768, "cluster", 7), (64, 768, "cluster", 5), (65, 768, "large", 8),
                    (100, 768, "large", 8), (256, 768, "large", 8), (10, 64, "cluster", 8), (64, 1024, "cluster", 4),
                    (256, 1024, "large", 8), (10, 1088, "scan", None), (10, 720, "scan", None), (256, 96, "scan", None)]


@pytest.mark.parametrize("k,d,route,stages", INT8_ROUTE_CASES)
def test_int8_route_rule(k, d, route, stages):
    assert tt.int8_route(k, d) == route
    if route != "scan":
        assert tt.cluster_stages(k, d, elem="int8", pools=route == "large") == stages
        assert 4 <= stages <= 8 and _smem(k, d, stages, int8=True, pools=route == "large") <= 232_448
        assert _smem(k, d, stages + 1, int8=True, pools=route == "large") > 232_448 or stages == 8
    # int8_res's auto-rerank of 4 k at the default k 10 takes the list form
    assert tt.int8_route(40, 768) == "cluster"


def test_routes_follow_k_at_the_serving_width():
    assert [tt.bf16_route(k, 768) for k in (1, 60, 61, 100, 256)] == ["cluster"] * 2 + ["large"] * 3
    assert [tt.int8_route(k, 768) for k in (1, 64, 65, 256)] == ["cluster"] * 2 + ["large"] * 2


# K3's route: K2's rule over 16 KB stages (no row scales), so the same
# selection state leaves room for one more stage at some shapes: (k, D,
# route, K3's stages, K2's stages)
INT8_GLOBAL_ROUTE_CASES = [(10, 768, "cluster", 8, 8), (40, 768, "cluster", 7, 7), (44, 768, "cluster", 7, 6),
                           (60, 768, "cluster", 6, 5), (64, 768, "cluster", 5, 5), (65, 768, "large", 8, 8),
                           (256, 768, "large", 8, 8), (10, 64, "cluster", 8, 8), (28, 1024, "cluster", 7, 6),
                           (61, 1024, "cluster", 5, 4), (64, 1024, "cluster", 4, 4), (256, 1024, "large", 8, 8),
                           (10, 1088, "scan", None, None), (10, 720, "scan", None, None),
                           (256, 96, "scan", None, None), (10, 32, "scan", None, None)]


@pytest.mark.parametrize("k,d,route,stages,int8_stages", INT8_GLOBAL_ROUTE_CASES)
def test_int8_global_route_rule(k, d, route, stages, int8_stages):
    assert tt.int8_global_route(k, d) == route == tt.int8_route(k, d)
    if route == "scan":
        return
    pools = route == "large"
    assert tt.cluster_stages(k, d, elem="int8_global", pools=pools) == stages
    assert tt.cluster_stages(k, d, elem="int8", pools=pools) == int8_stages
    assert 4 <= stages <= 8 and _smem(k, d, stages, int8=True, pools=pools, scales=False) <= 232_448
    assert _smem(k, d, stages + 1, int8=True, pools=pools, scales=False) > 232_448 or stages == 8


@pytest.mark.parametrize("k", [1, 10, 16, 17, 40, 64, 100, 256])
def test_floors_follow_the_element_form(k):
    """The pools always publish maxima for a floor; the lists of the int8
    forms (K2 and K3) only past 16 entries; bf16's lists never."""
    for pools in (False, True):
        assert tt._has_floors(k, "bf16", pools) is pools
        assert tt._has_floors(k, "int8", pools) == tt._has_floors(k, "int8_global", pools) == (pools or k > 16)
    with pytest.raises(ValueError, match="element form"):
        tt._has_floors(k, "int4", False)


def test_cluster_info_and_capacity_are_keyed_on_the_element_form(monkeypatch):
    """The resource query gets each form's own code (K1 0, K2 1, K3 2), and
    the occupancy cache holds K2 and K3 apart."""
    asked = []

    def fake_query(file, symbol, *args):
        asked.append((file, symbol) + args)
        return [30 + args[0], 130, 200_000, 0, 8, 1, 0, 0]

    monkeypatch.setattr(tt, "query", fake_query)
    infos = {elem: tt.cluster_info(4, 10, 768, elem=elem) for elem in ("bf16", "int8", "int8_global")}
    assert [a[2] for a in asked] == [0, 1, 2]
    assert all(a[:2] == ("topk.cu", "vqa_topk_cluster_info") and a[3:] == (4, 10, 768) for a in asked)
    assert {e: i["max_clusters"] for e, i in infos.items()} == {"bf16": 30, "int8": 31, "int8_global": 32}
    assert infos["int8_global"]["form"] == "cluster"
    tt._cluster_capacity.cache_clear()
    try:
        assert tt._cluster_capacity(-1, "int8", 4, 10, 768) == 31
        assert tt._cluster_capacity(-1, "int8_global", 4, 10, 768) == 32
        assert tt._cluster_capacity(-1, "int8", 4, 10, 768) == 31  # cached
    finally:
        tt._cluster_capacity.cache_clear()
    assert [a[2] for a in asked] == [0, 1, 2, 1, 2]


@pytest.mark.parametrize("kernel,dtype,scales", [("TOPK_INT8", torch.int8, False),
                                                 ("TOPK_INT8_GLOBAL", torch.int8, True),
                                                 ("TOPK_INT8_GLOBAL", torch.bfloat16, False),
                                                 ("TOPK_BF16", torch.int8, False)])
def test_cluster_scan_refuses_another_element_form(kernel, dtype, scales):
    """K2's kernel never runs without row scales, nor K3's with them, nor
    any on queries of another type: the call raises before any launch."""
    q = torch.zeros(4, 64, dtype=dtype)
    corpus = torch.zeros(256, 64, dtype=dtype)
    s = torch.ones(256) if scales else None
    with pytest.raises(ValueError, match="takes"):
        tt._cluster_cuda(getattr(tt, kernel), q, corpus, s, 256, 10, "cluster")


def test_merge_key_orders_like_beats():
    """Ascending keys = (score desc, index asc), on scores with many ties,
    signed zeros and infinities."""
    rng = np.random.default_rng(7)
    s = rng.choice(np.array([-np.inf, -2.5, -1.0, -0.0, 0.0, 1e-30, 1.0, 3.0, np.inf], np.float32), 500)
    i = rng.permutation(500).astype(np.int32)
    key = tt.merge_key(torch.from_numpy(s), torch.from_numpy(i))
    by_key = torch.argsort(key).numpy()
    by_rule = np.lexsort((i, -s))  # -(-0.0) == -(+0.0): signed zeros tie, then the index decides
    np.testing.assert_array_equal(by_key, by_rule)


def test_merge_key_ranks_signed_zeros_equal():
    k = lambda s, i: int(tt.merge_key(torch.tensor([s], dtype=torch.float32), torch.tensor([i]))[0])
    assert k(-0.0, 4) == k(0.0, 4)
    assert k(0.0, 3) < k(-0.0, 5) and k(-0.0, 3) < k(0.0, 5)
    assert k(1e-38, 9) < k(0.0, 0) < k(-1e-38, 0)
    # the padding of a short candidate list ranks after every real entry
    assert k(float("-inf"), 2 ** 31 - 2) < k(float("-inf"), 2 ** 31 - 1)
    assert k(3.0, 2 ** 31 - 2) < k(3.0, 2 ** 31 - 1)


def _radix_select(keys, k):
    """The merge's selection (csrc/topk.cu topk_merge_kernel and
    keep_best), in Python over unsigned 64-bit keys: 8-bit digits from the
    top, a histogram of the keys still tied with the prefix each pass,
    stopping once every key of the chosen bin is kept; returns the keys at
    or below the prefix."""
    prefix, need, shift = 0, k, 56
    for p in range(8):
        shift = 56 - 8 * p
        live = [x for x in keys if p == 0 or x >> (shift + 8) == prefix]
        hist = np.bincount([(x >> shift) & 255 for x in live], minlength=256)
        run = np.cumsum(hist)
        b = int(np.searchsorted(run, need))  # the first bin whose running count reaches need
        before = int(run[b] - hist[b])
        prefix, need = (prefix << 8) | b, need - before
        if hist[b] == need:
            break
    return [x for x in keys if x >> shift <= prefix]


@pytest.mark.parametrize("k", [1, 10, 100, 256])
def test_merge_radix_select_keeps_exactly_the_k_best(k):
    """Candidates as the merge sees them: per-part lists padded with
    (-inf, INT_MAX), integer scores that tie often, signed zeros."""
    rng = np.random.default_rng(k)
    m = 4 * 256
    s = rng.integers(-3, 4, m).astype(np.float32)
    s[rng.random(m) < 0.1] = -0.0
    i = rng.permutation(m).astype(np.int32)
    s[-40:], i[-40:] = -np.inf, 2 ** 31 - 1
    keys = [int(x) + (1 << 63) for x in tt.merge_key(torch.from_numpy(s), torch.from_numpy(i))]
    kept = _radix_select(keys, k)
    assert len(kept) == k and sorted(kept) == sorted(keys)[:k]


def _tied_bf16(b, n, d, seed):
    """Entries in {-1, 0, 1} / 2: every product and sum is exact in f32, and
    scores tie in large groups, so ids must agree exactly."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(-1, 2, (b, d)) / 2).astype(np.float32)
    c = (rng.integers(-1, 2, (n, d)) / 2).astype(np.float32)
    return q, c


@pytest.mark.parametrize("k", [100, 256])
def test_bf16_large_k_matches_jax_exact_and_reference_on_ties(k):
    q, c = _tied_bf16(5, 1100, 64, k)
    ts, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(c).bfloat16(), k, valid_n=1000)
    js, ji = jt.matmul_topk(jnp.asarray(q), jnp.asarray(c, jnp.bfloat16), k, mode="exact", tile_n=256, valid_n=1000)
    rs, ri = jt.matmul_topk_reference(jnp.asarray(q), jnp.asarray(c), k, valid_n=1000)
    for ids, scores in ((ji, js), (ri, rs)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ids))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(scores))
    assert ti.max().item() < 1000


@pytest.mark.parametrize("k", [100, 256])
@pytest.mark.parametrize("valid_n", [None, 1777])
def test_int8_large_k_equals_jax_exact_on_repeated_rows(k, valid_n):
    """int8 codes with per-row scales where whole rows repeat: integer
    scores tie across rows, and ids and scores equal the JAX exact mode."""
    rng = np.random.default_rng(k)
    base = rng.standard_normal((300, 64)).astype(np.float32)
    x = base[rng.integers(0, 300, 2048)]
    codes, scales = jq.quantize_int8_reference(jnp.asarray(x))
    q = rng.standard_normal((6, 64)).astype(np.float32)
    ts, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(np.asarray(codes)), k,
                            corpus_scales=torch.from_numpy(np.asarray(scales)), valid_n=valid_n)
    js, ji = jt.matmul_topk(jnp.asarray(q), codes, k, corpus_scales=scales, valid_n=valid_n, mode="exact")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _global_inputs(corpus, valid_n, seed):
    """int8 codes with one global scale, tie-heavy by construction:
    ``repeated`` -- 2,048 rows drawn from 300 distinct ones (quantized by
    the JAX package), so each row's raw score ties with its copies;
    ``low_range`` -- codes in {-1, 0, 1} against queries of 2 or 3 equal
    nonzero entries, so raw scores take at most 7 values and dozens to
    hundreds of rows tie at the k-th."""
    rng = np.random.default_rng(seed)
    if corpus == "repeated":
        base = rng.standard_normal((300, 64)).astype(np.float32)
        codes, scale = jq.quantize_int8_global(jnp.asarray(base[rng.integers(0, 300, 2048)]))
        return rng.standard_normal((6, 64)).astype(np.float32), np.asarray(codes), np.asarray(scale)
    codes = rng.integers(-1, 2, (2048, 64)).astype(np.int8)
    q = np.zeros((6, 64), np.float32)
    for r in range(6):
        q[r, rng.choice(64, 2 + r % 2, replace=False)] = rng.choice([-1.0, 1.0], 2 + r % 2)
    return q, codes, np.float32(0.0123)


@pytest.mark.parametrize("corpus", ["repeated", "low_range"])
@pytest.mark.parametrize("k", [10, 40, 100, 256])
@pytest.mark.parametrize("valid_n", [None, 2048 - 777])
def test_int8_global_equals_jax_exact_on_tied_rows(corpus, k, valid_n):
    """K3 (one global scale: selection on the raw sums) on corpora where
    raw scores tie across many rows: ids and scores equal the JAX exact
    mode, ties going to the lowest index."""
    q, codes, scale = _global_inputs(corpus, valid_n, k)
    ts, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(codes), k,
                            corpus_scales=torch.tensor(scale), valid_n=valid_n)
    js, ji = jt.matmul_topk(jnp.asarray(q), jnp.asarray(codes), k, corpus_scales=jnp.asarray(scale),
                            valid_n=valid_n, mode="exact")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if corpus == "low_range":  # the tie-heavy case it is meant to be
        q_i8, _ = tt.quantize_queries(torch.from_numpy(q))
        s_raw, _ = tt.topk_int8_global_plain(q_i8, torch.from_numpy(codes), valid_n or 2048, k)
        raw = q_i8.float() @ torch.from_numpy(codes[:valid_n]).float().T
        assert ((raw == s_raw[:, -1:]).sum(1) >= 40).all()


@pytest.mark.parametrize("b,k", [(300, 10), (8, 256), (70, 61)])
def test_bf16_topk_across_routes_and_groups_matches_reference(b, k):
    """Batches past one cluster's 256 queries and k on the list and pool
    forms (the CPU runs the plain version of each)."""
    q, c = _bf16_inputs(b, 1500, 64, 5)
    ts, ti = tt.matmul_topk(torch.from_numpy(q), torch.from_numpy(c).bfloat16(), k)
    rs, ri = jt.matmul_topk_reference(jnp.asarray(q), jnp.asarray(c), k)
    assert _rank_ok(q, c, ti.numpy(), k)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
