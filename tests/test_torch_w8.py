"""The port's w8 GEMM (kernel K6's plain version and the pure-Python rules
its CUDA kernel mirrors), its route gate and the int8 / int8c weight
quantization against the JAX package.

Tolerances: the plain version and the JAX kernel (interpret mode) both sum
f32 products of the same bf16 activations and int8 codes over all of K and
scale after the sum, in another order: max abs error <= 1e-5 of max |y|.
Codes and scales are compared bit for bit.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import quantize as jq
from vietnamese_qa_system_tpu.models.layers import dense as jdense
from vietnamese_qa_system_tpu.models.layers import init_dense
from vietnamese_qa_system_tpu.ops import w8_matmul as jw8
from vietnamese_qa_system_tpu_torch.core import make_generator
from vietnamese_qa_system_tpu_torch.models import ModelConfig, causal_from_jax, init_causal_lm
from vietnamese_qa_system_tpu_torch.models import quantize as tq
from vietnamese_qa_system_tpu_torch.models.layers import Dense
from vietnamese_qa_system_tpu_torch.ops import cuda_kernels
from vietnamese_qa_system_tpu_torch.ops import w8_matmul as tw8

torch.set_num_threads(2)
REL_TOL = 1e-5


def _codes(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    s = (np.abs(w).max(axis=0) / 127.0).astype(np.float32)
    q = np.clip(np.round(w / s[None, :]), -127, 127).astype(np.int8)
    return q, s


@pytest.mark.parametrize("m,k,n", [(8, 512, 640), (1, 256, 128), (37, 384, 1280), (256, 128, 256), (72, 384, 768),
                                   (256, 512, 1024)])
def test_plain_matches_jax_kernel_and_reference(m, k, n):
    rng = np.random.default_rng(m + k + n)
    q, s = _codes(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    kernel = np.asarray(jw8.w8_matmul(xb, jnp.asarray(q), jnp.asarray(s), out_dtype=jnp.float32))
    ref = np.asarray(jw8.w8_matmul_reference(xb, jnp.asarray(q), jnp.asarray(s), jnp.float32))
    got = tw8.w8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                        out_dtype=torch.float32).numpy()
    plain = tw8.w8_matmul_reference(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
                                    torch.from_numpy(s), torch.float32).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    scale = np.abs(ref).max()
    assert np.abs(got - kernel).max() <= REL_TOL * scale
    assert np.abs(got - ref).max() <= REL_TOL * scale
    np.testing.assert_array_equal(got, plain)


def test_supports_and_divisibility_match_jax():
    for m in (1, 8, 16, 255, 256, 257, 4096):
        for k in (64, 100, 128, 384, 640, 3072, 5632):
            for n in (96, 128, 200, 1280, 12288):
                assert tw8.supports(m, k, n) == jw8.supports(m, k, n), (m, k, n)
    with pytest.raises(ValueError, match="divisible"):
        tw8.w8_matmul(torch.zeros(8, 100), torch.zeros(100, 640, dtype=torch.int8), torch.ones(640))
    assert tw8.supports(300, 128, 128, max_rows=512)


@pytest.mark.parametrize("mode,d_in,block", [("int8c", 256, 64), ("int8c", 5632, 64), ("int8", 256, 64),
                                             ("int8", 384, 96), ("int8", 5632, 128)])
def test_quantize_weight_bit_identical(mode, d_in, block):
    w = np.random.default_rng(d_in).standard_normal((d_in, 96)).astype(np.float32) * 0.05
    w[3, 7] = 0.9  # an outlier
    w[:, 5] = 0.0  # an all-zero column: the 1e-12 absmax floor
    want = jq.quantize_weight(jnp.asarray(w), mode, block)
    got = tq.quantize_weight(torch.from_numpy(w), mode, block)
    assert got["w_q"].dtype == torch.int8 and got["w_s"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
    np.testing.assert_array_equal(got["w_s"].numpy(), np.asarray(want["w_s"]))
    back = tq.dequantize_weight(got["w_q"], got["w_s"], torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.dequantize_weight(want, jnp.float32)))
    if mode == "int8c":
        assert got["w_s"].shape == (1, 96)


def test_nf4_is_not_ported():
    # nf4 and nf4-dq are ported now (tests/test_torch_nf4.py holds them to
    # the JAX package): their leaves' layouts, and an unknown mode raising
    for mode, keys in (("nf4", {"w_q", "w_s"}), ("nf4-dq", {"w_q", "s_q", "s_s", "s_m"})):
        leaf = tq.quantize_weight(torch.zeros(64, 8), mode)
        assert set(leaf) == keys and leaf["w_q"].dtype == torch.uint8 and leaf["w_q"].shape == (32, 8)
    with pytest.raises(ValueError, match="mode"):
        tq.quantize_weight(torch.zeros(64, 8), "int4")


@pytest.mark.parametrize("mode", ["int8c", "int8"])
@pytest.mark.parametrize("rows", [4, 256, 300])
def test_dense_route_matches_jax(mode, rows):
    """int8c at <= 256 rows takes K6 (here its plain version), the JAX
    package the w8 kernel; 300 rows and blockwise int8 take the dequantize
    route (bf16 weight) in both."""
    p = init_dense(jax.random.key(0), 256, 384)
    leaf = {"b": p["b"] + 0.1, **jq.quantize_weight(p["w"], mode)}
    x = np.random.default_rng(rows).standard_normal((rows // 4, 4, 256)).astype(np.float32)
    want = np.asarray(jdense(leaf, jnp.asarray(x)))
    layer = Dense(256, 384)
    layer.set_quantized(torch.tensor(np.asarray(leaf["w_q"])), torch.tensor(np.asarray(leaf["w_s"])))
    layer.b = torch.nn.Parameter(torch.tensor(np.asarray(leaf["b"])))
    got = layer(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_quantize_dense_tree_matches_jax():
    """The port quantizes the same dense layers as the JAX package (not the
    untied LM head, not the embeddings), each to the bytes of the JAX
    ``quantize_weight``.  The JAX tree quantizer runs ``quantize_weight``
    under ``jax.jit``, where XLA turns ``absmax / 127`` into a product with
    the reciprocal: its scales are up to one ulp off the eager function,
    and a code that sits on a rounding tie moves by one."""
    cfg = dataclasses.replace(jc.llama_1b_class(), vocab_size=512, d_model=256, n_heads=4, n_kv_heads=2,
                              n_layers=2, d_ff=512)
    params = jax.tree.map(np.asarray, jlm.init_causal_lm(jax.random.key(0), cfg))
    pcfg = ModelConfig.from_dict(dataclasses.asdict(cfg))
    model = tq.quantize_dense_tree(causal_from_jax(params, pcfg, device="cpu"), "int8c")
    want = causal_from_jax(jax.tree.map(np.asarray, jq.quantize_dense_tree(params, "int8c")), pcfg, device="cpu")
    got_sd, want_sd = model.state_dict(), want.state_dict()
    assert got_sd.keys() == want_sd.keys()
    assert "lm_head.w" in got_sd and "blocks.0.mlp.wg.w_q" in got_sd and "tok_embed" in got_sd
    float_sd = causal_from_jax(params, pcfg, device="cpu").state_dict()
    for name in got_sd:
        assert got_sd[name].dtype == want_sd[name].dtype, name
        if name.endswith(".w_q"):
            eager = jq.quantize_weight(jnp.asarray(float_sd[name[:-2]].numpy()), "int8c")
            np.testing.assert_array_equal(got_sd[name].numpy(), np.asarray(eager["w_q"]))
            np.testing.assert_array_equal(got_sd[name[:-1] + "s"].numpy(), np.asarray(eager["w_s"]))
            moved = (got_sd[name].int() - want_sd[name].int()).abs()
            assert moved.max() <= 1 and moved.float().mean() < 1e-3, name
        elif name.endswith(".w_s"):
            np.testing.assert_array_max_ulp(got_sd[name].numpy(), want_sd[name].numpy(), maxulp=1)
        else:
            assert torch.equal(got_sd[name], want_sd[name]), name


def test_init_quantizes_layer_by_layer():
    cfg = ModelConfig.from_dict(dataclasses.asdict(dataclasses.replace(
        jc.phogpt_4b_class(), vocab_size=512, d_model=384, n_heads=6, n_layers=2, d_ff=768)))
    a = init_causal_lm(cfg, make_generator(5), quantize="int8c")
    b = tq.quantize_dense_tree(init_causal_lm(cfg, make_generator(5)), "int8c")
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert sa["blocks.1.mlp.wi.w_q"].dtype == torch.int8 and sa["blocks.1.mlp.wi.w_s"].shape == (1, 768)
    assert not any(k.endswith(".w") for k in sa)  # tied head: every dense layer is quantized


@pytest.mark.parametrize("kernel", cuda_kernels.KERNELS, ids=lambda k: k.name)
def test_kernel_registry_names_its_source_and_the_tpu_kernel(kernel):
    """Each registered kernel's C entry point is defined in the source file
    it names, and ``replaces`` points at a kernel function of the JAX
    package or, for a kernel where the TPU had none, at the lines of the
    JAX package's plain code that it takes over."""
    root = Path(__file__).resolve().parent.parent
    src = (root / kernel.source).read_text()
    c_api = src.split('extern "C" {', 1)[1]
    params = c_api.split(f"int {kernel.symbol}(", 1)[1].split(")", 1)[0]
    assert len(kernel.argtypes) == params.count(",") + 1
    path, line = kernel.replaces.split(":")
    assert path.startswith("vietnamese_qa_system_tpu/")
    lines = (root / path).read_text().splitlines()
    if "-" in line:
        first, last = map(int, line.split("-"))
        assert 1 <= first < last <= len(lines) and all(x.strip() for x in lines[first - 1: last])
        assert kernel.replaces in src  # the source note names what it takes over
    else:
        assert lines[int(line) - 1].startswith("def _")


# The stream-K split of K6 (ops/w8_matmul.py partition, mirrored by
# csrc/w8_matmul.cu): PhoGPT-4B's decode shapes at M 1-16, the engine's
# speculative M 72, prefill rows 64-256, a call with fewer units than
# slots, odd rows and an odd slot count.
PARTITION_CASES = [(1, 3072, 3072, 264), (8, 3072, 12288, 264), (16, 12288, 3072, 264), (64, 3072, 3072, 264),
                   (256, 3072, 12288, 264), (8, 128, 128, 264), (37, 384, 1280, 132), (8, 3072, 3072, 133),
                   (72, 3072, 12288, 132), (128, 12288, 3072, 132)]


@pytest.mark.parametrize("m,k,n,slots", PARTITION_CASES)
def test_w8_partition_is_one_wave_covering_every_unit_once(m, k, n, slots):
    """A unit spans every row: each weight tile is one unit, read once."""
    p = tw8.partition(m, k, n, slots)
    assert p.rows == tw8.padded_rows(m) >= m and p.cols == 64 * tw8.warpgroups(p.rows)
    assert p.units == -(-n // p.cols) * (k // 64) and p.tiles * p.cols >= n
    assert p.grid == min(slots, p.units) <= slots
    sizes = [len(p.share(b)) for b in range(p.grid)]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1  # equal shares to within one unit
    assert [u for b in range(p.grid) for u in p.share(b)] == list(range(p.units))  # each unit once
    assert all(p.block_of(u) == b for b in range(p.grid) for u in p.share(b))


@pytest.mark.parametrize("m,k,n,slots", PARTITION_CASES)
def test_w8_partition_sums_each_tile_in_split_order(m, k, n, slots):
    """Each output tile's segments run in block order over consecutive K
    chunks that cover its K once, and each segment has a slot of its own."""
    p = tw8.partition(m, k, n, slots)
    used = set()
    for tile in range(p.tiles):
        segs = p.segments(tile)
        blocks = [b for b, _ in segs]
        assert blocks == list(range(blocks[0], blocks[0] + len(blocks)))
        assert [c for _, chunks in segs for c in chunks] == list(range(p.chunks))
        for b, _ in segs:
            assert b + tile not in used and b + tile < p.slots
            used.add(b + tile)


@pytest.mark.parametrize("m,k,n,slots", PARTITION_CASES)
def test_w8_reducers_end_their_shares_in_the_tile_and_split_it_once(m, k, n, slots):
    """A split tile's reducers are the blocks whose shares end in it (at
    least one; only the tile's last block may run past it), and their
    slices cover the tile's float4s once, in order."""
    p = tw8.partition(m, k, n, slots)
    vecs = m * p.cols // 4
    for tile in range(p.tiles):
        segs = p.segments(tile)
        red = p.reducers(tile)
        if len(segs) == 1:
            continue  # one block holds the whole K: it writes y itself
        assert 1 <= len(red) and red.start == segs[0][0]
        for b, _ in segs:
            ends_inside = p.share(b).stop <= (tile + 1) * p.chunks
            assert (b in red) == ends_inside
            assert ends_inside or b == segs[-1][0]
        sliced = [f for kk in range(len(red)) for f in p.slice_of(kk, len(red), vecs)]
        assert sliced == list(range(vecs))


@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 33, 64, 65, 72, 73, 128, 129, 200, 256])
def test_w8_row_buckets_are_the_kernels(m):
    """The padded rows pick an instance the kernel is built for (its
    W8_BUCKETS list), at most 255 rows of zeros; 4 warpgroups (256
    columns a unit) up to 72 rows, 2 (128) above."""
    src = (Path(__file__).resolve().parent.parent / "vietnamese_qa_system_tpu_torch/csrc/w8_matmul.cu").read_text()
    built = src.split("#define W8_BUCKETS(X)", 1)[1].splitlines()[0]
    assert tuple(int(b) for b in re.findall(r"X\((\d+)\)", built)) == tw8.ROW_BUCKETS
    mp = tw8.padded_rows(m)
    assert mp >= m and mp in tw8.ROW_BUCKETS and all(b < m for b in tw8.ROW_BUCKETS if b < mp)
    assert tw8.cols_per_unit(mp) == (256 if mp <= 72 else 128)
    with pytest.raises(ValueError, match="at most 256"):
        tw8.padded_rows(257)


@pytest.mark.parametrize("mp", [8, 72, 256])
def test_w8_fragment_columns_replay_the_swap_ab_product(mp):
    """The fragment map, replayed on the host: each thread's wgmma A
    fragments (rows 16 w + g + 8 h, K rows 2t, 2t + 1 (+8) of a k16 step)
    filled from its two weight columns, B = x^T, D = A B, and each
    accumulator element (register 4 j + 2 h + e: x row 8 j + 2 t + e)
    written to y at the same column -- the product of the unit, every
    column held by one lane quad, a thread's two columns adjacent (one
    16-bit load, one float2 store)."""
    cols = tw8.fragment_columns(mp)
    quads = [c for tid, pair in enumerate(cols) if tid % 4 == 0 for c in pair]  # lanes 4g .. 4g + 3 share columns
    assert sorted(quads) == list(range(tw8.cols_per_unit(mp))) and all(cols[tid] == cols[tid - tid % 4]
                                                                        for tid in range(len(cols)))
    assert all(c1 == c0 + 1 and c0 % 2 == 0 for c0, c1 in cols)
    rng = np.random.default_rng(mp)
    w = rng.integers(-127, 128, (16, tw8.cols_per_unit(mp))).astype(np.float64)  # one k16 step
    x = rng.standard_normal((mp, 16))
    y = np.zeros((mp, w.shape[1]))
    for wg in range(tw8.warpgroups(mp)):
        a = np.zeros((64, 16))  # the warpgroup's A: 64 rows (weight columns) x 16 K
        for tid in range(128 * wg, 128 * (wg + 1)):
            w_, lane = tid // 32 % 4, tid % 32
            g, t = lane // 4, lane % 4
            for h in range(2):
                for kk in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9):
                    a[16 * w_ + g + 8 * h, kk] = w[kk, cols[tid][h]]
        d = a @ x.T  # (64, mp): the wgmma accumulator
        for tid in range(128 * wg, 128 * (wg + 1)):
            w_, lane = tid // 32 % 4, tid % 32
            g, t = lane // 4, lane % 4
            for j in range(mp // 8):
                for h in range(2):
                    for e in range(2):
                        y[8 * j + 2 * t + e, cols[tid][h]] = d[16 * w_ + g + 8 * h, 8 * j + 2 * t + e]
    np.testing.assert_allclose(y, x @ w, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("m,k,n,slots", [(8, 512, 256, 7), (20, 384, 384, 11), (72, 384, 512, 5), (100, 256, 640, 9)])
def test_w8_partition_partials_add_up_to_the_product(m, k, n, slots):
    """The kernel's arithmetic replayed on the host: per-segment f32
    partials of exact products over all rows, each reducer's float4s added
    over the slots in split order, scaled once."""
    rng = np.random.default_rng(m + k)
    q, s = _codes(rng, k, n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16).float()
    w = torch.from_numpy(q).float()
    p = tw8.partition(m, k, n, slots)
    y = torch.zeros(m, n)
    for tile in range(p.tiles):
        c0 = tile * p.cols
        cols = slice(c0, min(c0 + p.cols, n))
        parts = []
        for _, chunks in p.segments(tile):
            ks = slice(chunks.start * tw8.K_PER_UNIT, chunks.stop * tw8.K_PER_UNIT)
            part = torch.zeros(m, p.cols)
            part[:, : cols.stop - c0] = x[:, ks] @ w[ks, cols]
            parts.append(part.reshape(-1, 4))  # the slot row by row, in float4s
        red = p.reducers(tile)
        total = torch.zeros_like(parts[0])
        for kk in range(len(red)):
            f = list(p.slice_of(kk, len(red), m * p.cols // 4))
            acc = parts[0][f]
            for part in parts[1:]:
                acc = acc + part[f]
            total[f] = acc
        y[:, cols] = total.reshape(m, p.cols)[:, : cols.stop - c0] * torch.from_numpy(s)[cols]
    ref = tw8.w8_matmul_reference(x.to(torch.bfloat16), torch.from_numpy(q), torch.from_numpy(s), torch.float32)
    assert (y - ref).abs().max().item() <= REL_TOL * ref.abs().max().item()
