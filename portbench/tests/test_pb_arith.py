"""Percentiles, spreads, roofline and MFU arithmetic on known inputs."""

import importlib

import pytest

from portbench import roofline, spec, stats


def test_percentile_and_spread():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 90) == pytest.approx(90.1)
    assert stats.percentile([3.0], 95) == 3.0
    # statistics.quantiles (exclusive): 1..9 -> q1 2.5, q3 7.5, median 5
    assert stats.spread(range(1, 10)) == pytest.approx(1.0)


def test_topk_bound_is_the_corpus_read():
    flops, nbytes = roofline.topk_call(256, 768, 1 << 20, 10)
    assert flops == 2 * 256 * (1 << 20) * 768
    t = roofline.bound_s(flops, nbytes)
    assert t == pytest.approx(nbytes / roofline.PEAK_HBM)
    assert t * 1e3 == pytest.approx(0.4808, rel=1e-3)  # the table of kernels' K1 bound


def test_w8_bound_at_decode_rows_is_the_weight_read():
    flops, nbytes = roofline.w8_call(32, 3072, 3072)
    assert nbytes == 3072 * 3072 + 4 * 3072 + 2 * 32 * 3072 + 4 * 32 * 3072
    assert roofline.bound_s(flops, nbytes) == pytest.approx(nbytes / roofline.PEAK_HBM)


def test_flash_counts_valid_pairs_only():
    f_full, b_full = roofline.flash_fwd_call([512, 512], 12, 64, 512, 512)
    f_half, b_half = roofline.flash_fwd_call([256, 256], 12, 64, 512, 512)
    assert f_full == 4 * f_half
    assert f_full == 4.0 * 64 * 12 * 2 * 512 * 512
    assert b_half < b_full


def test_model_flops():
    c = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2}
    # per layer: 2 x tokens x (4 d^2 + 2 d f) + 4 x sum(len^2) x d
    assert roofline.encoder_flops(c, [3]) == 2 * (2 * 3 * (64 + 64) + 4 * 9 * 4)
    m = {"d_model": 4, "n_layers": 1, "expansion_ratio": 2, "vocab_size": 10}
    assert roofline.decoder_flops(m, 2, 5) == 2 * 2 * (64 + 64 + 40) + 4 * 4 * 5


def test_share_is_silent_without_a_measurement():
    assert roofline.share(1.0, 0.0) is None
    assert roofline.share(0.0, 1.0) is None
    assert roofline.share(1.0, 4.0) == 25.0


@pytest.mark.parametrize("name", ["search_mfu", "ingest_mfu", "gen_mfu"])
def test_mfu_readers(name):
    read = spec.load_module("metrics", name).read
    assert read({"flops": roofline.PEAK_BF16 * 2.0, "elapsed_s": 4.0}) == pytest.approx(50.0)
    assert read({}) is None


def test_shares_of_the_host_spans():
    enc = spec.load_module("metrics", "query.encode_share").read
    emb = spec.load_module("metrics", "ingest.embed_share").read
    assert enc({"encode_s": 3.0, "elapsed_s": 4.0}) == 75.0
    assert emb({"embed_s": 1.0, "elapsed_s": 4.0}) == 25.0
    assert enc({}) is None


def test_rooflines_from_launches():
    n = 1 << 20
    t = roofline.bound_s(*roofline.topk_call(256, 768, n, 10))
    rec = {"trace": {"launches": {"matmul_topk_bf16": [([1, 256, 768, n, 10, 0, 4, 33, 3], 4 * t)]}}}
    assert spec.load_module("metrics", "topk_roofline").read(rec) == pytest.approx(25.0)
    w = roofline.bound_s(*roofline.w8_call(32, 3072, 12288))
    rec = {"trace": {"launches": {"w8_matmul": [([32, 3072, 12288, 64, 132], 2 * w)]}, "kernel_s": {}}}
    assert spec.load_module("metrics", "w8_roofline").read(rec) == pytest.approx(50.0)
    assert spec.load_module("metrics", "w8_roofline").read({"trace": None}) is None
    assert spec.load_module("metrics", "w8_roofline").read({"trace": {"launches": {}, "kernel_s": {}}}) is None


def test_flash_roofline_pairs_launches_with_blocks():
    lens = [[512] * 4, [300] * 4]
    launches = []
    expect = 0.0
    for block in lens:
        for _ in range(2):  # two layers
            b = roofline.bound_s(*roofline.flash_fwd_call(block, 12, 64, 512, 512, 512))
            launches.append(([512, 48, 12, 512, 512, 64, 0, 0], 2 * b))
            expect += b
    rec = {"trace": {"launches": {"flash_attention_fwd": launches}}, "traced_block_lens": lens}
    assert spec.load_module("metrics", "flash_fwd_roofline").read(rec) == pytest.approx(50.0)
    rec["traced_block_lens"] = lens[:1] * 3  # launches that do not split into the blocks: silent
    assert spec.load_module("metrics", "flash_fwd_roofline").read(rec) is None


def test_ttft_and_occupancy_readers():
    assert spec.load_module("metrics", "ttft_p50_ms").read({"ttft_ms": [1.0, 2.0, 3.0]}) == 2.0
    assert spec.load_module("metrics", "ttft_p50_ms").read({"ttft_ms": []}) is None
    assert spec.load_module("metrics", "gen_occupancy").read({"occupancy": 31.5}) == 31.5
    importlib.invalidate_caches()
