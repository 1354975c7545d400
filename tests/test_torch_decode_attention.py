"""Kernel K9 (ops/decode_attention.py) on the CPU: its plain version against
the einsum branch of ``Attention.forward`` (``layers.masked_attention``,
kept as the reference) over key-only ALiBi, per-row and no biases, masks
with holes, a row with no valid key, decode steps and speculative windows
with per-query masks, grouped heads and the guard column; K9's route in
``Attention.forward`` (the card's rule applied to CPU tensors, so the
plain version stands in for the kernel) and, through test_torch_causal's
decode parity, against the JAX package; the split plan; the counters the
benchmark's share metric reads.

The plain version runs the same operators as the einsum branch, so a row
with a valid key is bit-equal to it; a row with none gives 0 there (the
einsum's finite -1e30 averages V over every column)."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_causal as tc
from portbench import spec
from vietnamese_qa_system_tpu_torch.core import tracing
from vietnamese_qa_system_tpu_torch.models import layers, make_cache
from vietnamese_qa_system_tpu_torch.ops import decode_attention as da

TOTAL = 96  # attended columns; the buffers hold one more (the guard column)


def _inputs(b, h, kv_h, d, tq, bias_kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, h, d, generator=g)
    k, v = (torch.randn(b, TOTAL + 1, kv_h, d, generator=g).to(torch.bfloat16) for _ in range(2))
    lens = torch.randint(TOTAL // 3, TOTAL - tq, (b,), generator=g)
    cols = torch.arange(TOTAL)[None, :]
    hole = (cols >= 5) & (cols < 5 + torch.randint(0, 9, (b, 1), generator=g))  # a padding hole in each row
    valid = (cols < lens[:, None]) & ~hole
    if tq == 1:
        mask = valid[:, None, :]
    else:  # a speculative window: query j also sees the window's columns up to cursor + j
        steps = torch.arange(tq)[None, :, None]
        mask = valid[:, None, :] | ((cols[:, None, :] >= lens[:, None, None]) & (cols[:, None, :] <= lens[:, None, None] + steps))
    bias = {None: None, "alibi": layers.alibi_bias(h, TOTAL, "mpt", 8.0),
            "rows": torch.randn(b, h, 1, TOTAL, generator=g)}[bias_kind]
    return q, k, v, mask, bias


def _einsum(q, k, v, mask, bias, scale=None):
    """The einsum branch as Attention.forward runs it over a cache."""
    n = mask.shape[-1]
    rep = q.shape[2] // k.shape[2]
    kk, vv = (x[:, :n].repeat_interleave(rep, dim=2) for x in (k, v))
    return layers.masked_attention(q, kk, vv, mask=mask, bias=bias, scale=scale)


CASES = [(b, h, kv_h, d, tq, bias) for b, h, kv_h, d in ((3, 4, 4, 64), (2, 8, 2, 64), (2, 6, 3, 128))
         for tq in (1, 9) for bias in (None, "alibi", "rows")]


@pytest.mark.parametrize("b,h,kv_h,d,tq,bias_kind", CASES)
def test_plain_version_equals_the_einsum_branch(b, h, kv_h, d, tq, bias_kind):
    q, k, v, mask, bias = _inputs(b, h, kv_h, d, tq, bias_kind)
    got = da.decode_attention(q, k, v, mask, bias)  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == (b, tq, h, d)
    assert torch.equal(got, _einsum(q, k, v, mask, bias))
    scale = 0.37
    assert torch.equal(da.decode_attention(q, k, v, mask, bias, scale=scale), _einsum(q, k, v, mask, bias, scale))


@pytest.mark.parametrize("tq", [1, 9])
def test_a_row_with_no_valid_key_gives_zero(tq):
    q, k, v, mask, bias = _inputs(3, 4, 2, 64, tq, "alibi")
    mask = mask.clone()
    mask[1] = False  # a free slot
    if tq > 1:
        mask[2, 3] = False  # one query of a window
    got = da.decode_attention(q, k, v, mask, bias)
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all()
    want = _einsum(q, k, v, mask, bias)
    assert torch.equal(got[0], want[0])
    if tq > 1:
        assert (got[2, 3] == 0).all() and torch.equal(got[2, :3], want[2, :3])


@pytest.mark.parametrize("tq", [1, 9])
def test_the_guard_column_and_later_columns_are_never_read(tq):
    q, k, v, mask, bias = _inputs(2, 4, 4, 64, tq, "alibi")
    want = da.decode_attention(q, k, v, mask, bias)
    k2, v2 = k.clone(), v.clone()
    k2[:, TOTAL:], v2[:, TOTAL:] = float("nan"), float("nan")
    assert torch.equal(da.decode_attention(q, k2, v2, mask, bias), want)
    # the columns a row's mask leaves out weigh exactly 0, whatever they hold
    k3, v3 = k.clone(), v.clone()
    off = ~mask.any(dim=1)
    k3[:, :TOTAL][off], v3[:, :TOTAL][off] = 1e4, -1e4
    assert torch.equal(da.decode_attention(q, k3, v3, mask, bias), want)


def _attention(h, kv_h, d):
    attn = layers.Attention(h * d, q_dim=h * d, kv_dim=kv_h * d, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in attn.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return attn


# (cache kind, Tq, head dim, mask given, cross) -> takes K9 under the card's rule
ROUTES = [
    ("bf16", 1, 128, True, False, True),      # a decode step
    ("bf16", 9, 128, True, False, True),      # a speculative verify window
    ("bf16", 16, 64, True, False, True),      # the widest window
    ("bf16", 17, 64, True, False, False),     # wider: a prefill
    ("bf16", 32, 32, True, False, False),     # a prefill at a bucket
    ("bf16", 1, 80, True, False, False),      # an unsupported head dim
    ("bf16", 1, 32, True, False, False),      # another
    ("bf16", 1, 64, False, False, False),     # no mask
    ("int8", 1, 64, True, False, False),      # the int8 KV cache
    ("int8", 9, 128, True, False, False),
    ("none", 1, 64, True, True, False),       # cross-attention (no cache)
]


@pytest.mark.parametrize("kind,tq,d,with_mask,cross,takes", ROUTES)
def test_route_rule(kind, tq, d, with_mask, cross, takes, monkeypatch):
    """Which cached calls Attention.forward gives K9 under the card's rule
    (``fits`` standing in for ``supports`` on CPU tensors), and that both
    routes give the einsum branch's output."""
    h, kv_h, b, width = 4, (4 if cross else 2), 2, 40
    attn = _attention(h, kv_h, d)
    x = torch.randn(b, tq, h * d, generator=torch.Generator().manual_seed(1))
    calls = []
    real = layers.decode_attention
    monkeypatch.setattr(layers, "decode_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(n_heads=h, n_kv_heads=kv_h)
    if cross:
        kw["kv_x"] = torch.randn(b, 7, h * d, generator=torch.Generator().manual_seed(2))
    else:
        cfg = types.SimpleNamespace(kv_heads=kv_h, head_dim=d, n_layers=1)
        kw["cache"] = make_cache(cfg, b, width + 1, "cpu", kv_dtype=kind)[0]
        kw["cache_index"] = torch.tensor([3, 9])
    n_keys = 7 if cross else width
    if with_mask:
        kw["mask"] = torch.ones(b, tq, n_keys, dtype=torch.bool).tril(diagonal=n_keys - tq)
    with torch.inference_mode():
        want = attn(x, **kw)
        assert not calls  # on the CPU the einsum keeps every call
        if kind != "none":
            for name in kw["cache"]:
                kw["cache"][name].zero_()
        monkeypatch.setattr(layers, "decode_attn_supports", da.fits)
        got = attn(x, **kw)
    assert bool(calls) == takes
    assert torch.equal(got, want)


def test_supports_is_false_off_the_card():
    q, k, v, _, _ = _inputs(2, 4, 4, 64, 1, None)
    assert da.fits(q, k, v) and not da.supports(q, k, v)
    assert not da.fits(q, k.float(), v.float())  # an f32 cache
    padded = torch.zeros(2, TOTAL + 1, 4, 68, dtype=torch.bfloat16)[..., :64]  # heads 136 bytes apart
    assert not da.fits(q, padded, padded)
    assert not da.fits(q.expand(2, 17, 4, 64), k, v)  # more than MAX_TQ positions


@pytest.mark.parametrize("name", list(tc.PRESETS))
def test_cached_step_through_k9_matches_jax(name, monkeypatch):
    """test_torch_causal's prefill + cached step against the JAX package,
    with the card's route: the step of every preset whose head dim K9
    takes runs its plain version; the 20-wide prefill keeps the einsum."""
    calls = []
    real = layers.decode_attention
    monkeypatch.setattr(layers, "decode_attn_supports", da.fits)
    monkeypatch.setattr(layers, "decode_attention", lambda *a, **k: calls.append(a[0].shape[1]) or real(*a, **k))
    tc.test_prefill_and_cached_step_match_jax(name, None)
    cfg = tc.PRESETS[name]
    head_dim = cfg.head_dim or cfg.d_model // cfg.n_heads
    assert calls == ([1] * cfg.n_layers if head_dim in da.HEAD_DIMS else [])


PLANS = [(32, 24, 24, 1, 1024), (32, 24, 24, 9, 1024), (1, 24, 24, 1, 1024), (1, 24, 24, 1, 300),
         (8, 32, 8, 9, 1024), (4, 8, 2, 16, 8192), (2, 16, 1, 16, 1000), (1, 6, 6, 1, 1)]


@pytest.mark.parametrize("b,h,kv_h,tq,n_keys", PLANS)
def test_plan_covers_every_key_and_row_once(b, h, kv_h, tq, n_keys):
    p = da.plan(b, h, kv_h, tq, n_keys, 132)
    tiles = -(-n_keys // da.TILE)
    assert p.splits * p.per >= tiles and (p.splits - 1) * p.per < tiles  # every split holds a tile
    rows = h // kv_h * tq
    assert p.row_blocks * p.block_rows >= rows and (p.row_blocks - 1) * p.block_rows < rows
    assert 1 <= p.block_rows <= da.MAX_ROWS
    assert 4 * p.block_rows * p.per * da.TILE <= da.LOGIT_BYTES  # a block's logits fit its shared memory


def test_plan_of_the_cells_and_a_single_row():
    # 32 slots x 24 heads fill the card without a split; a B 1 /qa step splits its keys
    assert da.plan(32, 24, 24, 1, 1024, 132) == da.Plan(1, 16, 1, 1)
    assert da.plan(32, 24, 24, 9, 1024, 132) == da.Plan(1, 16, 1, 9)
    assert da.plan(1, 24, 24, 1, 1024, 132) == da.Plan(8, 2, 1, 1)
    assert da.plan(8, 32, 8, 9, 1024, 132) == da.Plan(2, 8, 3, 12)


def test_counters_keep_totals_and_the_latest_session():
    before = tracing.totals().get("test.k9", 0)
    tracing.count("test.k9")
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("test.k9", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("test.k9", 3)
        assert tracing.counts()["test.k9"] == 3
    tracing.count("test.k9")  # no session runs: the total alone
    assert tracing.counts()["test.k9"] == 3
    assert tracing.totals()["test.k9"] == before + 7
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert "test.k9" not in tracing.counts()  # a newer session counted nothing


@pytest.mark.parametrize("name", ["decode_attn.kernel_share.gen_closed", "decode_attn.kernel_share.gen_poisson"])
def test_kernel_share_readers(name, monkeypatch):
    read = spec.load_module("metrics", name).read
    rec = {"trace": {"tally": [("decode_attention", [32]), ("w8_matmul", [8])] * 9 + [("decode_attention", [1])]}}
    monkeypatch.setattr(tracing, "counts", lambda: {layers.CACHED_EINSUM: 30})
    assert read(rec) == pytest.approx(100.0 * 10 / 40)
    assert read({"trace": None}) is None  # no traced window
    monkeypatch.setattr(tracing, "counts", lambda: {})
    assert read({"trace": {"tally": []}}) is None  # no cached attention in the window
    monkeypatch.delattr(tracing, "counts")  # a program without the counters
    assert read(rec) is None
