"""The port's IVF slice against the JAX package on the CPU: the probe-score
kernel's plain version against the Pallas kernel (interpret mode) and its
XLA reference, IVF directories saved by either package queried in both,
the bucket layout for one assignment, the build's seeded draws, the CLI
(``build-ivf``, ``serve`` over an IVF index), and the /ingest refusal.

Sizes follow ``tests/test_ivf.py``: N 8192, D 64, 64 clusters, nprobe 12.
Every index is built once per module."""

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.core.mesh import SHARD_AXIS, create_mesh
from vietnamese_qa_system_tpu.engine import ivf as jivf
from vietnamese_qa_system_tpu.engine.store import VectorStore as JStore
from vietnamese_qa_system_tpu.ops import ivf_probe as jprobe
from vietnamese_qa_system_tpu_torch.cli import main as cli
from vietnamese_qa_system_tpu_torch.engine import (DocStore, IngestPipeline, IVFIndex, Retriever, ServingApp,
                                                   VectorStore, ivf_crossover_batch, load_index, make_server,
                                                   select_serving_index)
from vietnamese_qa_system_tpu_torch.engine import ivf as tivf
from vietnamese_qa_system_tpu_torch.ops import ivf_probe as tprobe

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, K = 8192, 64, 10
BUILD = {"n_clusters": 64, "nprobe": 12, "kmeans_iters": 6, "sample_n": 4096, "seed": 0}
DTYPES = ["bf16", "int8", "int8_global", "int8_res"]
# f32 sums of the same products in another order (|score| <= ~1): a few ulps
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(40, D))
    pts = centers[rng.integers(0, 40, N)] + 0.3 * rng.normal(size=(N, D))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    q = pts[rng.choice(N, 24, replace=False)] + 0.05 * rng.normal(size=(24, D))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    oracle = np.argsort(-(q @ pts.T), axis=1)[:, :K]
    return pts.astype(np.float32), q.astype(np.float32), oracle


@pytest.fixture(scope="module")
def jax_built(corpus):
    """dtype -> (JAX flat store, JAX IVF index), built on first use."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            store = JStore(N, D, mesh=create_mesh({SHARD_AXIS: 1}), dtype=dtype)
            store.add(corpus[0])
            cache[dtype] = store, jivf.IVFIndex.build(store, **BUILD)
        return cache[dtype]

    return get


@pytest.fixture(scope="module")
def port_built(corpus):
    """dtype -> (port flat store, port IVF index) on the CPU."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            store = VectorStore(N, D, dtype=dtype, device="cpu")
            store.add(corpus[0])
            cache[dtype] = store, IVFIndex.build(store, **BUILD)
        return cache[dtype]

    return get


def _recall(ids, oracle):
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[i]) & set(oracle[i])) / oracle.shape[1] for i in range(len(oracle))]))


def assert_same_topk(got, want, tol=SCORE_TOL):
    """Equal top-k up to near-ties: scores within ``tol`` position by
    position, and an id in one list only scores within ``tol`` of the k-th
    score (it swapped with a near-tied row at the boundary)."""
    (gs, gi), (ws, wi) = ([np.asarray(a) for a in pair] for pair in (got, want))
    np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
    for r in range(len(gi)):
        for s, i, other in ((gs[r], gi[r], wi[r]), (ws[r], wi[r], gi[r])):
            alone = ~np.isin(i, other)
            assert np.all(s[alone] <= s[-1] + tol), (r, i, other, s)


# ------------------------------------------------------------ probe scores


@pytest.mark.parametrize("kind", ["int8", "bf16", "int8_global"])
def test_probe_scores_plain_matches_jax(kind):
    """K5's plain version (and the CPU route of its wrapper) against the
    Pallas kernel in interpret mode and its XLA reference: P = 5, pad rows
    and an all-pad bucket; int8_global as int8 codes without scales, the
    global scale folded into the query in f32 before the bf16 rounding."""
    rng = np.random.default_rng(3)
    c, cap, d, b, p = 12, 128, 256, 4, 5
    if kind == "bf16":
        buckets = jnp.asarray(rng.standard_normal((c, cap, d)), jnp.bfloat16)
    else:
        buckets = jnp.asarray(rng.integers(-127, 128, (c, cap, d)), jnp.int8)
    scales = jnp.asarray(rng.random((c, cap)) + 0.1, jnp.float32) if kind == "int8" else None
    gids = jnp.asarray(rng.integers(0, 10000, (c, cap)), jnp.int32).at[:, cap - 7:].set(-1).at[2].set(-1)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if kind == "int8_global":
        q = q * np.float32(0.0123)
    ids = jnp.asarray(rng.integers(0, c, (b, p)), jnp.int32).at[0, 0].set(2)

    want_s, want_g = jprobe.ivf_probe_scores(jnp.asarray(q), ids, buckets, scales, gids)
    ref_s, _ = jprobe.ivf_probe_scores_reference(jnp.asarray(q), ids, buckets, scales, gids)
    tb = torch.from_numpy(np.asarray(buckets, np.float32)).to(torch.bfloat16 if kind == "bf16" else torch.int8)
    args = (torch.from_numpy(q), torch.from_numpy(np.asarray(ids)), tb,
            None if scales is None else torch.from_numpy(np.asarray(scales)), torch.from_numpy(np.asarray(gids)))
    for got_s, got_g in (tprobe.ivf_probe_scores_plain(*args), tprobe.ivf_probe_scores(*args)):
        assert got_s.shape == (b, p, cap) and got_s.dtype == torch.float32 and got_g.dtype == torch.int32
        np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
        for want in (np.asarray(want_s), np.asarray(ref_s)):
            np.testing.assert_array_equal(np.isneginf(got_s.numpy()), np.isneginf(want))
            finite = np.isfinite(want)
            # exact products; f32 sums over 256 terms in another order
            np.testing.assert_allclose(got_s.numpy()[finite], want[finite], rtol=0,
                                       atol=1e-5 * np.abs(want[finite]).max())
        assert np.all(np.isneginf(got_s[0, 0].numpy()))


# ------------------------------------------------------------ index files


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_saved_ivf_queries_match_port(dtype, corpus, jax_built, tmp_path):
    _, q, _ = corpus
    _, jidx = jax_built(dtype)
    jidx.save(str(tmp_path))
    port = load_index(str(tmp_path), device="cpu")
    assert isinstance(port, IVFIndex) and port.dtype == dtype and port.size == N
    for kw in ({}, {"nprobe": 3}, {"mode": "exact", "rerank": 0}):
        assert_same_topk(port.topk(q, K, **kw), jidx.topk(q, K, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_saved_ivf_loads_in_jax(dtype, corpus, port_built, tmp_path):
    _, q, _ = corpus
    _, pidx = port_built(dtype)
    pidx.save(str(tmp_path))
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta["type"] == "ivf" and meta["n_shards"] == 1 and meta["spill_counts"] == [pidx.spill_count]
    assert np.load(tmp_path / "buckets.npy").shape == (1, pidx.n_clusters, pidx.cap, D)
    back = jivf.load_index(str(tmp_path))
    assert isinstance(back, jivf.IVFIndex)
    assert_same_topk(pidx.topk(q, K), back.topk(q, K))
    with pytest.raises(ValueError, match="load_index"):
        VectorStore.load(str(tmp_path), device="cpu")
    again = IVFIndex.load(str(tmp_path), device="cpu")
    for name in tivf._SLABS:
        a, b = getattr(pidx.shards[0], name), getattr(again.shards[0], name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name


def test_multi_shard_ivf_is_refused(corpus, tmp_path):
    store = JStore(N, D, mesh=create_mesh({SHARD_AXIS: 2}), dtype="bf16")
    store.add(corpus[0][:2048])
    jivf.IVFIndex.build(store, n_clusters=16, kmeans_iters=1, sample_n=1024).save(str(tmp_path))
    with pytest.raises(ValueError, match="rebuild from the flat store"):
        load_index(str(tmp_path), device="cpu")


# ------------------------------------------------------------------ build


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_layout_matches_jax_for_same_assignment(dtype, jax_built):
    """The host bucket layout from the JAX package's own assignment."""
    jstore, jidx = jax_built(dtype)
    s, capps, d = jstore.vectors.shape
    scales = jstore.scales.reshape(s * capps) if dtype == "int8" else None
    assign = np.asarray(jivf._assign_chunks(jstore.vectors.reshape(s * capps, d), scales, jstore.global_scale,
                                            jidx.centroids, chunk=4096))
    lay = tivf.bucket_layout(assign[:N], jidx.n_clusters, jidx.cap, spill_headroom=1024)
    np.testing.assert_array_equal(lay["gids"], np.asarray(jidx.bucket_gids[0]).reshape(-1))
    np.testing.assert_array_equal(lay["spill_gids"], np.asarray(jidx.spill_gids[0]))
    assert [lay["spill_count"]] == jidx._spill_counts.tolist() and lay["spill_cap"] == jidx.spill_cap
    assert lay["spill_count"] > 0  # the layout's spill branch is exercised


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int8_global"])
def test_build_draws_match_jax(dtype, corpus):
    """Same seed: the same k-means sample and initial centroids (zero
    Lloyd iterations leave them as drawn), bit for bit."""
    jstore = JStore(N, D, mesh=create_mesh({SHARD_AXIS: 1}), dtype=dtype)
    jstore.add(corpus[0])
    pstore = VectorStore(N, D, dtype=dtype, device="cpu")
    pstore.add(corpus[0])
    kw = dict(BUILD, kmeans_iters=0, seed=5)
    want = np.asarray(jivf.IVFIndex.build(jstore, **kw).centroids)
    np.testing.assert_array_equal(IVFIndex.build(pstore, **kw).centroids.numpy(), want)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int8_global"])
def test_port_build_recall(dtype, corpus, port_built):
    """Recall of a port build at the JAX test's floors (test_ivf.py:54)."""
    _, q, oracle = corpus
    _, pidx = port_built(dtype)
    assert _recall(pidx.topk(q, K)[1], oracle) >= {"bf16": 0.95, "int8": 0.92, "int8_global": 0.80}[dtype]


def test_build_repeats_and_int8_res_rerank(corpus, port_built):
    pts, q, oracle = corpus
    store, pidx = port_built("int8_res")
    again = IVFIndex.build(store, **BUILD)
    assert torch.equal(again.centroids, pidx.centroids) and torch.equal(again.shards[0].bucket_gids, pidx.shards[0].bucket_gids)
    scores, ids = pidx.topk(q, K, mode="exact")  # auto rerank 4 * k: residual-precision scores
    np.testing.assert_allclose(scores.numpy(), np.take_along_axis(q @ pts.T, ids.numpy().astype(np.int64), 1),
                               atol=2e-3)
    assert _recall(ids, oracle) >= 0.95
    off, _ = pidx.topk(q, K, mode="exact", rerank=0)
    assert not np.allclose(off.numpy(), scores.numpy(), atol=1e-5)


def test_exact_mode_equals_flat_store(corpus, port_built):
    """mode="exact" probes every cluster: the flat store's (K1 plain)
    top-k by the rank-count rule over the bf16 scores."""
    _, q, _ = corpus
    store, pidx = port_built("bf16")
    bq = torch.from_numpy(q).to(torch.bfloat16).float()
    full = bq @ store.slabs[0].vectors[:N].float().T
    for _, ids in (pidx.topk(q, K, mode="exact"), store.topk(q, K)):
        picked = torch.gather(full, 1, ids.long())
        higher = (full[:, None, :] > picked[:, :, None] + 1e-6).sum(-1)
        assert bool((higher < K).all())


# ----------------------------------------------------- add, get, guards


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_goes_to_spill_like_jax(dtype, corpus, tmp_path):
    """Adds land in the spill region with the JAX package's codes and are
    searchable at once."""
    pts, _, _ = corpus
    jstore = JStore(N, D, mesh=create_mesh({SHARD_AXIS: 1}), dtype=dtype)
    jstore.add(pts)
    jidx = jivf.IVFIndex.build(jstore, n_clusters=64, nprobe=4, kmeans_iters=2, sample_n=2048)
    jidx.save(str(tmp_path))
    port = IVFIndex.load(str(tmp_path), device="cpu")
    extra = pts[:6] + 0.001
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    base = port.spill_count
    np.testing.assert_array_equal(port.add(extra), jidx.add(extra))
    assert port.size == N + 6 and port.spill_count == base + 6
    rows = slice(base, base + 6)
    for name in ("spill_vecs", "spill_scales", "res_spill_vecs", "spill_gids"):
        if getattr(port.shards[0], name) is not None:
            np.testing.assert_array_equal(getattr(port.shards[0], name)[rows].float().numpy(),
                                          np.asarray(getattr(jidx, name)[0, rows], np.float32))
    _, got = port.topk(extra, 2)
    for i, row in enumerate(got.numpy()):
        assert N + i in row or i in row
    ids = [0, 17, N - 1, N, N + 5]
    np.testing.assert_array_equal(port.get_vectors(ids), jidx.get_vectors(ids))


def test_guards(corpus, port_built):
    pts, q, _ = corpus
    _, pidx = port_built("bf16")
    with pytest.raises(ValueError, match="exceeds probed rows|< k"):
        pidx.topk(q, pidx.n_clusters * pidx.cap + pidx.spill_cap + 1, mode="exact")
    with pytest.raises(ValueError, match="rerank"):
        pidx.topk(q, K, rerank=5)
    with pytest.raises(ValueError, match="expected"):
        pidx.add(np.zeros((2, D + 1), np.float32))
    with pytest.raises(ValueError, match="empty"):
        IVFIndex.build(VectorStore(1024, D, device="cpu"))
    small = VectorStore(1024, D, device="cpu")
    small.add(pts[:64])
    tiny = IVFIndex.build(small, n_clusters=8, kmeans_iters=1, sample_n=64, spill_headroom=0)
    with pytest.raises(ValueError, match="< k"):
        tiny.topk(q, 65)
    with pytest.raises(ValueError, match="spill region full"):
        tiny.add(np.zeros((tiny.spill_cap - tiny.spill_count + 1, D), np.float32))
    scores, ids = tiny.topk(q[:2], 20, nprobe=1)  # fewer probed rows than k: the tail is id -1, score 0
    tail = ids.numpy() < 0
    assert tail.any() and np.all(scores.numpy()[tail] == 0.0)
    assert tiny.spill_cap == 0  # an empty spill region, reranked
    np.testing.assert_array_equal(tiny.topk(pts[:3], 2, rerank=8)[1][:, 0].numpy(), [0, 1, 2])


def test_crossover_and_select_match_jax(jax_built, tmp_path):
    jstore, jidx = jax_built("bf16")
    jidx.save(str(tmp_path))
    port = IVFIndex.load(str(tmp_path), device="cpu")
    flat = object()
    for kappa in (1, 2, 10):
        cross = ivf_crossover_batch(port, kappa=kappa)
        assert cross == jivf.ivf_crossover_batch(jidx, kappa=kappa)
        for batch in (1, cross, cross + 1):
            got, got_cross = select_serving_index(flat, port, batch, kappa=kappa)
            want, want_cross = jivf.select_serving_index(jstore, jidx, batch, kappa=kappa)
            assert got_cross == want_cross and (got is port) == (want is jidx)


# -------------------------------------------------------------- serving


def _cli_env(tmp_path, n_docs=24):
    docs = tmp_path / "docs.jsonl"
    texts = [f"đoạn văn số {i} nói về chủ đề {i % 7} của Việt Nam" for i in range(n_docs)]
    docs.write_text("\n".join(json.dumps({"doc": t}, ensure_ascii=False) for t in texts), encoding="utf-8")
    idx, db, ivf = str(tmp_path / "idx"), str(tmp_path / "db.sqlite"), str(tmp_path / "ivf")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--dtype", "int8_res",
                "--capacity", "1024", "--batch-size", "8", "--max-len", "32"]) == 0
    return texts, idx, db, ivf


def _feed(monkeypatch, lines):
    it = iter(lines)

    def fake_input(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", fake_input)


def test_cli_build_ivf_and_serve(tmp_path, monkeypatch, capsys):
    texts, idx, db, ivf = _cli_env(tmp_path)
    assert cli(["build-ivf", "--index", idx, "--out", ivf, "--clusters", "8", "--kmeans-iters", "2",
                "--device", "cpu"]) == 0
    assert "IVF index saved" in capsys.readouterr().out
    built = load_index(ivf, device="cpu")
    assert isinstance(built, IVFIndex) and built.size == len(texts) and built.dtype == "int8_res"
    serve = ["serve", "--db", db, "--device", "cpu", "--max-len", "32", "--hybrid-weight", "1.0"]
    _feed(monkeypatch, [texts[5], ""])
    assert cli(serve + ["--index", ivf]) == 0
    out = capsys.readouterr().out
    assert "WARNING: IVF index with query batch 256" in out and "  1. [5] score=" in out  # its own passage first
    # 24 rows over 8 clusters x cap 128: the crossover is batch 1, so auto picks the flat scan at 256
    for select, kind in (("auto", "flat"), ("flat", "flat"), ("ivf", "ivf")):
        _feed(monkeypatch, [texts[3], ""])
        assert cli(serve + ["--index", idx, "--ivf-index", ivf, "--index-select", select]) == 0
        out = capsys.readouterr().out
        assert f"index-select: {kind} (query batch 256" in out and "  1. [3] score=" in out
    with pytest.raises(SystemExit):
        cli(serve + ["--index", ivf, "--ivf-index", ivf])
    # --shards 2 builds over two CPU shards; serve (one shard) refuses that index, as the JAX CLI does
    ivf2 = ivf + "_2"
    assert cli(["build-ivf", "--index", idx, "--out", ivf2, "--shards", "2", "--clusters", "8", "--kmeans-iters", "2",
                "--device", "cpu"]) == 0
    assert json.load(open(os.path.join(ivf2, "meta.json")))["n_shards"] == 2
    with pytest.raises(ValueError, match="rebuild from the flat store"):
        cli(serve + ["--index", ivf2])


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_ingest_against_ivf_is_refused_and_flat_dir_kept(tmp_path):
    """``serve --ivf-index ... --index-select ivf --port``: /search answers
    through the IVF index, /ingest answers 400 naming the cause and adds
    nothing, and the shutdown leaves the flat --index directory as it was."""
    texts, idx, db, ivf = _cli_env(tmp_path)
    assert cli(["build-ivf", "--index", idx, "--out", ivf, "--clusters", "8", "--kmeans-iters", "2",
                "--device", "cpu"]) == 0
    before = {name: open(os.path.join(idx, name), "rb").read() for name in sorted(os.listdir(idx))}
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "vietnamese_qa_system_tpu_torch.cli", "serve", "--index", idx, "--ivf-index", ivf,
         "--index-select", "ivf", "--db", db, "--device", "cpu", "--max-len", "32", "--hybrid-weight", "1.0",
         "--port", "0", "--max-batch", "4"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        url = lines[-1].split(" on ")[1].split(" ")[0]
        assert "index-select: ivf" in "".join(lines)
        status, body = _post(f"{url}/search", {"query": texts[4], "k": 3})
        assert status == 200 and body["results"][0]["id"] == 4
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{url}/ingest", {"texts": ["bài mới"]})
        assert err.value.code == 400 and "IVFIndex" in json.loads(err.value.read())["error"]
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["index_size"] == len(texts)
    finally:
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0 and "index persisted" not in rest
    assert {name: open(os.path.join(idx, name), "rb").read() for name in sorted(os.listdir(idx))} == before
    assert DocStore(db).count() == len(texts)


def test_retriever_and_app_over_port_ivf(corpus, port_built):
    """The Retriever and ServingApp take an IVF index like a store;
    ingest through it raises before anything is written."""
    from vietnamese_qa_system_tpu.models import encoder as je
    from vietnamese_qa_system_tpu.models import tiny_test
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.models import ModelConfig, encoder_from_jax

    cfg = tiny_test("encoder")
    enc = encoder_from_jax(jax.tree.map(np.asarray, je.init_encoder(jax.random.key(0), cfg)),
                           ModelConfig.from_json(cfg.to_json()), device="cpu")
    tok = ByteTokenizer()
    texts = [f"đoạn văn số {i} nói về chủ đề {i % 7}" for i in range(64)]
    store, docs = VectorStore(256, enc.cfg.d_model, device="cpu"), DocStore()
    pipe = IngestPipeline(enc, tok, store, docs, batch_size=32, max_len=32)
    pipe.add_texts(texts)
    ivf = IVFIndex.build(store, n_clusters=8, nprobe=8, kmeans_iters=3, sample_n=256)
    rows = Retriever(enc, tok, ivf, docs, max_len=32, query_batch=8).search([texts[3], texts[40]], k=3)
    assert [r[0].id for r in rows] == [3, 40] and rows[0][0].doc == texts[3]
    ivf_pipe = IngestPipeline(enc, tok, ivf, docs, batch_size=8, max_len=32)
    with pytest.raises(ValueError, match="IVFIndex"):
        ivf_pipe.add_texts(["bài mới"])
    assert ivf.size == 64 and docs.count() == 64
    app = ServingApp(Retriever(enc, tok, ivf, docs, max_len=32, query_batch=4), ingest=ivf_pipe, k=2, max_batch=4)
    httpd = make_server(app, "127.0.0.1", 0)
    import threading

    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert _post(f"{url}/search", {"query": texts[9]})[1]["results"][0]["id"] == 9
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{url}/ingest", {"texts": ["x"]})
        assert err.value.code == 400 and not app.dirty
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        th.join(timeout=10)
