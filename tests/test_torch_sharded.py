"""The port's sharded store and IVF index on S CPU shards against the JAX
package on its virtual CPU mesh, from the same numpy seeds: adds of uneven
sizes (the tail), exact and re-ranked queries with ids equal position for
position (a tie-heavy corpus: cross-shard ties go to the lower shard;
shards shorter than k), index files both ways and across shard counts, the
IVF layout for JAX's centroids and its queries at S = 4, streaming adds,
the CLI (``ingest --shards``, ``build-ivf --shards``) and /ingest over a
sharded store.

The JAX side queries in ``mode="exact"`` (its fast int8 selections are
lossy by design); the port's kernels are exact in every mode."""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from test_torch_ivf import BUILD, DTYPES, K, N, assert_same_topk, corpus  # noqa: F401  (fixture)
from vietnamese_qa_system_tpu.core.mesh import SHARD_AXIS, create_mesh as jcreate_mesh
from vietnamese_qa_system_tpu.engine import ivf as jivf
from vietnamese_qa_system_tpu.engine.store import VectorStore as JStore
from vietnamese_qa_system_tpu_torch.cli import main as cli
from vietnamese_qa_system_tpu_torch.core.mesh import create_mesh
from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
from vietnamese_qa_system_tpu_torch.engine import (DocStore, IngestPipeline, IVFIndex, Retriever, ServingApp,
                                                   VectorStore, load_index, make_server)
from vietnamese_qa_system_tpu_torch.engine import ivf as tivf
from vietnamese_qa_system_tpu_torch.models import ModelConfig, encoder_from_jax

torch.set_num_threads(2)

D = 64
SCORE_TOL = 1e-5  # f32 sums of the same products in another order


def _jmesh(s):
    return jcreate_mesh({SHARD_AXIS: s}, devices=jax.devices()[:s])


def _mesh(s):
    return create_mesh({SHARD_AXIS: s}, devices=["cpu"] * s)


def _stores(s, dtype, cap=512):
    return (JStore(cap, D, mesh=_jmesh(s), dtype=dtype, tile_n=128),
            VectorStore(cap, D, dtype=dtype, tile_n=128, device="cpu", mesh=_mesh(s)))


def _vectors(n, seed, distinct=None):
    """Unit rows; with ``distinct`` only that many rows, tiled (every
    score ties with the copies' on other shards)."""
    v = np.random.default_rng(seed).standard_normal((distinct or n, D)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return np.tile(v, (-(-n // len(v)), 1))[:n]


def _queries(vecs, seed, b=6):
    rng = np.random.default_rng(seed)
    return (vecs[rng.choice(len(vecs), b, replace=False)] + 0.05 * rng.standard_normal((b, D))).astype(np.float32)


def _add(stores, vecs, cuts):
    for lo, hi in zip((0,) + cuts, cuts + (len(vecs),)):
        for st in stores:
            st.add(vecs[lo:hi])


def _assert_same(port, jstore, q, k, rerank):
    ps, pi = port.topk(q, k, rerank=rerank)
    js, ji = jstore.topk(q, k, mode="exact", rerank=rerank)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=SCORE_TOL)
    return pi.numpy(), ps.numpy()


# ------------------------------------------------------------------ store


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 2, 4])
def test_store_matches_jax(s, dtype):
    """Adds of 7, 13 and 25 rows (each leaves a tail at S 2 and 4): the
    slabs, the tail, exact and re-ranked ids and get_vectors equal JAX's."""
    jstore, port = _stores(s, dtype)
    vecs = _vectors(45, s)
    _add((jstore, port), vecs, (7, 20))
    assert port.size == jstore.size == 45 and port.n_shards == s
    np.testing.assert_array_equal(port._tail.numpy(), jstore._tail)
    used = -(-45 // s)
    for sh, slab in enumerate(port.slabs):
        np.testing.assert_array_equal(slab.vectors[:used].float().numpy(),
                                      np.asarray(jstore.vectors[sh, :used], np.float32))
    assert port.global_scale == jstore.global_scale
    q = _queries(vecs, 1)
    for rerank in (None, 0, 12):
        _assert_same(port, jstore, q, 5, rerank)
    ids = np.arange(45)
    np.testing.assert_allclose(port.get_vectors(ids), jstore.get_vectors(ids), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tie_heavy_corpus_breaks_ties_by_shard(dtype):
    """Nine distinct rows tiled to 40 at S 4: every score ties with copies
    on other shards, and the merge orders them as ``lax.top_k`` over the
    all-gather does -- the lower shard first, which is not always the
    lower id."""
    jstore, port = _stores(4, dtype)
    vecs = _vectors(40, 3, distinct=9)
    _add((jstore, port), vecs, (11,))
    q = _queries(vecs[:9], 4, b=9)
    ids, scores = _assert_same(port, jstore, q, 8, None)
    later_id_first = (scores[:, 1:] == scores[:, :-1]) & (ids[:, 1:] < ids[:, :-1])
    assert later_id_first.any()  # shard order, not id order, broke a tie


@pytest.mark.parametrize("dtype", DTYPES)
def test_shards_shorter_than_k_match_jax(dtype):
    """13 rows over 4 shards (4, 3, 3, 3 rows), k 5 and a re-rank of 12:
    every shard is shorter than k, and an empty-shard store answers too."""
    jstore, port = _stores(4, dtype)
    vecs = _vectors(13, 5)
    _add((jstore, port), vecs, (6,))
    q = _queries(vecs, 6)
    for rerank in (None, 12):
        _assert_same(port, jstore, q, 5, rerank)
    # 3 rows over 4 shards: shard 3 holds none and launches nothing
    small = VectorStore(128, D, dtype=dtype, tile_n=128, device="cpu", mesh=_mesh(4))
    small.add(vecs[:3])
    _, ids = small.topk(q, 3, rerank=0)
    assert sorted(ids[0].tolist()) == [0, 1, 2]
    with pytest.raises(ValueError, match="< k"):
        small.topk(q, 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s_save,s_load", [(2, 2), (4, 4), (4, 2), (2, 1), (1, 4)])
def test_index_files_across_packages_and_shards(dtype, s_save, s_load, tmp_path):
    """Both packages write the same files at one S; each loads the other's
    at another S (re-added in id order) and answers as JAX does."""
    jstore, port = _stores(s_save, dtype)
    vecs = _vectors(37, 8)
    _add((jstore, port), vecs, (10, 21))
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    port.save(pdir)
    jstore.save(jdir)
    assert json.load(open(os.path.join(pdir, "meta.json"))) == json.load(open(os.path.join(jdir, "meta.json")))
    for name in sorted(os.listdir(jdir)):
        if name.endswith(".npy"):
            a, b = np.load(os.path.join(pdir, name)), np.load(os.path.join(jdir, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    q = _queries(vecs, 9)
    want = JStore.load(jdir, mesh=_jmesh(s_load)).topk(q, 5, mode="exact")
    for got in (VectorStore.load(jdir, device="cpu", mesh=_mesh(s_load)).topk(q, 5),
                VectorStore.load(pdir, device="cpu", mesh=_mesh(s_load)).topk(q, 5)):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    back = JStore.load(pdir, mesh=_jmesh(s_load))
    np.testing.assert_array_equal(np.asarray(back.topk(q, 5, mode="exact")[1]), np.asarray(want[1]))
    again = VectorStore.load(pdir, device="cpu", mesh=_mesh(s_load))
    again.add(vecs[:5])  # a loaded tail is re-written by the next add
    assert again.size == 42
    np.testing.assert_allclose(again.get_vectors(range(37, 42)), again.get_vectors(range(5)), rtol=0, atol=0)


# -------------------------------------------------------------------- IVF

S_IVF = 4


@pytest.fixture(scope="module")
def sharded(corpus):  # noqa: F811
    """dtype -> (JAX store, JAX IVF, port store) at S = 4, built once."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            jstore = JStore(N, D, mesh=_jmesh(S_IVF), dtype=dtype)
            port = VectorStore(N, D, dtype=dtype, device="cpu", mesh=_mesh(S_IVF))
            for st in (jstore, port):
                st.add(corpus[0][:5000])
                st.add(corpus[0][5000:])
            cache[dtype] = jstore, jivf.IVFIndex.build(jstore, **BUILD), port
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_sharded_layout_for_jax_centroids(dtype, sharded):
    """The port's per-shard assignment and layout under JAX's centroids
    give JAX's bucket ids, spill ids and spill counts on every shard."""
    jstore, jidx, port = sharded(dtype)
    cents = torch.from_numpy(np.asarray(jidx.centroids))
    assign = [tivf.assign_rows(port, sh, cents) for sh in range(S_IVF)]
    cap = tivf._round_up(max(int(np.ceil(BUILD.get("cap_mult", 1.6) * max(N / (S_IVF * jidx.n_clusters), 1.0))),
                             8), 128)
    assert cap == jidx.cap
    lays = tivf.shard_layouts(assign, jidx.n_clusters, cap, 1024)
    assert lays[0]["spill_cap"] == jidx.spill_cap
    assert [lay["spill_count"] for lay in lays] == jidx._spill_counts.tolist()
    for sh, lay in enumerate(lays):
        gids = np.where(lay["gids"] >= 0, lay["gids"] * S_IVF + sh, -1)
        spill = np.where(lay["spill_gids"] >= 0, lay["spill_gids"] * S_IVF + sh, -1)
        np.testing.assert_array_equal(gids, np.asarray(jidx.bucket_gids[sh]).reshape(-1))
        np.testing.assert_array_equal(spill, np.asarray(jidx.spill_gids[sh]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_sharded_ivf_loads_and_queries_in_port(dtype, corpus, sharded, tmp_path):  # noqa: F811
    """JAX's 4-shard IVF directory loads onto four CPU shards and answers
    as JAX's index does (default nprobe and exact); a load on two shards
    raises."""
    _, q, _ = corpus
    _, jidx, _ = sharded(dtype)
    jidx.save(str(tmp_path))
    port = load_index(str(tmp_path), device="cpu", mesh=_mesh(S_IVF))
    assert isinstance(port, IVFIndex) and port.n_shards == S_IVF
    assert port.spill_counts.tolist() == jidx._spill_counts.tolist()
    for mode in ("fast", "exact"):
        assert_same_topk(port.topk(q, K, mode=mode), jidx.topk(q, K, mode=mode))
    with pytest.raises(ValueError, match="rebuild from the flat store"):
        IVFIndex.load(str(tmp_path), device="cpu", mesh=_mesh(2))
    ids = [0, 1, 2, 3, 4097, N - 1]
    np.testing.assert_array_equal(port.get_vectors(ids), jidx.get_vectors(ids))


@pytest.mark.parametrize("dtype", ["bf16", "int8_res"])
def test_port_sharded_ivf_build_loads_in_jax(dtype, corpus, sharded, tmp_path):  # noqa: F811
    """The port's 4-shard build: recall against the oracle, exact mode
    equal to the flat store, files JAX loads on its 4-device mesh and
    queries alike, and streaming adds spread over the emptiest shards as
    JAX's do."""
    pts, q, oracle = corpus
    jstore, jidx, port = sharded(dtype)
    pidx = IVFIndex.build(port, **BUILD)
    assert pidx.cap == jidx.cap and pidx.n_clusters == jidx.n_clusters
    got = pidx.topk(q, K)[1].numpy()
    assert np.mean([len(set(got[i]) & set(oracle[i])) / K for i in range(len(q))]) >= 0.9
    assert_same_topk(pidx.topk(q, K, mode="exact"), port.topk(q, K))
    pidx.save(str(tmp_path))
    back = jivf.load_index(str(tmp_path), mesh=_jmesh(S_IVF))
    assert_same_topk(pidx.topk(q, K), back.topk(q, K))
    extra = pts[:40] + 0.001
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    np.testing.assert_array_equal(pidx.add(extra), back.add(extra))
    assert pidx.spill_counts.tolist() == back._spill_counts.tolist()
    ids = list(range(N, N + 40, 7))
    np.testing.assert_array_equal(pidx.get_vectors(ids), back.get_vectors(ids))
    assert_same_topk(pidx.topk(extra[:6], 3), back.topk(extra[:6], 3))


# -------------------------------------------------------------- CLI / HTTP


def test_cli_ingest_and_build_ivf_over_shards(tmp_path, capsys):
    """``ingest --shards 2 --device cpu`` writes a 2-shard store (a second
    ingest appends through the tail); ``build-ivf --shards 2`` clusters
    it; ``serve`` loads the flat index onto one shard."""
    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": f"đoạn văn số {i} về chủ đề {i % 5}"}, ensure_ascii=False)
                              for i in range(11)), encoding="utf-8")
    idx, db, ivf = str(tmp_path / "idx"), str(tmp_path / "db.sqlite"), str(tmp_path / "ivf")
    ingest = ["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--capacity", "512",
              "--dtype", "int8_res", "--batch-size", "8", "--max-len", "32", "--shards", "2"]
    assert cli(ingest) == 0
    meta = json.load(open(os.path.join(idx, "meta.json")))
    assert meta["n_shards"] == 2 and meta["size"] == 11 and np.load(os.path.join(idx, "tail.npy")).shape == (1, 128)
    assert cli(ingest) == 0
    store = VectorStore.load(idx, device="cpu", mesh=_mesh(2))
    assert store.size == 22 and store._tail.shape[0] == 0
    np.testing.assert_allclose(store.get_vectors(range(11, 22)), store.get_vectors(range(11)), rtol=0, atol=0)
    assert cli(["build-ivf", "--index", idx, "--out", ivf, "--shards", "2", "--clusters", "4", "--kmeans-iters", "2",
                "--device", "cpu"]) == 0
    assert "clusters x cap 128 per shard" in capsys.readouterr().out
    built = load_index(ivf, device="cpu", mesh=_mesh(2))
    assert built.n_shards == 2 and built.size == 22 and sum(built.spill_counts) == 0
    one = load_index(idx, device="cpu", capacity=0)
    assert one.n_shards == 1 and one.size == 22


def test_ingest_and_search_over_http_on_a_sharded_store():
    """/ingest appends through the tail of a 3-shard store and /search
    finds every passage first for its own text (the hybrid dense side
    reads vectors by placement)."""
    from vietnamese_qa_system_tpu.models import encoder as je
    from vietnamese_qa_system_tpu.models import tiny_test

    cfg = tiny_test("encoder")
    encoder = encoder_from_jax(jax.tree.map(np.asarray, je.init_encoder(jax.random.key(0), cfg)),
                               ModelConfig.from_json(cfg.to_json()), device="cpu")
    tok = ByteTokenizer()
    store = VectorStore(256, cfg.d_model, tile_n=128, device="cpu", mesh=_mesh(3))
    docs = DocStore()
    pipe = IngestPipeline(encoder, tok, store, docs, batch_size=8, max_len=32)
    texts = [f"văn bản thứ {i} bàn về đề tài {i % 4}" for i in range(14)]
    pipe.add_texts(texts[:5])
    retr = Retriever(encoder, tok, store, docs, max_len=32, query_batch=8)
    app = ServingApp(retr, None, ingest=pipe, k=3, max_wait_s=0.01)
    httpd = make_server(app, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"

        def post(path, payload):
            req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())

        body = post("/ingest", {"texts": texts[5:], "sources": ["s"] * 9})
        assert body == {"ids": list(range(5, 14)), "index_size": 14}
        assert store._tail.shape[0] == 14 % 3  # the partial row, kept for the next add
        for i in (0, 6, 13):
            assert post("/search", {"query": texts[i], "k": 3})["results"][0]["id"] == i
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        th.join(timeout=10)
