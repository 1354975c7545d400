"""The port's retrieval engine against the JAX package: ingest -> query
parity, HTTP serving, index files that load in either package, the
tokenizer copy, and a run of the port with jax made unimportable."""

import json
import os
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.core.mesh import SHARD_AXIS, create_mesh
from vietnamese_qa_system_tpu.data import tokenizer as jtok
from vietnamese_qa_system_tpu.engine import DocStore as JDocStore
from vietnamese_qa_system_tpu.engine import IngestPipeline as JIngest
from vietnamese_qa_system_tpu.engine import Retriever as JRetriever
from vietnamese_qa_system_tpu.engine import VectorStore as JStore
from vietnamese_qa_system_tpu.engine.chunking import chunk_text as jchunk
from vietnamese_qa_system_tpu.models import encoder as je
from vietnamese_qa_system_tpu.models import tiny_test
from vietnamese_qa_system_tpu_torch.cli import main as cli
from vietnamese_qa_system_tpu_torch.data import tokenizer as ttok
from vietnamese_qa_system_tpu_torch.engine import (DocStore, IngestPipeline, Retriever, SearchResult, ServingApp,
                                                   VectorStore, chunk_text, dual_agreement, make_server)
from vietnamese_qa_system_tpu_torch.models import ModelConfig, encoder_from_jax
from vietnamese_qa_system_tpu_torch.ops.topk import MAX_K

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSAGES = [f"đoạn văn số {i} nói về chủ đề {i % 7}" for i in range(40)]


@pytest.fixture(scope="module")
def encoders():
    cfg = tiny_test("encoder")
    params = je.init_encoder(jax.random.key(0), cfg)
    port = encoder_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_json(cfg.to_json()), device="cpu")
    return params, cfg, port


def _port_pipeline(port, **store_kw):
    store = VectorStore(1024, port.cfg.d_model, tile_n=128, device="cpu", **store_kw)
    docstore = DocStore()
    pipe = IngestPipeline(port, ttok.ByteTokenizer(), store, docstore, batch_size=16, max_len=32)
    return store, docstore, pipe


def test_e2e_ingest_query_matches_jax(encoders):
    params, cfg, port = encoders
    store, docstore, pipe = _port_pipeline(port)
    ids = pipe.add_texts(PASSAGES)
    assert ids.tolist() == list(range(40)) and store.size == 40 and docstore.count() == 40
    retr = Retriever(port, ttok.ByteTokenizer(), store, docstore, max_len=32, query_batch=16)
    rows = retr.search(PASSAGES[:10], k=3)

    jstore = JStore(1024, cfg.d_model, tile_n=128)
    jdocs = JDocStore()
    JIngest(params, cfg, jtok.ByteTokenizer(), jstore, jdocs, batch_size=16, max_len=32).add_texts(PASSAGES)
    jrows = JRetriever(params, cfg, jtok.ByteTokenizer(), jstore, jdocs, max_len=32, query_batch=16).search(
        PASSAGES[:10], k=3)
    for i, (row, jrow) in enumerate(zip(rows, jrows)):
        assert row[0].id == jrow[0].id == i
        assert row[0].doc == jrow[0].doc == PASSAGES[i]
        assert abs(row[0].score - jrow[0].score) < 1e-3
    assert rows[0][0].score > 0.99


def test_search_shorter_rows_and_k_limit(encoders):
    _, _, port = encoders
    store, docstore, pipe = _port_pipeline(port)
    retr = Retriever(port, ttok.ByteTokenizer(), store, docstore, max_len=32, query_batch=4)
    assert retr.search(["trống"], k=3) == [[]]
    pipe.add_texts(PASSAGES[:2])
    assert len(retr.search(["đoạn văn"], k=5)[0]) == 2
    pipe.add_texts([f"tài liệu {i}" for i in range(300)])
    rows = retr.search(["tài liệu 7"], k=200, fetch_docs=False)
    assert len({r.id for r in rows[0]}) == 200
    with pytest.raises(ValueError):
        retr.search(["tài liệu 7"], k=MAX_K + 1)


def test_dual_agreement():
    a = [[SearchResult(1, 0.3, "d")], [SearchResult(2, 0.1)], []]
    b = [[SearchResult(1, 0.2, "d")], [SearchResult(3, 0.9)], [SearchResult(4, 0.9)]]
    out = dual_agreement(a, b, threshold=0.4)
    assert out[0].id == 1 and abs(out[0].score - 0.5) < 1e-9
    assert out[1] is None and out[2] is None


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_search_and_ingest_roundtrip(encoders):
    import threading

    _, _, port = encoders
    store, docstore, pipe = _port_pipeline(port)
    pipe.add_texts(PASSAGES)
    retr = Retriever(port, ttok.ByteTokenizer(), store, docstore, max_len=32, query_batch=8)
    app = ServingApp(retr, ingest=pipe, k=3, max_batch=8)
    httpd = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, body = _post(f"{url}/search", {"query": PASSAGES[5], "k": 2})
        assert status == 200 and len(body["results"]) == 2
        assert body["results"][0]["id"] == 5 and body["results"][0]["doc"] == PASSAGES[5]
        status, body = _post(f"{url}/ingest", {"texts": ["bài mới"], "sources": ["s"]})
        assert body == {"ids": [40], "index_size": 41} and app.dirty
        status, body = _post(f"{url}/search", {"query": "bài mới"})
        assert body["results"][0]["id"] == 40 and body["results"][0]["source"] == "s"
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["index_size"] == 41 and health["stats"]["search"]["requests"] == 2
        for path, payload in (("/search", {"query": ""}), ("/search", {"query": "x", "k": 99}),
                              ("/ingest", {"texts": "x"}), ("/qa", {"question": "x"})):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url + path, payload)
            assert err.value.code == 400  # /qa: no reader configured
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        th.join(timeout=10)
    assert not th.is_alive()
    with pytest.raises(ValueError, match="kernel limit"):
        ServingApp(retr, k=MAX_K + 1)


# ------------------------------------------------------------ index files

DTYPES = ["bf16", "int8", "int8_global", "int8_res"]


def _vectors(n, d, seed):
    v = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _queries(vecs, seed):
    noise = np.random.default_rng(seed).standard_normal((6, vecs.shape[1])).astype(np.float32)
    return vecs[[0, 3, 7, 20, 35, 36]] + 0.05 * noise


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_index_with_tail_loads_in_port(dtype, tmp_path):
    vecs = _vectors(37, 64, 0)
    mesh = create_mesh({SHARD_AXIS: 2}, devices=jax.devices()[:2])
    jstore = JStore(512, 64, mesh=mesh, dtype=dtype, tile_n=128)
    jstore.add(vecs[:20])
    jstore.add(vecs[20:])  # 37 rows over 2 shards leave a host tail
    assert len(jstore._tail) == 1
    jstore.save(str(tmp_path))
    port = VectorStore.load(str(tmp_path), device="cpu")
    assert port.size == 37 and port.dtype == dtype
    q = _queries(vecs, 1)
    _, jids = jstore.topk(q, 5, mode="exact")
    _, tids = port.topk(q, 5)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(port.get_vectors(range(37)), jstore.get_vectors(range(37)), atol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_index_loads_in_jax(dtype, tmp_path):
    vecs = _vectors(37, 64, 2)
    port = VectorStore(512, 64, dtype=dtype, tile_n=128, device="cpu")
    port.add(vecs[:10])
    port.add(torch.from_numpy(vecs[10:]))
    port.save(str(tmp_path))
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta == {"capacity": 512, "dim": 64, "dtype": dtype, "size": 37, "n_shards": 1, "tile_n": 128,
                    "global_scale": port.global_scale}
    assert np.load(tmp_path / "vectors.npy").dtype == np.float32
    jstore = JStore.load(str(tmp_path))
    q = _queries(vecs, 3)
    _, jids = jstore.topk(q, 5, mode="exact")
    _, tids = port.topk(q, 5)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    again = VectorStore.load(str(tmp_path), capacity=0, device="cpu")
    assert again.capacity == 128 and torch.equal(again.slabs[0].vectors[:37], port.slabs[0].vectors[:37])


@pytest.mark.parametrize("dtype", DTYPES)
def test_store_add_matches_jax_codes(dtype):
    vecs = _vectors(50, 32, 4)
    port = VectorStore(256, 32, dtype=dtype, tile_n=128, device="cpu")
    port.add(vecs)
    jstore = JStore(256, 32, dtype=dtype, tile_n=128)
    jstore.add(vecs)
    slab = port.slabs[0]
    np.testing.assert_array_equal(slab.vectors[:50].float().numpy(), np.asarray(jstore.vectors[0, :50], np.float32))
    if slab.scales is not None:
        np.testing.assert_array_equal(slab.scales[:50].numpy(), np.asarray(jstore.scales[0, :50]))
    if dtype == "int8_res":
        np.testing.assert_array_equal(slab.res_vectors[:50].numpy(), np.asarray(jstore.res_vectors[0, :50]))
    assert port.global_scale == jstore.global_scale


def test_store_guards_and_empty_roundtrip(tmp_path):
    store = VectorStore(100, 16, tile_n=128, dtype="int8_global", device="cpu")
    assert store.capacity == 128
    with pytest.raises(ValueError, match="< k"):
        store.topk(np.zeros((1, 16), np.float32), 3)
    with pytest.raises(ValueError, match="store full"):
        store.add(np.zeros((129, 16), np.float32))
    with pytest.raises(ValueError, match="expected"):
        store.add(np.zeros((3, 8), np.float32))
    store.save(str(tmp_path))
    assert VectorStore.load(str(tmp_path), device="cpu").size == 0
    res = VectorStore(256, 16, tile_n=128, dtype="int8_res", device="cpu")
    res.add(_vectors(20, 16, 5))
    with pytest.raises(ValueError, match="kernel limit"):
        res.topk(np.zeros((1, 16), np.float32), 5, rerank=MAX_K + 1)
    with pytest.raises(ValueError, match="must be >= k"):
        res.topk(np.zeros((1, 16), np.float32), 5, rerank=3)


# ------------------------------------------------- copies of host modules


def test_tokenizer_copy_gives_identical_ids():
    texts = ["Xin chào Việt Nam", "", "đường phố Hà Nội " * 20, "a\nb\tc", "Tiếng Việt có dấu: ắ ặ ỗ ữ"]
    jt, tt = jtok.ByteTokenizer(), ttok.ByteTokenizer()
    for text in texts:
        assert tt.encode(text, add_bos=True, add_eos=True) == jt.encode(text, add_bos=True, add_eos=True)
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    for kw in ({}, {"pad_side": "left"}, {"add_eos": True}):
        for got, want in zip(ttok.batch_encode(tt, texts, 24, **kw), jtok.batch_encode(jt, texts, 24, **kw)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_chunking_and_docstore_copies(tmp_path):
    doc = ("Câu một. Câu hai dài hơn một chút.\n\nĐoạn mới với nhiều từ " * 30).strip()
    for size in (64, 200, 512):
        assert chunk_text(doc, size) == jchunk(doc, size)
    ds = DocStore(str(tmp_path / "d.sqlite"))
    ds.insert([3, 1], ["ba", "một"], ["s3", None])
    assert ds.get([1, 2, 3]) == ["một", None, "ba"] and ds.count() == 2
    assert ds.get_rows([3]) == [(3, "ba", "s3")]
    ds.close()


# ------------------------------------------------------------------- CLI


def test_cli_ingest_and_refusals(tmp_path, monkeypatch, capsys):
    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": p}, ensure_ascii=False) for p in PASSAGES[:8]), encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu",
                          "--capacity", "1024", "--dtype", "int8", "--batch-size", "8", "--max-len", "32"]) == 0
    assert VectorStore.load(idx, device="cpu").size == 8
    serve = ["serve", "--index", idx, "--db", db, "--device", "cpu"]
    # --hybrid writes bm25.json beside the store, and serve then fuses it
    hyb, hdb = str(tmp_path / "hyb"), str(tmp_path / "hyb.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", hyb, "--db", hdb, "--device", "cpu", "--capacity", "64",
                "--batch-size", "8", "--max-len", "32", "--hybrid"]) == 0
    assert os.path.exists(os.path.join(hyb, "bm25.json"))
    queries = iter([PASSAGES[3], ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(queries))
    assert cli(["serve", "--index", hyb, "--db", hdb, "--device", "cpu", "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "hybrid retrieval on (weight 0.5)" in out and "1. [3] " in out
    # an IVF index serves; a flat dir is no --ivf-index
    ivf = str(tmp_path / "ivf")
    assert cli(["build-ivf", "--index", idx, "--out", ivf, "--clusters", "8", "--kmeans-iters", "1",
                "--device", "cpu"]) == 0

    def eof(prompt=""):
        raise EOFError

    monkeypatch.setattr("builtins.input", eof)
    assert cli(["serve", "--index", ivf, "--db", db, "--device", "cpu", "--hybrid-weight", "1.0"]) == 0
    with pytest.raises(SystemExit, match="not an IVF directory"):
        cli(serve + ["--hybrid-weight", "1.0", "--ivf-index", idx])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli(["serve", "--index", idx, "--db", db, "--hybrid-weight", "1.0"])


def test_constructors_default_to_the_card(tmp_path, encoders):
    """Stores, loaders and model constructors run on the card unless the caller
    asks for the CPU; without a card that default raises, never runs on the
    CPU in its place."""
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.engine import IVFIndex
    from vietnamese_qa_system_tpu_torch.models import causal_from_jax, init_encoder

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the defaults would run on it")
    params, cfg, _ = encoders
    VectorStore(128, 16, tile_n=128, device="cpu").save(str(tmp_path))
    calls = [lambda: VectorStore(128, 16), lambda: VectorStore.load(str(tmp_path)), lambda: IVFIndex(),
             lambda: init_encoder(ModelConfig.from_json(cfg.to_json()), make_generator(0)),
             lambda: encoder_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_json(cfg.to_json())),
             lambda: causal_from_jax({}, ModelConfig.from_json(cfg.to_json()))]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# ---------------------------------------------------------------- no jax

NO_JAX = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    import torch
    torch.set_num_threads(2)
    import vietnamese_qa_system_tpu_torch as pkg
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if not mod.name.endswith("__main__"):
            importlib.import_module(mod.name)
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.engine import DocStore, IngestPipeline, Retriever, VectorStore
    from vietnamese_qa_system_tpu_torch.models import init_encoder, tiny_test
    enc = init_encoder(tiny_test("encoder"), make_generator(0), device="cpu")
    store = VectorStore(256, enc.cfg.d_model, tile_n=128, dtype="int8_res", device="cpu")
    docs = DocStore()
    texts = [f"tài liệu số {i} về chủ đề {i % 5}" for i in range(16)]
    IngestPipeline(enc, ByteTokenizer(), store, docs, batch_size=8, max_len=32).add_texts(texts)
    rows = Retriever(enc, ByteTokenizer(), store, docs, max_len=32, query_batch=8).search(texts, k=3)
    assert [r[0].id for r in rows] == list(range(16)), rows
    assert [r[0].doc for r in rows] == texts
    from vietnamese_qa_system_tpu_torch.engine import IVFIndex
    ivf = IVFIndex.build(store, n_clusters=8, kmeans_iters=2, sample_n=16)
    assert ivf.topk(store.get_vectors(range(16)), 1)[1][:, 0].tolist() == list(range(16))
    leaked = sorted(m for m in sys.modules if m == "vietnamese_qa_system_tpu" or m.startswith("vietnamese_qa_system_tpu.")
                    or m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m] is not None)
    assert not leaked, leaked
    print("no-jax slice ok")
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax slice ok" in proc.stdout
