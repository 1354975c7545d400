"""Hybrid BM25 + dense retrieval of the port against the JAX package:

- ``tokenize``, ``BM25Index`` scores and searches, and ``fuse_scores`` of
  the port's copy equal the JAX module's; ``bm25.json`` written by either
  package loads in the other;
- the native scorer (``csrc/bm25.cpp``, built by g++ at first use) equals
  the Python loop within rtol 1e-9, as tests/test_hybrid.py holds the JAX
  one; incremental adds score as a fresh index;
- ``Retriever`` hybrid search over indexes built and saved by the JAX
  package (flat bf16, int8, int8_global and an IVF index; ``bm25.json``
  beside them) equals the JAX ``Retriever`` in exact mode at k 10 and 64:
  on the same query vectors, fused ids and scores position by position (up
  to near-ties at the cut, ``assert_same_fused``), on a tie-free and on a
  tie-heavy corpus (repeated passages: equal fused scores, whose order both
  packages take from the same construction); with the port's own encoder,
  the JAX-built hybrid index served by the port returns JAX's fused ids;
- past k 64 the dense side asks for at most ``MAX_K`` candidates;
- ``cli ingest --hybrid`` and ``serve --hybrid-weight 0.5`` end to end,
  HTTP ``/ingest`` included, with the shutdown save of ``bm25.json``.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.core.mesh import SHARD_AXIS, create_mesh
from vietnamese_qa_system_tpu.data.tokenizer import ByteTokenizer as JTok
from vietnamese_qa_system_tpu.engine import IngestPipeline as JIngest
from vietnamese_qa_system_tpu.engine import Retriever as JRetriever
from vietnamese_qa_system_tpu.engine import VectorStore as JStore
from vietnamese_qa_system_tpu.engine import ivf as jivf
from vietnamese_qa_system_tpu.engine import lexical as jlex
from vietnamese_qa_system_tpu.models import encoder as je
from vietnamese_qa_system_tpu.models import tiny_test
from vietnamese_qa_system_tpu_torch.cli import main as cli
from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
from vietnamese_qa_system_tpu_torch.engine import BM25Index, Retriever, load_index
from vietnamese_qa_system_tpu_torch.engine import lexical as tlex
from vietnamese_qa_system_tpu_torch.models import ModelConfig, encoder_from_jax
from vietnamese_qa_system_tpu_torch.ops.topk import MAX_K

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fused scores: 0.5 x (f32 sums of the same bf16 / int8 products in another
# order, |score| <= 1) + 0.5 x BM25 (the same doubles in another order)
SCORE_TOL = 1e-5
# with each package's own encoder the query vectors differ by bf16 rounding
ENCODER_SCORE_TOL = 2e-3
WORDS = ("học sinh trường đại nghiên cứu khoa Việt Nam thành phố Hà Nội kinh tế văn hóa lịch sử sông Hồng đồng "
         "bằng miền núi nông nghiệp công giáo dục sức khỏe bệnh viện người dân chính phủ luật pháp môi trường "
         "khí hậu mùa mưa").split()


def _corpus(n: int, seed: int, repeats: int = 1) -> list:
    """Passages with a unique number each (tie-free), or ``repeats`` copies
    of each (exact ties on both sides)."""
    rng = np.random.default_rng(seed)
    base = [f"tài liệu {i}: " + " ".join(rng.choice(WORDS, int(rng.integers(4, 14)))) for i in range(n // repeats)]
    return [t for t in base for _ in range(repeats)]


def _queries(docs, seed: int) -> list:
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(docs), 6, replace=False)
    return ([" ".join(docs[i].split()[3:6]) for i in picks] + ["sông Hồng đồng bằng", "khí hậu mùa mưa ở miền núi"]
            + [docs[i] for i in picks[:2]])


# ------------------------------------------------------------- BM25 copy


def _bm25_pair(docs, ids=None):
    ids = list(range(len(docs))) if ids is None else ids
    j, t = jlex.BM25Index(), BM25Index()
    j.add(ids, docs)
    t.add(ids, docs)
    return j, t


def test_bm25_copy_equals_jax(tmp_path):
    docs = _corpus(300, 1) + _corpus(60, 2, repeats=3)
    for text in docs[:20] + ["Tiếng Việt có dấu: ắ ặ ỗ ữ, số 12 và_gạch"]:
        assert tlex.tokenize(text) == jlex.tokenize(text)
    j, t = _bm25_pair(docs)
    assert t.n_docs == j.n_docs and t.total_len == j.total_len and dict(t.postings) == dict(j.postings)
    py = BM25Index(native=False)
    py.add(list(range(len(docs))), docs)
    for q in _queries(docs, 3) + ["không có từ này", ""]:
        want = j.scores(q)
        for got in (t.scores(q), py.scores(q)):
            assert set(got) == set(want)
            for gid in want:
                np.testing.assert_allclose(got[gid], want[gid], rtol=1e-9)
        ws, ts = j.search(q, 25), t.search(q, 25)
        assert [g for g, _ in ts] == [g for g, _ in ws] or _ties_only(ws, ts)
        dense = {g: float(s) for g, s in zip(range(0, 40, 3), np.linspace(0.9, 0.1, 14))}
        for w in (0.0, 0.3, 0.5, 1.0):
            assert list(tlex.fuse_scores(dense, dict(ws), w).items()) == list(jlex.fuse_scores(dense, dict(ws),
                                                                                              w).items())


def _ties_only(want, got, tol=1e-12) -> bool:
    """Two searches differ only in the order of equal scores."""
    ws, gs = np.array([s for _, s in want]), np.array([s for _, s in got])
    if not np.allclose(ws, gs, rtol=tol, atol=0):
        return False
    for r, (a, b) in enumerate(zip(want, got)):
        if a[0] != b[0] and not any(abs(s - a[1]) <= tol for g, s in got if g == a[0]) and abs(ws[-1] - a[1]) > tol:
            return False
    return True


def test_bm25_json_loads_both_ways(tmp_path):
    docs = _corpus(120, 4)
    j, t = _bm25_pair(docs, [i * 3 + 1 for i in range(len(docs))])
    j.save(str(tmp_path / "j" / "bm25.json"))
    t.save(str(tmp_path / "t" / "bm25.json"))
    assert json.load(open(tmp_path / "j" / "bm25.json")) == json.load(open(tmp_path / "t" / "bm25.json"))
    from_j = BM25Index.load(str(tmp_path / "j" / "bm25.json"))
    from_t = jlex.BM25Index.load(str(tmp_path / "t" / "bm25.json"))
    for q in _queries(docs, 5):
        assert from_j.search(q, 10) == pytest.approx(j.search(q, 10), rel=1e-9)
        assert from_t.search(q, 10) == pytest.approx(t.search(q, 10), rel=1e-9)


def test_native_scorer_matches_python_loop():
    assert tlex.native_bm25() is not None, "g++ builds csrc/bm25.cpp on this host"
    assert os.path.exists(tlex.bm25_lib_path()) and tlex.bm25_lib_path().startswith(os.path.join(tlex.CSRC, "build"))
    rng = np.random.default_rng(6)
    words = [f"tu{i}" for i in range(50)] + ["chung"] * 10
    docs = [" ".join(rng.choice(words, size=rng.integers(3, 30))) for _ in range(200)]
    native, python = BM25Index(), BM25Index(native=False)
    for idx in (native, python):
        idx.add(list(range(100, 300)), docs)
    for q in ["chung tu1 tu2", "tu49", "khongco", "tu3 tu3 chung"]:
        n, p = native.scores(q), python.scores(q)
        assert set(n) == set(p)
        for gid in p:
            np.testing.assert_allclose(n[gid], p[gid], rtol=1e-9)
    assert native.scored == {"native": 4, "python": 0} and python.scored == {"native": 0, "python": 4}


def test_incremental_adds_equal_a_fresh_index():
    docs = ["hà nội là thủ đô của việt nam", "phở là món ăn nổi tiếng", "thành phố hồ chí minh lớn nhất việt nam",
            "bánh mì việt nam nổi tiếng thế giới", "vịnh hạ long là di sản thiên nhiên"]
    inc = BM25Index()
    inc.add([0, 1], docs[:2])
    inc.search("việt nam", k=5)  # freeze 1
    inc.add([2, 3], docs[2:4])
    inc.search("nổi tiếng", k=5)  # incremental freeze 2
    inc.add([4], docs[4:])
    fresh = BM25Index()
    fresh.add(list(range(len(docs))), docs)
    for q in ("việt nam", "nổi tiếng", "thủ đô", "di sản", "phở bánh mì"):
        assert inc.scores(q) == pytest.approx(fresh.scores(q))
        assert inc.search(q, k=5) == pytest.approx(fresh.search(q, k=5))
    with pytest.raises(ValueError, match="already indexed"):
        inc.add([4], ["lặp lại"])


# ----------------------------------------------- Retriever against JAX


@pytest.fixture(scope="module")
def encoders():
    cfg = tiny_test("encoder")
    params = je.init_encoder(jax.random.key(0), cfg)
    port = encoder_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_json(cfg.to_json()), device="cpu")
    return params, cfg, port


@pytest.fixture(scope="module")
def jax_indexes(encoders, tmp_path_factory):
    """(corpus, kind) -> (directory, JAX Retriever in exact mode): a JAX
    ingest with a BM25 index, saved (store or IVF index, and bm25.json)."""
    params, cfg, _ = encoders
    cache = {}

    def get(corpus: str, kind: str):
        if (corpus, kind) not in cache:
            docs = _corpus(240, 11) if corpus == "tie_free" else _corpus(240, 12, repeats=4)
            d = str(tmp_path_factory.mktemp(f"{corpus}_{kind}"))
            store = JStore(512, cfg.d_model, tile_n=128, mesh=create_mesh({SHARD_AXIS: 1}),
                           dtype="bf16" if kind == "ivf" else kind)
            lex = jlex.BM25Index()
            JIngest(params, cfg, JTok(), store, None, batch_size=16, max_len=48, lexical=lex).add_texts(docs)
            index = jivf.IVFIndex.build(store, n_clusters=8, nprobe=8, cap_mult=2.0, seed=0) if kind == "ivf" else store
            index.save(d)
            lex.save(os.path.join(d, "bm25.json"))
            retr = JRetriever(params, cfg, JTok(), index, None, max_len=48, query_batch=16, lexical=lex,
                              hybrid_weight=0.5, mode="exact")
            cache[corpus, kind] = docs, d, retr
        return cache[corpus, kind]

    return get


def _port_retriever(port_encoder, d, mode="fast"):
    return Retriever(port_encoder, ByteTokenizer(), load_index(d, device="cpu"), None, max_len=48, query_batch=16,
                     lexical=BM25Index.load(os.path.join(d, "bm25.json")), hybrid_weight=0.5, mode=mode)


def assert_same_fused(got_rows, want_rows, tol):
    """Fused results equal position by position up to near-ties: scores
    within ``tol``, and an id present in one row only scores within ``tol``
    of that row's last score (it swapped with a tied one at the cut) or of
    the score at its own position in the other row (a tie inside)."""
    for got, want in zip(got_rows, want_rows):
        assert len(got) == len(want)
        gs, ws = np.array([r.score for r in got]), np.array([r.score for r in want])
        np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
        gi, wi = [r.id for r in got], [r.id for r in want]
        for j, (a, b) in enumerate(zip(gi, wi)):
            if a != b:
                tied = [i for i, s in enumerate(ws) if abs(s - ws[j]) <= tol]
                assert b in [gi[i] for i in tied] or abs(ws[j] - ws[-1]) <= tol, (j, gi, wi, ws)


@pytest.mark.parametrize("k", [10, 64])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int8_global", "ivf"])
@pytest.mark.parametrize("corpus", ["tie_free", "tie_heavy"])
def test_hybrid_search_equals_jax(encoders, jax_indexes, corpus, kind, k):
    params, cfg, port_encoder = encoders
    docs, d, jretr = jax_indexes(corpus, kind)
    retr = _port_retriever(port_encoder, d, mode="exact" if kind == "ivf" else "fast")
    queries = _queries(docs, 21)
    qvecs = jretr.embed_queries(queries)
    retr.embed_queries = jretr.embed_queries = lambda texts: qvecs  # the same query vectors on both sides
    want = jretr.search(queries, k=k, fetch_docs=False)
    got = retr.search(queries, k=k, fetch_docs=False)
    assert_same_fused(got, want, SCORE_TOL)
    if corpus == "tie_free":
        # no tie can fall at the cut: the same ids in the same order
        assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
    else:
        # copies of one passage tie exactly, in both packages
        assert any(row[0].score == row[1].score for row in got)


@pytest.mark.parametrize("kind", ["bf16", "ivf"])
def test_jax_hybrid_index_served_by_the_port(encoders, jax_indexes, kind):
    """The port's own encoder over a JAX-built hybrid index (ROADMAP Queue
    1 #2): the same fused ids as the JAX package."""
    _, _, port_encoder = encoders
    docs, d, jretr = jax_indexes("tie_free", kind)
    jretr.__dict__.pop("embed_queries", None)
    retr = _port_retriever(port_encoder, d, mode="exact" if kind == "ivf" else "fast")
    queries = _queries(docs, 22)
    got, want = retr.search(queries, k=10), jretr.search(queries, k=10, fetch_docs=False)
    assert_same_fused(got, want, ENCODER_SCORE_TOL)
    assert [row[0].id for row in got] == [row[0].id for row in want]


def test_dense_candidates_capped_at_max_k(encoders):
    """m = max(4k, 20) dense candidates, at most MAX_K (the JAX package caps
    its non-exact modes at one lane, 128): past k 64 the cap binds."""
    from vietnamese_qa_system_tpu_torch.engine import IngestPipeline, VectorStore

    _, _, port_encoder = encoders
    docs = _corpus(400, 13)
    store, lex = VectorStore(512, port_encoder.cfg.d_model, tile_n=128, device="cpu"), BM25Index()
    IngestPipeline(port_encoder, ByteTokenizer(), store, None, batch_size=32, max_len=48, lexical=lex).add_texts(docs)
    retr = Retriever(port_encoder, ByteTokenizer(), store, None, max_len=48, query_batch=4, lexical=lex)
    asked = []
    topk = store.topk
    store.topk = lambda q, k, **kw: asked.append(k) or topk(q, k, **kw)
    for k in (3, 10, 64, 65, 200):
        rows = retr.search(["sông Hồng đồng bằng"], k=k)
        assert len(rows[0]) == k and len({r.id for r in rows[0]}) == k
    assert asked == [20, 40, 4 * 64, MAX_K, MAX_K]
    retr.hybrid_weight = 1.0  # dense only
    assert len(retr.search(["sông Hồng"], k=3)[0]) == 3 and asked[-1] == 3


# ------------------------------------------------------------------- CLI


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_cli_ingest_hybrid_and_serve(tmp_path):
    docs = _corpus(40, 31)
    inputs = tmp_path / "docs.jsonl"
    inputs.write_text("\n".join(json.dumps({"doc": t}, ensure_ascii=False) for t in docs[:30]), encoding="utf-8")
    more = tmp_path / "more.jsonl"
    more.write_text("\n".join(json.dumps({"doc": t}, ensure_ascii=False) for t in docs[30:]), encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    base = ["ingest", "--index", idx, "--db", db, "--device", "cpu", "--capacity", "256", "--batch-size", "8",
            "--max-len", "48", "--hybrid"]
    assert cli([*base, "--inputs", str(inputs)]) == 0
    assert cli([*base, "--inputs", str(more)]) == 0  # loads bm25.json and extends it
    bm25 = BM25Index.load(os.path.join(idx, "bm25.json"))
    assert bm25.n_docs == 40 and load_index(idx, device="cpu").size == 40
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "vietnamese_qa_system_tpu_torch.cli", "serve", "--index", idx,
                             "--db", db, "--device", "cpu", "--port", "0", "--max-len", "48", "--capacity", "256",
                             "--hybrid-weight", "0.5", "--k", "3"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("serving "):
                break
        assert any("hybrid retrieval on (weight 0.5)" in line for line in lines)
        url = line.split("http://", 1)[1].split(" ", 1)[0]
        hit = _post(f"http://{url}/search", {"query": " ".join(docs[7].split()[2:6]), "k": 3})["results"]
        assert hit[0]["id"] == 7 and hit[0]["doc"] == docs[7]
        new = _post(f"http://{url}/ingest", {"texts": ["Bài viết mới về zirconium và quasar."]})
        assert new["ids"] == [40]
        hit = _post(f"http://{url}/search", {"query": "zirconium quasar", "k": 3})["results"]
        assert hit[0]["id"] == 40
    finally:
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0 and "index persisted" in out, out
    saved = BM25Index.load(os.path.join(idx, "bm25.json"))
    assert saved.n_docs == 41 and saved.search("zirconium", 1)[0][0] == 40
