"""The port's QA path against the JAX package: ``QAPipeline.answer`` on
carried encoder and reader weights (test_engine.py's end-to-end setup),
``/qa`` over HTTP, the carried template and schema modules, and the
``serve --reader-size`` / ``chat`` command lines.

Answers are compared as strings: the reader decodes greedily, and on these
seeds no step of either question is a near-tie (test_torch_generate.py
holds the token streams by the margin rule)."""

import dataclasses
import json
import os
import random
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.data import schemas as jschemas
from vietnamese_qa_system_tpu.data import templates as jtemplates
from vietnamese_qa_system_tpu.data import tokenizer as jtok
from vietnamese_qa_system_tpu.engine import DocStore as JDocStore
from vietnamese_qa_system_tpu.engine import IngestPipeline as JIngest
from vietnamese_qa_system_tpu.engine import QAPipeline as JQAPipeline
from vietnamese_qa_system_tpu.engine import Retriever as JRetriever
from vietnamese_qa_system_tpu.engine import VectorStore as JStore
from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import encoder as je
from vietnamese_qa_system_tpu.models import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu.models import tiny_test
from vietnamese_qa_system_tpu_torch.cli import main as cli
from vietnamese_qa_system_tpu_torch.cli.main import build_parser
from vietnamese_qa_system_tpu_torch.data import schemas as tschemas
from vietnamese_qa_system_tpu_torch.data import templates as ttemplates
from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
from vietnamese_qa_system_tpu_torch.engine import (DocStore, IngestPipeline, QAPipeline, Retriever, ServingApp,
                                                   VectorStore, make_server)
from vietnamese_qa_system_tpu_torch.models import ModelConfig, causal_from_jax, encoder_from_jax

torch.set_num_threads(2)
DOCS = [f"tài liệu {i}: thông tin về chủ đề {i}" for i in range(16)]
QUESTIONS = [DOCS[3], DOCS[9], "câu hỏi nào đó không liên quan"]


def _cfg(jcfg):
    return ModelConfig.from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def both():
    """The same encoder, index contents and int8c reader in both packages."""
    enc_cfg = tiny_test("encoder")
    enc_params = je.init_encoder(jax.random.key(0), enc_cfg)
    jstore, jdocs = JStore(1024, enc_cfg.d_model, tile_n=128), JDocStore()
    JIngest(enc_params, enc_cfg, jtok.ByteTokenizer(), jstore, jdocs, batch_size=8, max_len=48).add_texts(DOCS)
    jretr = JRetriever(enc_params, enc_cfg, jtok.ByteTokenizer(), jstore, jdocs, max_len=48, query_batch=8)

    encoder = encoder_from_jax(jax.tree.map(np.asarray, enc_params), _cfg(enc_cfg), device="cpu")
    store, docs = VectorStore(1024, enc_cfg.d_model, tile_n=128, device="cpu"), DocStore()
    ingest = IngestPipeline(encoder, ByteTokenizer(), store, docs, batch_size=8, max_len=48)
    ingest.add_texts(DOCS)
    retr = Retriever(encoder, ByteTokenizer(), store, docs, max_len=48, query_batch=8)

    reader_cfg = tiny_test("causal")
    reader_params = jquant(jlm.init_causal_lm(jax.random.key(1), reader_cfg), "int8c")
    reader = causal_from_jax(jax.tree.map(np.asarray, reader_params), _cfg(reader_cfg), device="cpu")
    return (jretr, reader_params, reader_cfg), (retr, reader, ingest)


@pytest.mark.parametrize("min_score", [0.2, 0.5, 10.0])
def test_answers_match_jax(both, min_score):
    (jretr, jparams, jcfg), (retr, reader, _) = both
    kw = dict(k=2, min_score=min_score, max_prompt_len=256, max_new_tokens=4, seed=7)
    want = JQAPipeline(jretr, jparams, jcfg, jtok.ByteTokenizer(), **kw).answer(QUESTIONS)
    got = QAPipeline(retr, reader, ByteTokenizer(), **kw).answer(QUESTIONS)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.question == w.question and g.refused == w.refused
        assert g.contexts == w.contexts and g.answer == w.answer
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-3)
    if min_score == 0.2:
        assert not got[0].refused and got[0].contexts[0] == DOCS[3] and got[1].contexts[0] == DOCS[9]
    if min_score == 10.0:
        assert all(a.refused and a.contexts == [] for a in got) and QUESTIONS[2] in got[2].answer


def test_qa_refuses_unported_readers(both):
    """Speculative /qa is ported: prompt-lookup and draft-model answers equal
    the JAX pipeline's speculative answers and the port's plain ones.  A
    reader that is neither causal nor seq2seq raises (seq2seq readers:
    test_torch_seq2seq.py)."""
    (jretr, jparams, jcfg), (retr, reader, _) = both
    kw = dict(k=2, max_prompt_len=256, max_new_tokens=6, seed=7)
    want = [a.answer for a in JQAPipeline(jretr, jparams, jcfg, jtok.ByteTokenizer(), speculative="ngram",
                                          **kw).answer(QUESTIONS)]
    assert [a.answer for a in QAPipeline(retr, reader, ByteTokenizer(), **kw).answer(QUESTIONS)] == want
    for spec, draft in (("ngram", None), ("draft", reader)):
        qa = QAPipeline(retr, reader, ByteTokenizer(), speculative=spec, draft=draft, draft_tokens=3, **kw)
        assert qa.speculative == spec and [a.answer for a in qa.answer(QUESTIONS)] == want
    with pytest.raises(ValueError, match="causal or seq2seq"):
        QAPipeline(retr, SimpleNamespace(cfg=SimpleNamespace(arch="encoder")), ByteTokenizer())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_http_qa(both):
    _, (retr, reader, ingest) = both
    qa = QAPipeline(retr, reader, ByteTokenizer(), k=2, max_prompt_len=256, max_new_tokens=4)
    app = ServingApp(retr, qa, ingest=ingest, k=2, max_batch=8, max_wait_s=0.05)
    httpd = make_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        answers = [None] * 4

        def ask(i):
            answers[i] = _post(f"{url}/qa", {"question": DOCS[i + 4]})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, (status, body) in enumerate(answers):
            assert status == 200 and not body["refused"] and body["contexts"][0] == DOCS[i + 4]
            assert isinstance(body["answer"], str) and len(body["scores"]) == len(body["contexts"])
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["qa"] and health["stats"]["qa"]["requests"] == 4
        assert health["stats"]["qa"]["latency_ms"]["n"] == 4
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{url}/qa", {"question": " "})
        assert err.value.code == 400
        # no engine configured (serve without --continuous-slots): 400, as in the JAX package
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{url}/generate", {"prompt": "x"})
        assert err.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        th.join(timeout=10)
    assert not th.is_alive()


def test_template_and_schema_copies_render_identically():
    docs = ["Hà Nội là thủ đô.", "Sông Hồng chảy qua Hà Nội."]
    for fam in jtemplates.FAMILIES:
        assert ttemplates.FAMILIES[fam] == jtemplates.FAMILIES[fam]
    a, b = random.Random(11), random.Random(11)
    for _ in range(50):
        fields = dict(question="Thủ đô là gì?", context=tschemas.QAExample.flatten_docs(docs), answer="Hà Nội")
        assert tschemas.QAExample.flatten_docs(docs) == jschemas.QAExample.flatten_docs(docs)
        for fam in ("prompt", "no_answer", "response"):
            assert ttemplates.DEFAULT_BANK.render_random(fam, a, **fields) == \
                jtemplates.DEFAULT_BANK.render_random(fam, b, **fields)
    assert tschemas.QAExample.flatten_docs([]) == jschemas.QAExample.flatten_docs([])
    assert (tschemas.QUESTION_PREFIX, tschemas.RESPONSE_PREFIX) == (jschemas.QUESTION_PREFIX, jschemas.RESPONSE_PREFIX)
    with pytest.raises(KeyError, match="needs field"):
        ttemplates.DEFAULT_BANK.render("prompt", 0, question="x")


def _feed(monkeypatch, lines):
    it = iter(lines)

    def fake_input(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", fake_input)


def test_cli_chat_and_serve_reader(tmp_path, monkeypatch, capsys):
    _feed(monkeypatch, ["Xin chào", ""])
    assert cli(["chat", "--model-size", "tiny", "--quantize", "int8c", "--max-len", "64", "--max-new-tokens", "4",
                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "RANDOM weights" in out and "int8c base" in out and "model> " in out

    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": d}, ensure_ascii=False) for d in DOCS[:6]), encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--batch-size", "8",
                "--max-len", "48"]) == 0
    serve = ["serve", "--index", idx, "--db", db, "--device", "cpu", "--max-len", "48"]
    _feed(monkeypatch, [DOCS[2], ""])
    assert cli(serve + ["--reader-size", "tiny", "--reader-quantize", "int8", "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "answer> " in out and DOCS[2][:40] in out

    # --reader-params and chat --init-params load a flat .npz of the parameter tree
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.models import config as tcfg
    from vietnamese_qa_system_tpu_torch.models import init_causal_lm
    from vietnamese_qa_system_tpu_torch.train.checkpoint import save_pytree
    from vietnamese_qa_system_tpu_torch.train.trainer import params_tree

    weights = str(tmp_path / "reader" / "params.npz")
    os.makedirs(os.path.dirname(weights))
    save_pytree(weights, params_tree(init_causal_lm(tcfg.tiny_test("causal"), make_generator(5))))
    _feed(monkeypatch, [DOCS[2], ""])
    assert cli(serve + ["--reader-size", "tiny", "--reader-params", weights, "--max-new-tokens", "3"]) == 0
    _feed(monkeypatch, ["Xin chào", ""])
    assert cli(["chat", "--init-params", weights, "--max-len", "64", "--max-new-tokens", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(f"reader weights loaded from {weights}") == 2 and "RANDOM" not in out and "model> " in out
    # --continuous-slots builds the engine (behind --port: test_torch_continuous.py, with --adapter:
    # test_torch_multilora.py); an --adapter without NAME=PATH raises before the server starts
    with pytest.raises(SystemExit, match="needs a reader"):
        cli(serve + ["--port", "0", "--continuous-slots", "4"])
    with pytest.raises(SystemExit, match="NAME=PATH"):
        cli(serve + ["--port", "0", "--reader-size", "tiny", "--continuous-slots", "4", "--adapter", "vi"])
    with pytest.raises(SystemExit, match="shards plain bf16 readers"):
        cli(serve + ["--reader-size", "tiny", "--reader-quantize", "int8", "--reader-strategy", "tp"])
    _feed(monkeypatch, [DOCS[2], ""])  # an nf4 reader answers in the REPL
    assert cli(serve + ["--reader-size", "tiny", "--reader-quantize", "nf4"]) == 0
    assert "reader decodes over a nf4 base" in capsys.readouterr().out
    # speculation, draft models and beams take the JAX CLI's flags and defaults
    args = build_parser().parse_args(serve)
    assert (args.speculative, args.reader_draft_size, args.reader_draft_params) == ("ngram", "tiny", None)
    args = build_parser().parse_args(["chat"])
    assert (args.speculative, args.num_beams, args.draft_tokens, args.draft_ngram, args.draft_size,
            args.draft_params) == ("ngram", 1, 8, 3, "tiny", None)
    _feed(monkeypatch, [DOCS[2], ""])
    assert cli(serve + ["--reader-size", "tiny", "--speculative", "draft", "--reader-draft-size", "tiny",
                        "--max-new-tokens", "3"]) == 0
    _feed(monkeypatch, [DOCS[2], ""])
    assert cli(serve + ["--reader-size", "tiny", "--speculative", "draft", "--reader-draft-params", weights,
                        "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("(no --reader-draft-params: drafting with RANDOM weights)") == 1 and out.count("answer> ") == 2
    for extra in (["--draft-size", "tiny", "--speculative", "draft"], ["--draft-params", weights, "--speculative",
                                                                      "draft"], ["--num-beams", "2"]):
        _feed(monkeypatch, ["Xin chào", ""])
        assert cli(["chat", "--device", "cpu", "--max-len", "64", "--max-new-tokens", "3", *extra]) == 0
    out = capsys.readouterr().out
    assert out.count("(no --draft-params: drafting with RANDOM weights)") == 1 and out.count("model> ") == 3
    # seq2seq readers take the JAX CLI's flags (their runs: test_torch_train.py's
    # test_cli_train_and_chat_seq2seq_on_the_cpu); a draft preset outside the JAX list is refused
    for argv in (serve + ["--reader-size", "mt5small"], ["chat", "--model-size", "mt5small"],
                 ["chat", "--arch", "seq2seq"]):
        build_parser().parse_args(argv)
    with pytest.raises(SystemExit):
        cli(["chat", "--draft-size", "phogpt4b"])
