"""The port's offline ETL (``vietnamese_qa_system_tpu_torch/etl``) against
the JAX package's:

- every case of tests/test_etl.py, run on the port as parametrised cases;
- each of the 17 parsers' output file byte-equal to JAX's on the same
  inputs and seed (plain, with translation and its code-skip gate, with
  random context injection), and their stats equal;
- the code filter and tone normalization equal over a set of texts;
- ``translate_texts``: order kept through failures, exact-chunk
  resubmission, giving up after ``max_retries``, ``MAX_FIELD_CHARS``;
- sources: ``hf://`` specs, local files, a parser over an
  ``HFDatasetSource`` with ``data_files`` in the test's directory
  (``HF_DATASETS_OFFLINE=1``), and JAX's error when ``datasets`` is missing;
- ``Seq2SeqTranslator`` over a tiny T5 and a tiny mBART carried from JAX
  params: the strings of JAX's ``Seq2SeqTranslator``, greedy and W 2
  beams (greedy tokens by the margin rule of test_torch_seq2seq.py where
  a step is a near-tie);
- the contracts and the logging helpers; the modules import without jax.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import vietnamese_qa_system_tpu.etl as jetl
import vietnamese_qa_system_tpu_torch.etl as tetl
from vietnamese_qa_system_tpu.etl import translate as jtr
from vietnamese_qa_system_tpu_torch.etl import translate as ttr

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jetl, "port": tetl}


def _write_jsonl(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


CODE = "def f(x):\n  return {x};\nimport os; class A: pass"
# parser -> its raw rows (a JSON document for squad_v2); old-style tones
# ("hòa", "thúy", "khỏe") exercise the normalization of save()
RAW = {
    "alpaca": [{"instruction": "Tóm tắt hòa bình", "input": "văn bản dài", "output": "tóm tắt ngắn"},
               {"instruction": "Giải thích", "input": "", "output": "lời giải thúy"},
               {"id": "a3", "instruction": "write code", "input": "", "output": CODE},
               {"instruction": "Không đáp", "input": "x", "output": ""}],
    "dolly": [{"instruction": "Hỏi", "context": "bối cảnh khỏe", "response": "đáp"},
              {"instruction": "Hỏi 2", "context": "", "response": CODE}],
    "openorca": [{"id": "o1", "system_prompt": "Bạn là trợ lý.", "question": "q?", "response": "r"},
                 {"system_prompt": "", "question": "q2?", "response": "r2"}],
    "wizardlm": [{"instruction": "Viết thơ", "output": "thơ hòa"}, {"instruction": "Code", "output": CODE}],
    "bactrian_x": [{"instruction": "Dịch", "input": "hello", "output": "xin chào"}],
    "lima_vi": [{"conversations": ["Câu hỏi?", "Trả lời thúy."]}, {"conversations": ["lẻ"]},
                {"id": "l3", "conversations": ["a", "b", "c"]}],
    "math_instruct": [{"instruction": "1+1?", "output": "2"}],
    "math_qa": [{"Problem": "2*3?", "options": "a) 5 b) 6", "Rationale": "2*3=6", "correct": "b"},
                {"Problem": "p", "options": "", "Rationale": "", "correct": ""}],
    "grade_school_math": [{"INSTRUCTION": "Tính 4+4", "RESPONSE": "8"}],
    "zaloai_math": [{"question": "1+1 bằng mấy?", "choices": ["1", "2", "3"], "answer": "B",
                     "explanation": "Vì 1+1=2."},
                    {"question": "q", "choices": [], "answer": "", "explanation": ""}],
    "mt_eng_vietnamese": [{"translation": {"en": "hello", "vi": "xin chào"}}, {"en": "peace", "vi": "hòa bình"},
                          {"translation": {"en": "", "vi": "rỗng"}}],
    "eli5": [{"q_id": "q1", "question": "Tại sao trời xanh?", "doc_tokens": [f"doc {i}" for i in range(15)],
              "answers": {"text": ["tán xạ ánh sáng", "một đáp án khác"]}},
             {"title": "Vì sao?", "ctxs": [{"text": "ctx một"}, {"text": "ctx hai"}], "answers": ["a1", "a2"]},
             {"question": "", "answers": "x"},
             {"id": "e4", "question": "Không có đáp?", "documents": ["d"], "answers": None}],
    "webglm_qa": [{"question": "q?", "answer": "a [1]", "references": ["ref một", "ref hai"]},
                  {"id": "w2", "question": "q2?", "answer": "", "references": []}],
    "squad_v2": {"data": [{"paragraphs": [
        {"context": "Bối cảnh hòa.", "qas": [
            {"id": "1", "question": "Có?", "answers": [{"text": "có"}], "is_impossible": False},
            {"id": "2", "question": "Không?", "answers": [], "is_impossible": True},
            {"question": "Không id?", "answers": [{"text": "đáp"}]}]},
        {"context": "", "qas": [{"question": "Trống?", "answers": []}]}]}]},
    "train_ir": [{"query_id": "t1", "query": "truy vấn", "pos": [{"text": "đúng"}], "neg": ["sai 1", "sai 2", "sai 3"]},
                 {"question": "hỏi", "positive_passages": [], "negative_passages": [{"text": "n"}]}],
    "ctx_injector": [{"id": str(i), "question": "q", "documents": ["chính"], "answer": "a"} for i in range(5)],
    "generic_instruct": [{"instruction": "Làm gì?", "input": "", "output": "làm"}],
}
CTX_POOL = ["nhiễu một", "nhiễu hai", "nhiễu ba"]


class Upper:
    """A translator that upper-cases, to see which fields were translated."""

    def translate_batch(self, texts, src, dst):
        return [t.upper() for t in texts]


def _raw_file(tmp_path, name) -> str:
    if name == "squad_v2":
        path = tmp_path / "squad.json"
        path.write_text(json.dumps(RAW[name], ensure_ascii=False), encoding="utf-8")
    else:
        path = tmp_path / f"{name}.jsonl"
        _write_jsonl(path, RAW[name])
    return str(path)


def _run(pkg, name, src, out, **kw):
    cls = PACKAGES[pkg].get_parser(name)
    if name == "ctx_injector":
        kw.setdefault("ctx_pool", CTX_POOL)
    parser = cls(src, out, **kw)
    path = parser.run()
    with open(path, "rb") as f:
        return os.path.basename(path), f.read(), parser.stats


@pytest.mark.parametrize("variant", ["plain", "translate", "ctx_pool"])
@pytest.mark.parametrize("name", sorted(RAW))
def test_parser_output_byte_equal_to_jax(tmp_path, name, variant):
    src = _raw_file(tmp_path, name)
    kw = {"plain": dict(seed=3), "translate": dict(seed=5, do_translate=True, translator=Upper()),
          "ctx_pool": dict(seed=7, ctx_pool=CTX_POOL, max_ctx_inject=2)}[variant]
    want = _run("jax", name, src, str(tmp_path / "jax"), **kw)
    got = _run("port", name, src, str(tmp_path / "port"), **kw)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1] == want[1], (got[1].decode()[:400], want[1].decode()[:400])
    assert got[1], "the parser wrote no records"


def test_registry_equals_jax():
    assert sorted(tetl.PARSER_REGISTRY) == sorted(jetl.PARSER_REGISTRY) and len(tetl.PARSER_REGISTRY) == 17
    assert {k: v.__name__ for k, v in tetl.PARSER_REGISTRY.items()} == \
        {k: v.__name__ for k, v in jetl.PARSER_REGISTRY.items()}
    assert tetl.__all__ == jetl.__all__
    from vietnamese_qa_system_tpu_torch.etl.parsers import AlpacaParser

    assert tetl.get_parser("alpaca") is AlpacaParser
    with pytest.raises(KeyError, match="available"):
        tetl.get_parser("nope")


TEXTS = ["def foo(x):\n    return {x: 1};\nimport re\nclass A: pass",
         "Hà Nội là thủ đô của Việt Nam. Thành phố này có lịch sử hơn một nghìn năm với nhiều di tích.",
         "SELECT * FROM t WHERE a == b && c != d; // comment", "hòa bình, thúy, khỏe, ÒA, Ọa, Thủy, HÒA", "",
         "console.log(x) => y; #include <a.h> $(sel) || z", "không đổi gì"]


@pytest.mark.parametrize("threshold", [1, 5, 9])
def test_filters_and_tones_equal_jax(threshold):
    for text in TEXTS:
        assert tetl.have_code(text, threshold) == jetl.have_code(text, threshold)
        assert tetl.code_likelihood_score(text) == jetl.code_likelihood_score(text)
        assert tetl.normalize_tones(text) == jetl.normalize_tones(text)
    assert tetl.TONE_MAP == jetl.TONE_MAP


# ------------------------------------------- the cases of tests/test_etl.py


def _case_code_filter():
    flagged, score, _ = tetl.have_code(TEXTS[0])
    assert flagged and score >= 5
    assert not tetl.have_code(TEXTS[1])[0]


def _case_tones():
    n = tetl.normalize_tones
    assert n("hòa bình") == "hoà bình" and n("thúy") == "thuý" and n("khỏe") == "khoẻ"
    assert n("ÒA") == "OÀ" and n("Ọa") == "Oạ" and n("hoà bình") == "hoà bình" and n("không đổi gì") == "không đổi gì"


def _case_translate_retries():
    texts = [f"text {i}" for i in range(10)]
    assert tetl.translate_texts(texts, tetl.FlakyWrapper(tetl.NullTranslator(), fail_times=2), chunk_size=3,
                                max_retries=3) == texts


def _case_translate_gives_up():
    with pytest.raises(RuntimeError, match="still failing"):
        tetl.translate_texts(["a", "b"], tetl.FlakyWrapper(tetl.NullTranslator(), fail_times=99), chunk_size=1,
                             max_retries=2)


def _case_contract(tmp_path):
    class BadParser(tetl.DataParser):
        schema = "instruct"

        def read(self):  # missing super().read()
            self.raw = []

        def convert(self):
            super().convert()
            self.converted = []

    with pytest.raises(TypeError, match="never calls super"):
        BadParser(None, str(tmp_path)).read()


def _case_save_validates(tmp_path):
    class EmptyParser(tetl.DataParser):
        schema = "instruct"

        def read(self):
            super().read()
            self.raw = []

        def convert(self):
            super().convert()
            self.converted = [{"id": "x", "bad_field": 1}]

    p = EmptyParser(None, str(tmp_path))
    p.read()
    p.convert()
    with pytest.raises(ValueError, match="unknown fields"):
        p.save()


def _rows(path):
    return [json.loads(line) for line in open(path, encoding="utf-8")]


def _case_alpaca(tmp_path):
    src = tmp_path / "alpaca.jsonl"
    _write_jsonl(src, [{"instruction": "Tóm tắt", "input": "văn bản dài", "output": "tóm tắt ngắn"},
                       {"instruction": "Giải thích", "input": "", "output": "lời giải"}])
    rows = _rows(tetl.get_parser("alpaca")(str(src), str(tmp_path / "out")).run())
    assert len(rows) == 2 and rows[0]["question"] == "Tóm tắt\nvăn bản dài" and rows[1]["question"] == "Giải thích"
    assert rows[0]["system_prompt"]


def _case_zaloai(tmp_path):
    src = tmp_path / "zalo.jsonl"
    _write_jsonl(src, RAW["zaloai_math"][:1])
    rows = _rows(tetl.get_parser("zaloai_math")(str(src), str(tmp_path / "out")).run())
    assert "A. 1" in rows[0]["question"] and "B. 2" in rows[0]["question"] and "Đáp án: B" in rows[0]["answer"]


def _case_translation_pairs(tmp_path):
    src = tmp_path / "mt.jsonl"
    _write_jsonl(src, [{"translation": {"en": "hello", "vi": "xin chào"}}])
    rows = _rows(tetl.get_parser("mt_eng_vietnamese")(str(src), str(tmp_path / "out")).run())
    assert len(rows) == 2 and {r["answer"] for r in rows} == {"hello", "xin chào"}


def _case_eli5(tmp_path):
    src = tmp_path / "eli5.jsonl"
    _write_jsonl(src, RAW["eli5"][:1])
    rows = _rows(tetl.get_parser("eli5")(str(src), str(tmp_path / "out")).run())
    assert len(rows) == 1 and len(rows[0]["documents"]) == 10 and rows[0]["answer"] == "tán xạ ánh sáng"


def _case_webglm(tmp_path):
    src = tmp_path / "webglm.jsonl"
    _write_jsonl(src, RAW["webglm_qa"][:1])
    rows = _rows(tetl.get_parser("webglm_qa")(str(src), str(tmp_path / "out")).run())
    assert rows[0]["documents"] == ["ref một", "ref hai"]


def _case_squad(tmp_path):
    src = _raw_file(tmp_path, "squad_v2")
    rows = _rows(tetl.get_parser("squad_v2")(src, str(tmp_path / "out")).run())
    assert rows[0]["answer"] == "có" and rows[1]["answer"] is None


def _case_ctx_injector(tmp_path):
    src = tmp_path / "qa.jsonl"
    _write_jsonl(src, [{"id": "1", "question": "q", "documents": ["chính"], "answer": "a"}] * 5)
    rows = _rows(tetl.get_parser("ctx_injector")(str(src), str(tmp_path / "out"), ctx_pool=["nhiễu một", "nhiễu hai"],
                                                 max_ctx_inject=2, seed=0).run())
    assert all("chính" in r["documents"] for r in rows) and any(len(r["documents"]) > 1 for r in rows)
    with pytest.raises(ValueError, match="requires a ctx_pool"):
        tetl.get_parser("ctx_injector")(str(src), str(tmp_path / "out"))


def _case_translation_skips_code(tmp_path):
    src = tmp_path / "x.jsonl"
    _write_jsonl(src, [{"instruction": "prose only here", "input": "", "output": "an answer"},
                       {"instruction": "write code", "input": "", "output": CODE}])
    p = tetl.get_parser("alpaca")(str(src), str(tmp_path / "out"), do_translate=True, translator=Upper())
    rows = _rows(p.run())
    assert rows[0]["answer"] == "AN ANSWER" and "def f(x)" in rows[1]["answer"]
    assert p.stats["translate_skipped_code"] == 1


def _case_reformat(tmp_path):
    src = tmp_path / "arr.json"
    src.write_text(json.dumps([{"a": 1}, {"a": 2}]))
    (out,) = tetl.reformat_data([str(src)])
    assert [json.loads(line) for line in open(out)] == [{"a": 1}, {"a": 2}]
    assert out == str(tmp_path / "arrFormated.jsonl")
    assert tetl.load_json_or_jsonl(out) == tetl.load_json_or_jsonl(str(src)) == jetl.load_json_or_jsonl(str(src))


def _case_registry(tmp_path):
    from vietnamese_qa_system_tpu_torch.etl.parsers import AlpacaParser

    assert tetl.get_parser("alpaca") is AlpacaParser
    with pytest.raises(KeyError):
        tetl.get_parser("nope")


def _case_missing_input(tmp_path):
    with pytest.raises(FileNotFoundError):
        tetl.get_parser("alpaca")(str(tmp_path / "missing.jsonl"), str(tmp_path / "out")).run()
    with pytest.raises(RuntimeError, match="before read"):
        tetl.get_parser("alpaca")(None, str(tmp_path / "out")).convert()


CASES = {name[len("_case_"):]: fn for name, fn in dict(globals()).items() if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_etl_cases_on_the_port(tmp_path, case):
    fn = CASES[case]
    fn(tmp_path) if fn.__code__.co_argcount else fn()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_translate_resubmits_exact_chunks_and_caps_fields(pkg):
    """Each failing chunk is resubmitted as it was, on the same offsets,
    in both packages; fields past MAX_FIELD_CHARS are cut."""
    mod = {"jax": jtr, "port": ttr}[pkg]
    seen = []

    class Recorder:
        def translate_batch(self, texts, src, dst):
            seen.append((tuple(texts), src, dst))
            return [t[::-1] for t in texts]

    texts = [f"câu {i}" for i in range(11)] + ["x" * (mod.MAX_FIELD_CHARS + 50)]
    out = mod.translate_texts(texts, mod.FlakyWrapper(Recorder(), fail_times=1), src="vi", dst="en", chunk_size=4,
                              max_workers=3)
    assert mod.MAX_FIELD_CHARS == ttr.MAX_FIELD_CHARS == jtr.MAX_FIELD_CHARS
    assert out[:11] == [t[::-1] for t in texts[:11]] and out[11] == "x" * mod.MAX_FIELD_CHARS
    assert sorted(s[0] for s in seen) == sorted(tuple(texts[i: i + 4])[:4] if i < 8 else
                                                (texts[8], texts[9], texts[10], "x" * mod.MAX_FIELD_CHARS)
                                                for i in range(0, 12, 4))
    assert {s[1:] for s in seen} == {("vi", "en")}

    class Short:
        def translate_batch(self, texts, src, dst):
            return list(texts)[:-1]

    with pytest.raises(RuntimeError, match="still failing"):
        mod.translate_texts(["a", "b"], Short(), chunk_size=2, max_retries=1)


# ------------------------------------------------------------------ sources


@pytest.fixture
def raw_file(tmp_path):
    p = tmp_path / "raw.jsonl"
    _write_jsonl(p, [{"instruction": f"câu hỏi {i}", "input": "", "output": f"trả lời {i}"} for i in range(5)])
    return str(p)


def test_sources_match_jax(raw_file, tmp_path, monkeypatch):
    from vietnamese_qa_system_tpu.etl import sources as jsrc
    from vietnamese_qa_system_tpu_torch.etl import sources as tsrc

    for spec in ("some/local/file.jsonl", "hf://Open-Orca/OpenOrca#train", "hf://facebook/eli5@LFQA#validation",
                 "hf://name"):
        got, want = tsrc.parse_source_spec(spec), jsrc.parse_source_spec(spec)
        assert type(got).__name__ == type(want).__name__ and vars(got) == vars(want)
    for mod in (tsrc, jsrc):
        with pytest.raises(ValueError, match="empty dataset name"):
            mod.parse_source_spec("hf://#train")
    local = tsrc.LocalFileSource(raw_file)
    assert local.exists() and local.load() == jsrc.LocalFileSource(raw_file).load() and len(local.load(2)) == 2
    assert not tsrc.LocalFileSource(str(tmp_path / "missing.jsonl")).exists()
    # the datasets path, offline: the json builder over a file of this test
    monkeypatch.setenv("HF_DATASETS_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_DATASETS_CACHE", str(tmp_path / "hf_cache"))
    pytest.importorskip("datasets")
    s = tsrc.HFDatasetSource("json", data_files=raw_file, streaming=True)
    assert s.load() == local.load() and len(s.load(max_examples=1)) == 1
    out = tetl.get_parser("alpaca")(None, str(tmp_path / "out"), source=s, seed=0).run()
    want = jetl.get_parser("alpaca")(raw_file, str(tmp_path / "jax"), seed=0).run()
    assert open(out, "rb").read() == open(want, "rb").read()


def test_hf_source_without_datasets_raises_jax_error(monkeypatch):
    from vietnamese_qa_system_tpu_torch.etl.sources import HFDatasetSource

    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match=r"hf:// sources need the `datasets` library; install it or use a local "
                                           r"json/jsonl path"):
        HFDatasetSource("Open-Orca/OpenOrca").load(1)


# ---------------------------------------------------------------- translator


def _translators(family, beams):
    """(JAX Seq2SeqTranslator, the port's, JAX params, JAX cfg) over a tiny
    model of ``family`` carried from JAX params."""
    from test_torch_seq2seq import CONFIGS, jax_params, port_model

    from vietnamese_qa_system_tpu.data.tokenizer import ByteTokenizer as JTok
    from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer as TTok

    cfg = dataclasses.replace(CONFIGS[family], vocab_size=512)
    params = jax_params(cfg, seed=2)
    model = port_model(params, cfg)
    tok = JTok()
    kw = dict(max_len=32, max_new_tokens=6, num_beams=beams, prompt="{src}-{dst}: {text}")
    if family == "bart":  # mBART: the decoder starts at eos and the language id is forced first
        kw.update(bos_id=tok.eos_id, forced_bos_id=300)
    return (jtr.Seq2SeqTranslator(params, cfg, tok, **kw), ttr.Seq2SeqTranslator(model, TTok(), **kw), params, cfg,
            model, kw)


@pytest.mark.parametrize("beams", [1, 2])
@pytest.mark.parametrize("family", ["t5", "bart"])
def test_seq2seq_translator_equals_jax(family, beams):
    jt, tt, params, cfg, model, kw = _translators(family, beams)
    texts = [f"sentence number {i} about Hà Nội" for i in range(5)]
    want = jtr.translate_texts(texts, jt, chunk_size=2, max_workers=2)
    got = ttr.translate_texts(texts, ttr.FlakyWrapper(tt, fail_times=1), chunk_size=2, max_workers=2)
    assert len(got) == 5 and all(isinstance(t, str) for t in got)
    if family == "bart":
        assert all("Ĭ" not in t for t in got)  # the forced id (300) is dropped with the specials
    if got == want:
        return
    assert beams == 1, (got, want)  # beams are compared exactly, as in test_torch_seq2seq.py
    # greedy near-ties: hold the tokens to JAX's by the margin rule
    from test_torch_seq2seq import assert_margin_rule

    from vietnamese_qa_system_tpu.data.tokenizer import batch_encode
    from vietnamese_qa_system_tpu.models import generate as jg
    from vietnamese_qa_system_tpu_torch.models import generate as tg

    rendered = [kw["prompt"].format(text=t, src="en", dst="vi") for t in texts]
    ids, mask = batch_encode(jt.tok, rendered, kw["max_len"])
    gen = dict(max_new_tokens=6, forced_bos_token_id=kw.get("forced_bos_id"))
    want_ids = np.asarray(jg.generate_with_config(params, cfg, np.asarray(ids), np.asarray(mask),
                                                  jg.GenerationConfig(**gen), eos_id=jt.tok.eos_id,
                                                  bos_id=kw.get("bos_id", 0)))
    got_ids = tg.generate_with_config(model, ids, mask, tg.GenerationConfig(**gen), eos_id=jt.tok.eos_id,
                                      bos_id=kw.get("bos_id", 0)).numpy()
    assert_margin_rule(got_ids, want_ids, params, cfg, np.asarray(ids), np.asarray(mask), bos=kw.get("bos_id", 0))


# ------------------------------------------------------ contracts, logging


def _contract_outcomes(mod) -> list:
    """What each kind of override gives under ``mod``'s contract: its value,
    or the TypeError's text."""

    class Base(metaclass=mod.BaseCallEnforcedMeta):
        @mod.enforce_base_call
        def hook(self):
            return "base"

    class Good(Base):
        def hook(self):
            return super().hook() + "+good"

    class Bad(Base):
        def hook(self):
            return "bad"

    class Nested(Good):  # the inner override's check resets the calls seen
        def hook(self):
            return super().hook() + "+nested"

    out = []
    for cls in (Base, Good, Bad, Nested):
        try:
            out.append(cls().hook())
        except TypeError as e:
            out.append(str(e).split(".<locals>.")[-1].replace("test_contracts_and_logging", ""))
    return out


def test_contracts_and_logging(capsys):
    from vietnamese_qa_system_tpu.utils import contracts as jcontracts
    from vietnamese_qa_system_tpu_torch.utils import contracts as tcontracts
    from vietnamese_qa_system_tpu_torch.utils.logging import dist_print, get_logger, in_notebook

    got = _contract_outcomes(tcontracts)
    assert got == _contract_outcomes(jcontracts)
    assert got[:2] == ["base", "base+good"] and got[2] == "Base.hook but never calls super().hook()"
    logger = get_logger("vqa_tpu.test")
    assert get_logger("vqa_tpu.test") is logger and len(logger.handlers) == 1
    dist_print("only on process 0")
    assert capsys.readouterr().out == "only on process 0\n"
    assert in_notebook() is False


def test_etl_imports_without_jax_or_datasets():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'vietnamese_qa_system_tpu', 'datasets', 'transformers'):\n"
            "    sys.modules[name] = None\n"
            "import vietnamese_qa_system_tpu_torch.etl as e\n"
            "from vietnamese_qa_system_tpu_torch.etl.translate import Seq2SeqTranslator\n"
            "from vietnamese_qa_system_tpu_torch.utils import contracts, logging\n"
            "print(len(e.PARSER_REGISTRY), e.normalize_tones('hòa'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "17 hoà"
