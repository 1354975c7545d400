"""The port's beam search and generative eval against the JAX package:
``beam_search`` token for token on carried weights (tests/test_models.py
and tests/test_generation_config.py's cases), ``_reorder_cache``,
``generative_eval``'s records and prediction file, and ``cli train
--do-generative-eval`` on the CPU."""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.models import quantize_dense_tree as jquant
from vietnamese_qa_system_tpu.models import tiny_test
from vietnamese_qa_system_tpu.train import generative_eval as jgenerative_eval
from vietnamese_qa_system_tpu_torch.cli.main import main as cli_main
from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
from vietnamese_qa_system_tpu_torch.models import GenerationConfig, ModelConfig, causal_from_jax, make_cache
from vietnamese_qa_system_tpu_torch.models import generate as tg
from vietnamese_qa_system_tpu_torch.train import generative_eval

torch.set_num_threads(2)
SAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "sample_instruct.jsonl")


@pytest.fixture(scope="module")
def causal():
    """tiny_test("causal") in both packages, float and int8c."""
    cfg = tiny_test("causal")
    params = jlm.init_causal_lm(jax.random.key(0), cfg)
    out = {}
    for quantize in (None, "int8c"):
        p = jquant(params, quantize) if quantize else params
        out[quantize] = (p, causal_from_jax(jax.tree.map(np.asarray, p), ModelConfig.from_dict(dataclasses.asdict(cfg)),
                                            device="cpu"))
    return cfg, out


def _batch(b, t, seed, pad=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 260, (b, t)).astype(np.int32)
    mask = np.ones_like(ids)
    if pad:
        mask[1::2, : t // 3] = 0
    return ids * mask, mask


CASES = {
    "w1": dict(num_beams=1),
    "w4": dict(num_beams=4),
    "w4_eos_min_new": dict(num_beams=4, eos_id=2, min_new_tokens=4),
    "w2_repetition_penalty": dict(num_beams=2, repetition_penalty=8.0),
    "w3_eos_length_penalty": dict(num_beams=3, eos_id=5, length_penalty=0.5),
}


@pytest.mark.parametrize("quantize", [None, "int8c"])
@pytest.mark.parametrize("case", list(CASES))
def test_beam_search_matches_jax(causal, case, quantize):
    cfg, models = causal
    params, port = models[quantize]
    ids, mask = _batch(3, 10, seed=len(case))
    kw = CASES[case]
    want = np.asarray(jg.beam_search(params, cfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=8, **kw))
    got = tg.beam_search(port, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=8, **kw)
    assert got.shape == (3, 18) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    via_config = tg.generate_with_config(
        port, torch.from_numpy(ids), torch.from_numpy(mask),
        GenerationConfig(max_new_tokens=8, **{k: v for k, v in kw.items() if k != "eos_id"}), eos_id=kw.get("eos_id"))
    assert torch.equal(via_config, got) if kw["num_beams"] > 1 else torch.equal(
        via_config, tg.generate(port, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=8,
                                eos_id=kw.get("eos_id"), repetition_penalty=kw.get("repetition_penalty", 1.0),
                                min_new_tokens=kw.get("min_new_tokens", 0)))


def test_beam_w1_equals_greedy(causal):
    """tests/test_models.py:305."""
    _, models = causal
    port = models[None][1]
    ids, mask = (torch.from_numpy(a) for a in _batch(2, 8, seed=17, pad=False))
    assert torch.equal(tg.beam_search(port, ids, mask, max_new_tokens=5, num_beams=1),
                       tg.generate(port, ids, mask, max_new_tokens=5))
    timings = {}
    assert torch.equal(tg.beam_search(port, ids, mask, max_new_tokens=6, num_beams=1, eos_id=7, timings=timings),
                       tg.generate(port, ids, mask, max_new_tokens=6, eos_id=7))
    assert timings["prefill_s"] >= 0 and timings["decode_s"] >= 0


def test_beam_search_improves_sequence_logprob(causal):
    """tests/test_models.py:315: the W 4 beam scores at least greedy's sum
    of log-probabilities, on every row."""
    _, models = causal
    port = models[None][1]
    ids, mask = (torch.from_numpy(a) for a in _batch(3, 8, seed=19, pad=False))
    n_new = 5

    def seq_logprob(full):
        with torch.inference_mode():
            logp = torch.log_softmax(port(full[:, :-1].long(), torch.ones_like(full[:, :-1])).float(), dim=-1)
        return logp[:, 7:].gather(-1, full[:, 8:, None].long())[..., 0].sum(dim=1)

    greedy = seq_logprob(tg.generate(port, ids, mask, max_new_tokens=n_new))
    beam = seq_logprob(tg.beam_search(port, ids, mask, max_new_tokens=n_new, num_beams=4))
    assert bool((beam >= greedy - 1e-4).all()), (beam, greedy)


def test_beam_min_new_tokens_and_repetition_penalty(causal):
    """tests/test_generation_config.py:124 and :140: no beam emits eos
    before min_new_tokens; a huge penalty repeats no token of the prompt or
    of the continuation."""
    _, models = causal
    port = models[None][1]
    eos = ByteTokenizer().eos_id
    ids, mask = (torch.from_numpy(a) for a in _batch(2, 8, seed=1, pad=False))
    out = tg.beam_search(port, ids, mask, max_new_tokens=6, num_beams=3, eos_id=eos, min_new_tokens=4)
    assert not (out[:, 8:12] == eos).any()
    ids, mask = (torch.from_numpy(a) for a in _batch(2, 8, seed=2, pad=False))
    plain = tg.beam_search(port, ids, mask, max_new_tokens=8, num_beams=2)[:, 8:]
    pen = tg.beam_search(port, ids, mask, max_new_tokens=8, num_beams=2, repetition_penalty=8.0)[:, 8:]
    for r in range(2):
        toks = pen[r].tolist()
        assert len(set(toks)) == len(toks) and not set(toks) & set(ids[r].tolist())
    assert not torch.equal(plain, pen)


def test_reorder_cache_gathers_layer_by_layer(causal):
    """``_reorder_cache`` gathers every buffer by the beam index, replacing
    the list's tensors in place; with ``cols`` it moves those slots alone."""
    cfg, models = causal
    port = models[None][1]
    cache = make_cache(port.cfg, 4, 6, "cpu")
    gen = torch.Generator().manual_seed(0)
    for layer in cache:
        for buf in layer.values():
            buf.copy_(torch.randn(buf.shape, generator=gen))
    before = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    idx = torch.tensor([2, 2, 0, 3])
    tg._reorder_cache(cache, idx)
    for old, new in zip(before, cache):
        assert all(torch.equal(new[k], old[k][idx]) for k in old)
    tg._reorder_cache(cache, torch.tensor([1, 0, 3, 2]), slice(2, 4))
    for old, new in zip(before, cache):
        for k in old:
            want = old[k][idx].clone()
            want[:, 2:4] = old[k][idx][[1, 0, 3, 2], 2:4]
            assert torch.equal(new[k], want)


def _prompt_batches(tok, b=2, t=12):
    """tests/test_generation_config.py's eval batches, two of them."""
    rng = np.random.default_rng(0)
    for _ in range(2):
        ids = rng.integers(4, 260, (b, t)).astype(np.int32)
        mask = np.ones_like(ids)
        ids[0, :3] = tok.pad_id
        mask[0, :3] = 0
        yield {"input_ids": ids, "attention_mask": mask, "reference": ["a", "b"]}


@pytest.mark.parametrize("gen", [GenerationConfig(max_new_tokens=8, num_beams=3),
                                 GenerationConfig(max_new_tokens=8, speculative="ngram", draft_tokens=3),
                                 GenerationConfig(max_new_tokens=8)], ids=["beam3", "ngram", "greedy"])
def test_generative_eval_matches_jax(causal, tmp_path, gen):
    """Records, token count and the prediction file of the JAX function on
    the same batches."""
    cfg, models = causal
    params, port = models[None]
    jgen = jg.GenerationConfig(**dataclasses.asdict(gen))
    want = jgenerative_eval(params, cfg, JByteTokenizer(), _prompt_batches(JByteTokenizer()), gen_config=jgen,
                            log_dir=str(tmp_path / "jax"), epoch=1, run_name="beam")
    got = generative_eval(port, port.cfg, ByteTokenizer(), _prompt_batches(ByteTokenizer()), gen_config=gen,
                          log_dir=str(tmp_path / "port"), epoch=1, run_name="beam")
    assert got["n_examples"] == want["n_examples"] == 4
    assert got["records"] == want["records"] and all(set(r) == {"prompt", "prediction", "reference"}
                                                     for r in got["records"])
    assert got["gen_tokens_per_s"] > 0
    (jfile,), (pfile,) = (glob.glob(str(tmp_path / d / "log_dir_e1_beam_*.txt")) for d in ("jax", "port"))
    assert os.path.basename(pfile)[:len("log_dir_e1_beam_")] == "log_dir_e1_beam_"
    assert len(os.path.basename(pfile)) == len(os.path.basename(jfile))
    assert open(pfile).read() == open(jfile).read()
    assert "### prediction:" in open(pfile).read()


def test_generative_eval_counts_generated_tokens(causal, monkeypatch):
    """Tokens are counted without the pad / eos fill after a row stops."""
    from vietnamese_qa_system_tpu_torch.train import evaluate

    _, models = causal
    port = models[None][1]
    tok = ByteTokenizer()
    batch = next(_prompt_batches(tok))
    out = tg.generate(port, torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["attention_mask"]),
                      max_new_tokens=8, eos_id=tok.eos_id).numpy()[:, 12:]
    n = int(((out != tok.pad_id) & (out != tok.eos_id)).sum())
    assert 0 < n
    clock = iter([10.0, 12.0])
    monkeypatch.setattr(evaluate.time, "time", lambda: next(clock))
    res = generative_eval(port, port.cfg, tok, [batch], max_new_tokens=8)
    assert res["n_examples"] == 2 and res["gen_tokens_per_s"] == n / 2.0
    assert [set(r) for r in res["records"]] == [{"prompt", "prediction", "reference"}] * 2


@pytest.mark.parametrize("extra", [["--num-beams", "2"], ["--speculative", "ngram"]], ids=["beams", "ngram"])
def test_cli_train_generative_eval(tmp_path, extra):
    """``cli train --do-eval --do-generative-eval`` on the CPU: the
    predictions file under <log-dir>/predictions and gen_tokens_per_s in
    the run's log."""
    logs = tmp_path / "logs"
    argv = ["train", "--model-size", "tiny", "--train-files", SAMPLE, "--eval-files", SAMPLE, "--max-examples", "4",
            "--max-steps", "1", "--batch-size", "2", "--max-len", "256", "--log-every", "1", "--log-dir", str(logs),
            "--run-name", "gen", "--do-eval", "--do-generative-eval", "--max-new-tokens", "4", "--device", "cpu",
            *extra]
    assert cli_main(argv) == 0
    (pred,) = glob.glob(str(logs / "predictions" / "log_dir_e0_gen_*.txt"))
    text = open(pred).read()
    assert text.count("### prompt:") == text.count("### prediction:") >= 1
    logged = [json.loads(line) for line in open(logs / "gen.jsonl")]
    evals = [r for r in logged if "eval_gen_tokens_per_s" in r]
    assert len(evals) == 1 and evals[0]["eval_gen_tokens_per_s"] > 0 and "eval_perplexity" in evals[0]
