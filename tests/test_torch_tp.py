"""The port's tensor-parallel reader against the JAX package's tp-sharded
one on the CPU: ``param_sharding`` specs leaf for leaf (tp and fsdp_tp,
llama / gpt2 / MPT tiny configs, meshes of 4 and 3), greedy ``generate``
and the continuous engine at ``{"model": 4}`` against the unsharded port
and JAX's tp-sharded run (the counterparts of ``__graft_entry__.py``'s
phase 3 and JAX ``tests/test_continuous.py::
test_engine_under_tensor_parallel_sharding``), the decode strategies over
the split cache, placement and refusals, and ``serve --reader-strategy``.

The port's meshes repeat the CPU device; the JAX side runs on its virtual
8-device mesh.  Streams are compared by the margin rule of
test_torch_generate.py / test_torch_continuous.py (tokens equal until the
first JAX step whose top-2 logit margin is below 2e-2): row-parallel sums
add the same f32 products in another order."""

import dataclasses
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

from test_torch_continuous import TIMEOUT, _prompt, assert_margin_rule
from test_torch_generate import _assert_margin_rule, _prompts
from vietnamese_qa_system_tpu.core.mesh import create_mesh as jcreate_mesh
from vietnamese_qa_system_tpu.engine.continuous import ContinuousEngine as JEngine
from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.parallel import sharding as jsharding
from vietnamese_qa_system_tpu_torch.cli import main as cli
from vietnamese_qa_system_tpu_torch.cli.main import _reader, _sharded_reader, build_parser, continuous_engine
from vietnamese_qa_system_tpu_torch.core.mesh import create_mesh
from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine
from vietnamese_qa_system_tpu_torch.models import LoraConfig, ModelConfig, causal_from_jax, init_causal_lm, init_lora
from vietnamese_qa_system_tpu_torch.models import generate as tg
from vietnamese_qa_system_tpu_torch.models import layers as tlayers
from vietnamese_qa_system_tpu_torch.models.causal_lm import TPCausalLM
from vietnamese_qa_system_tpu_torch.models.layers import head_groups
from vietnamese_qa_system_tpu_torch.parallel import sharding as tsharding

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=512, n_layers=2, max_seq_len=256)
FAMILIES = {
    # tied head, learned positions, biases
    "gpt2": dataclasses.replace(jc.gpt_125m_class(), d_model=64, n_heads=8, d_ff=128, **SMALL),
    # GQA (8 query heads over 2 kv heads: a device's 2 query heads sit in one kv group), RoPE, SwiGLU
    "llama": dataclasses.replace(jc.llama_1b_class(), d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
                                 use_flash_attention=False, **SMALL),
    # PhoGPT's MPT layout: ALiBi (MPT slopes, sliced per device), tied head, the flash route
    "mpt": dataclasses.replace(jc.phogpt_4b_class(), d_model=64, n_heads=8, d_ff=128, **SMALL),
}
N_TP = 4


@pytest.fixture(scope="module")
def models():
    """family -> (JAX params, JAX config, port model, port TP model, JAX tp params)."""
    cache = {}

    def get(family):
        if family not in cache:
            cfg = FAMILIES[family]
            params = jlm.init_causal_lm(jax.random.key(11), cfg)
            if jlm.blocks_stacked(params):
                params = jlm.unstack_blocks(params, cfg.n_layers)
            port = causal_from_jax(jax.tree.map(np.asarray, params), ModelConfig.from_dict(dataclasses.asdict(cfg)),
                                   device="cpu")
            tp = tsharding.shard_params(port, create_mesh({"model": N_TP}, devices=["cpu"] * N_TP), "tp")
            jmesh = jcreate_mesh({"model": N_TP})
            jtp = jsharding.shard_params(params, jsharding.param_sharding(params, jmesh, strategy="tp"))
            cache[family] = params, cfg, port, tp, jtp
        return cache[family]

    return get


def _jax_specs(params, mesh, strategy):
    out = {}
    for path, ns in jax.tree_util.tree_flatten_with_path(jsharding.param_sharding(params, mesh, strategy))[0]:
        leaf = params
        for p in path:
            leaf = leaf[p.key if hasattr(p, "key") else p.idx]
        spec = tuple(ns.spec)
        out[jsharding._path_str(path)] = spec + (None,) * (len(leaf.shape) - len(spec))
    return out


@pytest.mark.parametrize("n", [4, 3])
@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_sharding_matches_jax(models, family, strategy, n):
    """Every leaf's spec equals JAX's for the same path (at {"model": 3}
    the vocabulary, d_model and most widths do not divide: those stay
    whole); with no data axis fsdp_tp places like tp."""
    params, _, port, _, _ = models(family)
    want = _jax_specs(params, jcreate_mesh({"model": n}), strategy)
    got = {tsharding.param_path(k): v for k, v in
           tsharding.param_sharding(port, create_mesh({"model": n}, devices=["cpu"] * n), strategy).items()}
    assert got == want
    assert any("model" in spec for spec in got.values()) == (n == 4)  # 64, 128, 512: none divides by 3
    tp = tsharding.param_sharding(port, create_mesh({"model": n}, devices=["cpu"] * n), "tp")
    assert {tsharding.param_path(k): v for k, v in tp.items()} == got


def test_fsdp_specs_on_a_data_axis_match_jax(models):
    """fsdp / fsdp_tp fill the largest divisible replicated dim with the
    data axis, as JAX's ``_auto_fsdp_spec`` does."""
    params, _, port, _, _ = models("llama")
    for strategy in ("fsdp", "fsdp_tp", "dp"):
        want = _jax_specs(params, jcreate_mesh({"data": 2, "model": 4}), strategy)
        got = tsharding.param_sharding(port, create_mesh({"data": 2, "model": 4}, devices=["cpu"] * 8), strategy)
        assert {tsharding.param_path(k): v for k, v in got.items()} == want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_generate_matches_unsharded_and_jax(models, family):
    """Greedy generate over the TP reader (left-padded prompts, ALiBi /
    GQA / RoPE) against the unsharded port and JAX's tp-sharded generate."""
    params, cfg, port, tp, jtp = models(family)
    ids, mask = _prompts(3, b=4, t=16)
    want = np.asarray(jg.generate(jtp, cfg, ids, mask, max_new_tokens=10))
    got_tp = tg.generate(tp, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=10).numpy()
    got = tg.generate(port, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=10).numpy()
    _assert_margin_rule(got_tp, want, mask, params, cfg)
    _assert_margin_rule(got, want, mask, params, cfg)
    with torch.no_grad():
        x = torch.from_numpy(ids).long()
        np.testing.assert_allclose(tp(x).numpy(), port(x).numpy(), rtol=0, atol=1e-4)


def _engine_streams(models, family, monkeypatch, kv_dtype):
    """Three prompts through JAX's engine over tp-sharded params, the port's
    engine over the TP reader and over the unsharded one, each held to
    JAX's streams by the margin rule.  Returns the query heads of every
    flash call made by the TP engine and by the unsharded one."""
    params, cfg, port, tp, jtp = models(family)
    calls = []
    flash = tlayers.flash_attention
    monkeypatch.setattr(tlayers, "flash_attention", lambda *a, **k: calls.append(a[0].shape[2]) or flash(*a, **k))
    rng = np.random.default_rng(29)
    prompts = [_prompt(rng, n) for n in (9, 14, 11)]
    kw = dict(n_slots=2, total=64, buckets=(16,), chunk_steps=4, kv_dtype=kv_dtype)
    engines = [JEngine(jtp, cfg, **kw), ContinuousEngine(tp, tp.cfg, device="cpu", **kw),
               ContinuousEngine(port, port.cfg, device="cpu", **kw)]
    try:
        want = [engines[0].generate_ids(p, 12) for p in prompts]
        got_tp = [engines[1].generate_ids(p, 12, timeout=TIMEOUT) for p in prompts]
        n_tp = len(calls)
        got = [engines[2].generate_ids(p, 12, timeout=TIMEOUT) for p in prompts]
    finally:
        for eng in engines:
            eng.close()
    model = (params, cfg, port)
    for p, g, gt, w in zip(prompts, got, got_tp, want):
        assert_margin_rule(gt, w, model, p)
        assert_margin_rule(g, w, model, p)
    return calls[:n_tp], calls[n_tp:]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_engine_matches_unsharded_and_jax(models, family, monkeypatch):
    """The continuous engine over the TP reader (per-device caches,
    cursors on the lead device): its streams equal the unsharded port
    engine's and JAX's engine over tp-sharded params.  Either reader's
    prefill attends through the cache, as JAX's engine does: no flash
    call, even where use_flash_attention is set."""
    assert _engine_streams(models, family, monkeypatch, "bf16") == ([], [])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_int8_engine_matches_unsharded_and_jax(models, family, monkeypatch):
    """The same with an int8 KV cache: each engine's prefill and steps
    attend the cache's codes, as JAX's int8 engine does."""
    assert _engine_streams(models, family, monkeypatch, "int8") == ([], [])


def test_tp_decode_strategies_over_the_split_cache(models):
    """Prompt-lookup speculation, beams (the cache reordered on every
    device) and an int8 KV cache over the TP reader give the unsharded
    reader's tokens."""
    _, _, port, tp, _ = models("mpt")
    ids, mask = (torch.from_numpy(a) for a in _prompts(5, b=3, t=12))
    plain = tg.generate(tp, ids, mask, max_new_tokens=12)
    assert torch.equal(tg.generate_speculative(tp, ids, mask, max_new_tokens=12, draft_tokens=4, draft_ngram=2), plain)
    assert torch.equal(tg.beam_search(tp, ids, mask, max_new_tokens=6, num_beams=3),
                       tg.beam_search(port, ids, mask, max_new_tokens=6, num_beams=3))
    assert torch.equal(tg.generate(tp, ids, mask, max_new_tokens=8, kv_dtype="int8"),
                       tg.generate(port, ids, mask, max_new_tokens=8, kv_dtype="int8"))


def test_placement_and_refusals(models):
    """Head groups, the split cache's layout, the parts kept whole where an
    axis does not divide, an adapter bank laid onto the parts, and what
    shard_params refuses."""
    assert head_groups(8, 8, 4) == [(0, 2, 0, 2), (2, 4, 2, 4), (4, 6, 4, 6), (6, 8, 6, 8)]
    assert head_groups(8, 2, 4) == [(0, 2, 0, 1), (2, 4, 0, 1), (4, 6, 1, 2), (6, 8, 1, 2)]  # a kv head a pair
    assert head_groups(8, 4, 2) == [(0, 4, 0, 2), (4, 8, 2, 4)]
    assert head_groups(6, 6, 4) is None and head_groups(12, 6, 4) is None  # 3 query heads span two kv groups
    _, cfg, port, tp, _ = models("llama")
    cache = tp.make_cache(2, 16)
    assert len(cache) == cfg.n_layers * N_TP and cache[0]["k"].shape == (2, 16, 1, cfg.head_dim)
    assert tp.layer_cache(cache, 1) == cache[N_TP:2 * N_TP]
    assert len(tp.blocks[0].mlp.parts) == N_TP and tp.head_parts is not None  # llama's untied head splits
    six = dataclasses.replace(ModelConfig.from_dict(dataclasses.asdict(FAMILIES["mpt"])), n_heads=6, d_model=48,
                              d_ff=96)
    model = init_causal_lm(six, torch.Generator().manual_seed(0))
    mesh = create_mesh({"model": 4}, devices=["cpu"] * 4)
    whole = tsharding.shard_params(model, mesh, "fsdp_tp")
    assert whole.groups is None and isinstance(whole.blocks[0].attn, tlayers.Attention)  # 6 heads over 4: whole
    assert isinstance(whole.blocks[0].mlp, tlayers.TPMLP) and whole.embed_parts is not None
    assert len(whole.make_cache(1, 8)) == six.n_layers
    ids, mask = (torch.from_numpy(a) for a in _prompts(7, b=2, t=10))
    assert torch.equal(tg.generate(whole, ids, mask, max_new_tokens=6), tg.generate(model, ids, mask,
                                                                                    max_new_tokens=6))
    with pytest.raises(NotImplementedError, match="training"):
        tsharding.shard_params(port, mesh, "fsdp")
    with pytest.raises(NotImplementedError, match="data axis"):
        tsharding.shard_params(port, create_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4), "fsdp_tp")
    with pytest.raises(ValueError, match="unsharded causal reader"):
        tsharding.shard_params(tp, mesh, "tp")
    # the whole classifier, gathered from the vocabulary parts
    assert torch.equal(tp.head_weight(), port.head_weight())
    # the engine takes an adapter bank over the TP reader: each split part holds its slice on its device
    adapter = init_lora(torch.Generator().manual_seed(3), port, LoraConfig(r=4, alpha=8))
    engine = ContinuousEngine(tp, tp.cfg, device="cpu", adapters={"a": adapter}, lora_config=LoraConfig(r=4, alpha=8),
                              n_slots=2, total=64, buckets=(16,))
    try:
        assert engine.adapter_names == ["a"]
        part = tp.blocks[0].attn.parts[1]
        a_o, b_o = engine._bank[part.wo]
        assert b_o is None and a_o.shape == (2, part.wo.shape[0], 4)  # a row part: A's rows, B on its layer
        assert engine._bank[tp.blocks[0].attn][1].shape == (2, 4, cfg.d_model)
        assert engine._bank[part.wq][1].shape == (2, 4, part.wq.shape[1])  # a column part: B's columns
        assert len(engine.generate_ids(list(range(3, 12)), 4, timeout=TIMEOUT)) == 4
    finally:
        engine.close()
    quant = init_causal_lm(dataclasses.replace(six, n_heads=8, d_model=64, d_ff=128),
                           torch.Generator().manual_seed(0), quantize="int8c")
    with pytest.raises(ValueError, match="plain bf16 readers"):
        tsharding.shard_params(quant, mesh, "tp")
    assert isinstance(tsharding.shard_params(port, mesh, "fsdp_tp"), TPCausalLM)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_split_parts_own_their_storage(models, family):
    """Every split part (heads, MLP hidden, vocabulary rows, head columns)
    is a copy with storage of its own, never a view of its source weight:
    on the source's device (the lead) a view of a row range would keep the
    whole weight alive once the source reader is dropped."""
    _, _, port, tp, _ = models(family)
    source = {p.untyped_storage().data_ptr() for p in port.parameters()}
    parts = [p for blk in tp.blocks for mod in (blk.attn, blk.mlp) if hasattr(mod, "parts")
             for p in mod.parts.parameters()]
    for split in (tp.embed_parts, tp.head_parts):
        parts += [] if split is None else list(split.parameters())
    assert parts and not any(p.untyped_storage().data_ptr() in source for p in parts)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def test_serve_reader_strategy_cli(tmp_path, monkeypatch, capsys):
    """``serve --reader-strategy tp|fsdp_tp --device cpu`` (a mesh of
    ``CPU_MESH_DEVICES`` = 4 repeats of the host): the REPL answers
    /qa-style; ``--port`` in a subprocess answers POST /qa and /generate;
    a quantized reader is refused; ``--adapter`` builds /generate's engine
    with its bank over the TP reader."""
    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": f"tài liệu số {i} về Hà Nội"}, ensure_ascii=False)
                              for i in range(6)), encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--batch-size", "8",
                "--max-len", "48", "--shards", "2"]) == 0
    serve = ["serve", "--index", idx, "--db", db, "--device", "cpu", "--max-len", "48", "--reader-size", "tiny",
             "--max-new-tokens", "3"]
    for strategy in ("tp", "fsdp_tp"):
        queries = iter(["Hà Nội", ""])
        monkeypatch.setattr("builtins.input", lambda prompt="": next(queries))
        assert cli(serve + ["--reader-strategy", strategy]) == 0
        out = capsys.readouterr().out
        assert f"reader sharded: strategy={strategy} over 4 devices" in out and "answer" in out
    with pytest.raises(SystemExit, match="plain bf16 readers"):
        cli(serve + ["--reader-strategy", "tp", "--reader-quantize", "int8c"])
    # --adapter beside --reader-strategy: /generate's engine serves the bank over the TP reader
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.train.checkpoint import save_pytree

    tok = ByteTokenizer()
    reader = _reader("tiny", tok, 1, torch.device("cpu"), None)
    save_pytree(str(tmp_path / "adapter.npz"), init_lora(torch.Generator().manual_seed(5), reader, LoraConfig()))
    args = build_parser().parse_args(serve + ["--reader-strategy", "tp", "--adapter",
                                                       f"vi={tmp_path / 'adapter.npz'}", "--continuous-slots", "2",
                                                       "--gen-total", "128"])
    engine = continuous_engine(args, _sharded_reader(args, reader, torch.device("cpu")), tok, "cpu")
    try:
        assert engine.adapter_names == ["vi"] and isinstance(engine.model, TPCausalLM)
        assert len(engine.submit(tok.encode("xin chào"), 3, adapter="vi").result(timeout=TIMEOUT)["ids"]) == 3
    finally:
        engine.close()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "vietnamese_qa_system_tpu_torch.cli", *serve, "--port", "0",
                             "--reader-strategy", "tp", "--continuous-slots", "2",
                             "--gen-total", "128", "--gen-chunk-steps", "4"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("serving "):
                break
        assert "/qa" in line and "/generate" in line
        assert any("reader sharded: strategy=tp over 4 devices" in x for x in lines)
        url = "http://" + line.split("http://", 1)[1].split(" ", 1)[0]
        qa = _post(f"{url}/qa", {"question": "Hà Nội"})
        assert "answer" in qa
        out = _post(f"{url}/generate", {"prompt": "xin chào", "max_new_tokens": 4})
        assert 1 <= out["n_new"] <= 4
    finally:
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, out
