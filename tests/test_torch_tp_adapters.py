"""An adapter bank on the port's tensor-parallel causal reader
(``TPCausalLM`` at ``{"model": 4}``, ``lora.place_bank``): each split
part gathers its slice of the slot's factors on its device -- a column
part B's columns, a row part A's rows, its layer B whole -- against

- the unsharded port engine with the same bank, and JAX's engine with the
  same adapters over tp-sharded params on its virtual CPU mesh (the
  counterpart of JAX ``tests/test_continuous.py:270``), by the margin rule
  of test_torch_multilora.py (a step whose top-2 margin on the
  reference's stream is below 5e-2 may differ, and everything after it);
- speculative (``ngram``) chunks and the int8 KV cache with the bank;
- the prefix cache keyed by (tokens, adapter) with its entries one dict a
  (layer, device);
- ``serve --reader-strategy tp --adapter NAME=PATH`` over HTTP.

Two families: GQA with RoPE and SwiGLU (8 query heads over 2 kv heads: a
device's 2 query heads in one kv group), and PhoGPT's MPT layout (ALiBi,
tied head, biases)."""

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

from test_torch_multilora import _adapter
from vietnamese_qa_system_tpu.core.mesh import create_mesh as jcreate_mesh
from vietnamese_qa_system_tpu.engine.continuous import ContinuousEngine as JEngine
from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.parallel import sharding as jsharding
from vietnamese_qa_system_tpu_torch.core.mesh import create_mesh
from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine
from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, adapter_from_jax, causal_from_jax,
                                                   place_bank, select_adapters, stack_adapters)
from vietnamese_qa_system_tpu_torch.models import layers as tl
from vietnamese_qa_system_tpu_torch.models.causal_lm import TPCausalLM
from vietnamese_qa_system_tpu_torch.parallel import sharding as tsharding
from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180
MARGIN_TOL = 5e-2  # test_torch_multilora.py's: the adapters' corrections round to bf16 before B
N_TP = 4
LORA = dict(r=4, alpha=8)
SMALL = dict(vocab_size=97, n_layers=2, max_seq_len=256)
FAMILIES = {
    "llama": dataclasses.replace(jc.llama_1b_class(), d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
                                 use_flash_attention=False, **SMALL),
    "mpt": dataclasses.replace(jc.phogpt_4b_class(), d_model=64, n_heads=8, d_ff=128, **SMALL),
}
NAMES = (None, "vi", "math", "law")


@pytest.fixture(scope="module")
def models():
    """family -> (JAX params, JAX config, port model, TP model, JAX tp
    params, JAX adapters, the port's copies)."""
    cache = {}

    def get(family):
        if family not in cache:
            cfg = FAMILIES[family]
            params = jlm.init_causal_lm(jax.random.key(17), cfg)
            if jlm.blocks_stacked(params):
                params = jlm.unstack_blocks(params, cfg.n_layers)
            params = jax.tree.map(np.asarray, params)
            port = causal_from_jax(params, ModelConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
            tp = tsharding.shard_params(port, create_mesh({"model": N_TP}, devices=["cpu"] * N_TP), "tp")
            jtp = jsharding.shard_params(params, jsharding.param_sharding(params, jcreate_mesh({"model": N_TP}),
                                                                          strategy="tp"))
            ads = [_adapter(params, seed) for seed in (1, 2, 3)]
            cache[family] = params, cfg, port, tp, jtp, ads, [adapter_from_jax(a, device="cpu") for a in ads]
        return cache[family]

    return get


def _prompt(rng, n):
    return [int(x) for x in rng.integers(4, 90, (n,))]


def _margins(port, bank, ix, prompt, stream, kv_dtype="bf16"):
    """Top-2 logit margins of the unsharded port under bank adapter ``ix``
    at each step of ``stream``: one cached pass over prompt + stream."""
    seq = torch.tensor([list(prompt) + list(stream[:-1])])
    n = seq.shape[1]
    cache = port.make_cache(1, n, kv_dtype)
    with torch.no_grad(), tl.row_adapters(select_adapters(port, bank, torch.tensor([ix]))):
        h = port.hidden_states(seq, torch.tril(torch.ones((1, n, n), dtype=torch.bool)),
                               positions=torch.arange(n)[None], cache=cache, cache_index=0)
        logits = port.head(h)[0, len(prompt) - 1:]
    top2 = torch.topk(logits, 2).values
    return (top2[:, 0] - top2[:, 1]).numpy()


def _assert_margin_rule(got, want, port, bank, ix, prompt, kv_dtype="bf16"):
    if got == want:
        return
    m = _margins(port, bank, ix, prompt, want, kv_dtype)
    ties = np.nonzero(m < MARGIN_TOL)[0]
    until = int(ties[0]) if len(ties) else len(want)
    assert got[:until] == want[:until] and until < len(want), (ix, got, want)


def _streams(eng, prompts, names, max_new=14):
    futs = [eng.submit(p, max_new, adapter=a) for p, a in zip(prompts, names)]
    return [f.result(timeout=TIMEOUT)["ids"] for f in futs]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_bank_engine_matches_unsharded_and_jax(models, family):
    """Base and three adapters share the decode batch of the TP engine
    (plain chunks): every stream equals the unsharded port engine's with
    the same bank and JAX's engine over tp-sharded params with the same
    adapters, by the margin rule."""
    params, cfg, port, tp, jtp, ads, tads = models(family)
    lc = jlora.LoraConfig(**LORA)
    bank = stack_adapters(tads, LoraConfig(**LORA))
    rng = np.random.default_rng(5)
    prompts = [_prompt(rng, n) for n in (10, 12, 9, 14, 11, 7)]
    names = [NAMES[j % 4] for j in range(len(prompts))]
    kw = dict(n_slots=3, total=64, buckets=(16,), chunk_steps=4, speculative="off")
    jeng = JEngine(jtp, cfg, adapters=dict(zip(NAMES[1:], ads)), lora_config=lc, **kw)
    engines = [ContinuousEngine(m, m.cfg, adapters=dict(zip(NAMES[1:], tads)), lora_config=LoraConfig(**LORA),
                                device="cpu", **kw) for m in (tp, port)]
    try:
        want = _streams(jeng, prompts, names)
        got_tp, got = (_streams(eng, prompts, names) for eng in engines)
    finally:
        jeng.close()
        for eng in engines:
            eng.close()
    for p, a, g_tp, g, w in zip(prompts, names, got_tp, got, want):
        ix = NAMES.index(a)
        _assert_margin_rule(g_tp, w, port, bank, ix, p)
        _assert_margin_rule(g, w, port, bank, ix, p)
        _assert_margin_rule(g_tp, g, port, bank, ix, p)
    assert got_tp[1] != _streams_base(tp, prompts[1])  # the adapter changes the stream


def _streams_base(model, prompt):
    eng = ContinuousEngine(model, model.cfg, n_slots=1, total=64, buckets=(16,), chunk_steps=4, speculative="off",
                           device="cpu")
    try:
        return eng.generate_ids(prompt, 14, timeout=TIMEOUT)
    finally:
        eng.close()


@pytest.mark.parametrize("spec,kv_dtype", [("ngram", "bf16"), ("off", "int8"), ("ngram", "int8")])
def test_tp_bank_speculative_and_int8(models, spec, kv_dtype):
    """Speculative chunks and the int8 KV cache with the bank over the TP
    reader give the unsharded engine's streams under the same settings, by
    the margin rule on the unsharded port (its cache in ``kv_dtype``);
    speculative chunks ran and accepted drafts."""
    _, _, port, tp, _, _, tads = models("mpt")
    bank = stack_adapters(tads, LoraConfig(**LORA))
    rng = np.random.default_rng(7)
    # repeated n-grams, so prompt lookup drafts hit
    base = _prompt(rng, 5)
    prompts = [(base * 3)[:n] for n in (12, 15, 11, 13)]
    kw = dict(n_slots=4, total=64, buckets=(16,), chunk_steps=4, speculative=spec, draft_tokens=4, draft_ngram=2,
              spec_steps=2, kv_dtype=kv_dtype, adapters=dict(zip(NAMES[1:], tads)), lora_config=LoraConfig(**LORA),
              device="cpu")
    engines = [ContinuousEngine(m, m.cfg, **kw) for m in (tp, port)]
    try:
        got_tp, got = (_streams(eng, prompts, NAMES, max_new=16) for eng in engines)
        stats = engines[0].snapshot_stats()
    finally:
        for eng in engines:
            eng.close()
    for p, a, g_tp, g in zip(prompts, NAMES, got_tp, got):
        _assert_margin_rule(g_tp, g, port, bank, NAMES.index(a), p, kv_dtype)
    if spec == "ngram":
        assert stats["spec_chunks"] > 0 and stats["drafted_accepted"] > 0


def test_tp_bank_placement_and_prefix_cache(models):
    """The placed bank (one entry a split part and a row-parallel layer,
    each on its device), and the prefix cache over the TP reader: a stored
    prompt serves a later request of the same adapter only, its KV one
    dict a (layer, device), and the hit's stream equals a cold prefill's."""
    _, cfg, port, tp, _, _, tads = models("llama")
    bank = stack_adapters(tads, LoraConfig(**LORA))
    placed = place_bank(tp, bank)
    attn = tp.blocks[0].attn
    assert all(placed[p.wq][1].shape == (4, LORA["r"], p.wq.shape[1]) for p in attn.parts)
    assert all(placed[p.wo][0].shape == (4, p.wo.shape[0], LORA["r"]) and placed[p.wo][1] is None
               for p in attn.parts)
    flat = flatten_paths(bank)
    assert placed[attn][0] is None and torch.equal(placed[attn][1], flat["blocks.0.attn.wo.b"])
    # six targets a layer (q, k, v, o; the MLP's wi and wo), each a part a device, plus the two row-parallel layers
    assert len(place_bank(port, bank)) == 6 * cfg.n_layers and len(placed) == (6 * N_TP + 2) * cfg.n_layers
    ix = torch.tensor([2, 0, 3])
    sel = select_adapters(tp, placed, ix)
    assert torch.equal(sel[attn.parts[1].wq][1], flat["blocks.0.attn.wq.b"][ix][:, :, 16:32])
    assert torch.equal(sel[attn.parts[1].wo][0], flat["blocks.0.attn.wo.a"][ix][:, 16:32])
    kw = dict(n_slots=2, total=128, buckets=(16, 32), adapters=dict(zip(NAMES[1:], tads)),
              lora_config=LoraConfig(**LORA), device="cpu", speculative="off")
    eng = ContinuousEngine(tp, tp.cfg, prefix_cache_mb=4, min_cached_prompt=8, **kw)
    cold = ContinuousEngine(tp, tp.cfg, **kw)
    try:
        rng = np.random.default_rng(8)
        prefix = _prompt(rng, 12)
        longer = prefix + _prompt(rng, 6)
        eng.submit(prefix, 4, adapter="vi").result(timeout=TIMEOUT)
        entry = next(iter(eng._pcache._entries.values()))["kv"]
        assert len(entry) == cfg.n_layers * N_TP and entry[0]["k"].shape[2] == 1  # a kv head a device pair
        out_math = eng.submit(longer, 8, adapter="math").result(timeout=TIMEOUT)["ids"]
        assert eng.snapshot_stats()["prefix_hits"] == 0  # another adapter: no hit
        out_vi = eng.submit(longer, 8, adapter="vi").result(timeout=TIMEOUT)["ids"]
        assert eng.snapshot_stats()["prefix_hits"] == 1
        assert out_vi == cold.submit(longer, 8, adapter="vi").result(timeout=TIMEOUT)["ids"]
        assert out_math == cold.submit(longer, 8, adapter="math").result(timeout=TIMEOUT)["ids"]
        assert out_vi != out_math
    finally:
        eng.close()
        cold.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def test_serve_reader_strategy_with_adapter(tmp_path):
    """``serve --reader-strategy tp --adapter vi=PATH --continuous-slots 2
    --device cpu`` in a subprocess: the bank loads over the TP reader,
    POST /generate answers under the adapter and the base, /healthz lists
    the adapter."""
    from vietnamese_qa_system_tpu_torch.cli import main as cli
    from vietnamese_qa_system_tpu_torch.cli.main import _reader
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.models import init_lora
    from vietnamese_qa_system_tpu_torch.train.checkpoint import save_pytree
    from vietnamese_qa_system_tpu_torch.utils.tree import tree_map

    reader = _reader("tiny", ByteTokenizer(), 1, torch.device("cpu"), None)
    draw = torch.Generator().manual_seed(4)
    adapter = tree_map(lambda t: torch.randn(t.shape, generator=draw) * 0.3,
                       init_lora(torch.Generator().manual_seed(3), reader, LoraConfig()))
    save_pytree(str(tmp_path / "adapter.npz"), adapter)
    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": f"tài liệu {i}"}, ensure_ascii=False) for i in range(4)),
                    encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--batch-size", "4",
                "--max-len", "48"]) == 0
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "vietnamese_qa_system_tpu_torch.cli", "serve", "--index", idx,
                             "--db", db, "--device", "cpu", "--port", "0", "--max-len", "48", "--reader-size", "tiny",
                             "--reader-strategy", "tp", "--continuous-slots", "2", "--gen-total", "128",
                             "--max-new-tokens", "4", "--adapter", f"vi={tmp_path / 'adapter.npz'}"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("serving "):
                break
        assert any("reader sharded: strategy=tp over 4 devices" in x for x in lines), lines
        assert any("adapters loaded: ['vi']" in x for x in lines), lines
        url = "http://" + line.split("http://", 1)[1].split(" ", 1)[0]
        outs = [_post(f"{url}/generate", {"prompt": "xin chào Hà Nội", "max_new_tokens": 4, **kw})
                for kw in ({"adapter": "vi"}, {})]
        assert all(1 <= o["n_new"] <= 4 for o in outs)
        with urllib.request.urlopen(f"{url}/healthz", timeout=TIMEOUT) as resp:
            assert json.loads(resp.read())["stats"]["generate"]["adapters"] == ["vi"]
    finally:
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, out
    assert isinstance(tsharding.shard_params(reader, create_mesh({"model": 2}, devices=["cpu"] * 2)), TPCausalLM)
