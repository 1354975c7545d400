"""Parity of the port's multi-LoRA serving with the JAX package
(``models/lora.py`` ``stack_adapters`` / ``select_adapters``, the
continuous engine's ``adapters=``, ``/generate``'s ``"adapter"``, ``serve
--adapter``) on the same weights and numpy adapters, on the CPU.

Tolerances: the bank and the gathered factors are bit-equal (f32 stacks,
``b`` times a power-of-two alpha / r); logits as tests/test_torch_causal.py
(max abs 2e-2, mean abs 1e-3); a bank-selected row against ``merge_lora``
of its adapter within 5e-2 relative / 0.3 absolute, the JAX test's bound
(test_multilora.py:78: the merged weight adds a full-rank delta rounded to
bf16, the bank applies the rank-r factors lazily); engine streams against
the JAX engine's by the top-2 margin rule (MARGIN_TOL 5e-2 of the JAX
model with that adapter attached).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.engine.continuous import ContinuousEngine as JEngine
from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import config as jc
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models import quantize as jq
from vietnamese_qa_system_tpu.train.checkpoint import save_pytree as jsave
from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine, ServingApp, make_server
from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, adapter_from_jax, causal_from_jax,
                                                   clear_lora, load_adapter, merge_lora, select_adapters,
                                                   stack_adapters)
from vietnamese_qa_system_tpu_torch.models import generate as tg
from vietnamese_qa_system_tpu_torch.models import layers as tl
from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths, tree_leaves

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
MAX_TOL, MEAN_TOL, MARGIN_TOL = 2e-2, 1e-3, 5e-2
BASE = dict(arch="causal", vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=256)
LORA = dict(r=4, alpha=8)


def _adapter(params, seed):
    """init_lora, then every leaf random: a zero B would equal the base."""
    ad = jlora.init_lora(jax.random.key(seed), params, jlora.LoraConfig(**LORA))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32), ad)


@pytest.fixture(scope="module", params=[None, "int8c", "nf4"])
def setup(request):
    """(JAX params, JAX config, the port's model, two JAX adapters, the
    port's copies) over a float, int8c or nf4 base."""
    cfg = jc.ModelConfig(**BASE)
    params = jlm.init_causal_lm(jax.random.key(0), cfg)
    if request.param:
        params = jq.quantize_dense_tree(params, request.param)
    params = jax.tree.map(np.asarray, params)
    port = causal_from_jax(params, ModelConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    ads = [_adapter(params, 1), _adapter(params, 2)]
    return params, cfg, port, ads, [adapter_from_jax(a, device="cpu") for a in ads]


def _pad(prompt, width):
    ids = np.zeros((1, width), np.int32)
    mask = np.zeros((1, width), np.int32)
    ids[0, width - len(prompt):] = prompt
    mask[0, width - len(prompt):] = 1
    return ids, mask


def _prompt(rng, n):
    return [int(x) for x in rng.integers(4, 90, (n,))]


def test_bank_and_selection_match_jax(setup):
    params, cfg, port, ads, tads = setup
    lc = jlora.LoraConfig(**LORA)
    jbank = jlora.stack_adapters([jax.tree.map(jnp.asarray, a) for a in ads], lc)
    bank = stack_adapters(tads, LoraConfig(**LORA))
    want = flatten_paths(jax.tree.map(np.asarray, jbank))
    got = flatten_paths(bank)
    assert sorted(got) == sorted(want) and not any(t.requires_grad for t in got.values())
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
        assert not leaf[0].any()  # index 0: the zero adapter
    idx = np.array([2, 0, 1, 2], np.int32)
    jsel = jlora.select_adapters(params, jbank, jnp.asarray(idx))
    factors = select_adapters(port, bank, torch.from_numpy(idx).long())
    assert len(factors) == len(want) // 2
    for dense, (a, b) in factors.items():
        name = next(n for n, m in port.named_modules() if m is dense)
        node = jsel
        for part in name.split("."):
            node = node[int(part)] if part.isdigit() else node[part]
        np.testing.assert_array_equal(a.numpy(), np.asarray(node["lora_a"]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(node["lora_b"]))


def _close(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= MAX_TOL and diff.mean() <= MEAN_TOL, (diff.max(), diff.mean())


def test_selected_matches_jax_and_merged_logits(setup):
    """Rows under bank indices [0, 1, 2]: the JAX selected forward's logits,
    the base's on row 0, and each adapter merged (test_multilora.py:78)."""
    params, cfg, port, ads, tads = setup
    lc = jlora.LoraConfig(**LORA)
    jbank = jlora.stack_adapters([jax.tree.map(jnp.asarray, a) for a in ads], lc)
    bank = stack_adapters(tads, LoraConfig(**LORA))
    ids, mask = _pad(_prompt(np.random.default_rng(0), 12), 16)
    ids3, mask3 = np.tile(ids, (3, 1)), np.tile(mask, (3, 1))
    want = np.asarray(jlm.forward(jlora.select_adapters(params, jbank, jnp.asarray([0, 1, 2])), cfg,
                                  jnp.asarray(ids3), jnp.asarray(mask3)))
    with torch.no_grad(), tl.row_adapters(select_adapters(port, bank, torch.tensor([0, 1, 2]))):
        got = port(torch.from_numpy(ids3).long(), torch.from_numpy(mask3)).numpy()
    _close(got, want)
    with torch.no_grad():
        base = port(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[0], base[0], rtol=0, atol=1e-5)
    merged = []
    for tad in tads:
        with torch.no_grad():
            merge_lora(port, tad, LoraConfig(**LORA))
            merged.append(port(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy())
            clear_lora(port)
    for row, ref in ((1, merged[0]), (2, merged[1])):
        np.testing.assert_allclose(got[row], ref[0], rtol=5e-2, atol=0.3)
    assert not np.allclose(merged[0][0], base[0], atol=0.1)  # the adapters change the function


@pytest.fixture
def engines():
    made = []

    def make(kind, *args, **kw):
        eng = (JEngine if kind == "jax" else ContinuousEngine)(*args, **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.close()


def _jax_margins(params, bank, ix, cfg, prompt, stream):
    p = jlora.select_adapters(params, bank, jnp.int32(ix))
    seq = list(prompt) + list(stream[:-1])
    n = len(seq)
    cache = jg._make_cache(cfg, 1, n, cfg.n_layers)
    logits, _ = jlm.forward(p, cfg, jnp.asarray([seq], jnp.int32), jnp.tril(jnp.ones((1, n, n), jnp.bool_)),
                            positions=jnp.arange(n)[None], cache=cache, cache_index=0)
    top2 = jax.lax.top_k(logits[0, len(prompt) - 1:], 2)[0]
    return np.asarray(top2[:, 0] - top2[:, 1])


def test_engine_streams_match_jax_engine(setup, engines):
    """Base / adapter 1 / adapter 2 requests share the decode batch (plain
    chunks, and n-gram speculative chunks): each stream equals the JAX
    engine's by the margin rule and B=1 generate() under the same adapter;
    the two adapters continue one prompt differently."""
    params, cfg, port, ads, tads = setup
    lc = jlora.LoraConfig(**LORA)
    jbank = jlora.stack_adapters([jax.tree.map(jnp.asarray, a) for a in ads], lc)
    bank = stack_adapters(tads, LoraConfig(**LORA))
    kw = dict(n_slots=3, total=64, buckets=(16,), chunk_steps=4)
    jeng = engines("jax", params, cfg, adapters={"vi": ads[0], "math": ads[1]}, lora_config=lc,
                   speculative="off", **kw)
    rng = np.random.default_rng(5)
    prompts = [_prompt(rng, n) for n in (10, 12, 9)]
    names = (None, "vi", "math")
    want = [f.result(timeout=TIMEOUT)["ids"] for f in
            [jeng.submit(p, 16, adapter=a) for p, a in zip(prompts, names)]]
    for spec in ("off", "ngram"):
        eng = engines("port", port, port.cfg, adapters={"vi": tads[0], "math": tads[1]},
                      lora_config=LoraConfig(**LORA), speculative=spec, device="cpu", **kw)
        assert eng.adapter_names == ["math", "vi"]
        got = [f.result(timeout=TIMEOUT)["ids"] for f in
               [eng.submit(p, 16, adapter=a) for p, a in zip(prompts, names)]]
        for ix, (g, w, p) in enumerate(zip(got, want, prompts)):
            if g != w:
                margins = _jax_margins(params, jbank, ix, cfg, p, w)
                ties = np.nonzero(margins < MARGIN_TOL)[0]
                until = int(ties[0]) if len(ties) else len(w)
                assert g[:until] == w[:until] and until < len(w), (spec, ix, g, w)
            ids, mask = _pad(p, 16)
            with tl.row_adapters(select_adapters(port, bank, ix)):
                ref = tg.generate(port, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=16)
            assert g == ref[0, 16:].tolist(), (spec, ix)
    same = [eng.submit(prompts[0], 16, adapter=a).result(timeout=TIMEOUT)["ids"] for a in ("vi", "math")]
    assert same[0] != same[1]


def test_unknown_adapter_and_bank_validation(setup, engines):
    params, cfg, port, ads, tads = setup
    eng = engines("port", port, port.cfg, n_slots=1, total=64, buckets=(16,), adapters={"vi": tads[0]},
                  lora_config=LoraConfig(**LORA), device="cpu")
    with pytest.raises(ValueError, match=r"unknown adapter 'nope'; available: \['vi'\]"):
        eng.submit([5, 6], 4, adapter="nope")
    bare = engines("port", port, port.cfg, n_slots=1, total=64, buckets=(16,), device="cpu")
    with pytest.raises(ValueError, match="unknown adapter"):
        bare.submit([5, 6], 4, adapter="vi")
    wide = adapter_from_jax(jlora.init_lora(jax.random.key(9), params, jlora.LoraConfig(r=8, alpha=8)), "cpu")
    # the JAX package refuses the same banks (test_multilora.py:170-179)
    for bad, frag in (([tads[0], wide], "shapes differ"), ([], "at least one"),
                      ([tads[0], {"blocks": tads[0]["blocks"][:1]}], "different leaves")):
        with pytest.raises(ValueError, match=frag):
            stack_adapters(bad, LoraConfig(**LORA))
        with pytest.raises(ValueError, match=frag):
            jlora.stack_adapters([jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), b) for b in bad],
                                 jlora.LoraConfig(**LORA))


def test_prefix_cache_is_keyed_by_adapter(setup, engines):
    """A stored prompt serves a later request of the same adapter only
    (continuous.py:94-142), and the hit's stream equals a cold prefill's."""
    params, cfg, port, ads, tads = setup
    eng = engines("port", port, port.cfg, n_slots=2, total=128, buckets=(16, 32), prefix_cache_mb=4,
                  min_cached_prompt=8, adapters={"vi": tads[0], "math": tads[1]}, lora_config=LoraConfig(**LORA),
                  device="cpu")
    cold = engines("port", port, port.cfg, n_slots=2, total=128, buckets=(16, 32),
                   adapters={"vi": tads[0], "math": tads[1]}, lora_config=LoraConfig(**LORA), device="cpu")
    rng = np.random.default_rng(8)
    prefix = _prompt(rng, 12)
    longer = prefix + _prompt(rng, 6)
    eng.submit(prefix, 4, adapter="vi").result(timeout=TIMEOUT)
    hits = eng.snapshot_stats()["prefix_hits"]
    out_math = eng.submit(longer, 8, adapter="math").result(timeout=TIMEOUT)["ids"]
    assert eng.snapshot_stats()["prefix_hits"] == hits  # another adapter: no hit
    out_vi = eng.submit(longer, 8, adapter="vi").result(timeout=TIMEOUT)["ids"]
    assert eng.snapshot_stats()["prefix_hits"] == hits + 1
    assert out_vi == cold.submit(longer, 8, adapter="vi").result(timeout=TIMEOUT)["ids"]
    assert out_math == cold.submit(longer, 8, adapter="math").result(timeout=TIMEOUT)["ids"]


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


class _NoRetrieval:
    """A retriever stand-in: /generate needs none."""

    store = type("S", (), {"size": 0})()

    def search(self, queries, k):
        return [[] for _ in queries]


@pytest.mark.parametrize("quantize", [None, "nf4-dq"])
def test_generate_endpoint_with_adapters(quantize):
    """/generate {"adapter"}: each adapter's answer equals the engine's own
    stream, the two adapters' differ; a non-string or unknown name answers
    400; /healthz lists them (server.py:312-351)."""
    from vietnamese_qa_system_tpu_torch.models import init_causal_lm, init_lora
    from vietnamese_qa_system_tpu_torch.utils.tree import tree_map

    tok = ByteTokenizer()
    port = init_causal_lm(ModelConfig(**dict(BASE, vocab_size=tok.vocab_size)), torch.Generator().manual_seed(0),
                          quantize=quantize)
    draw = torch.Generator().manual_seed(1)
    ads = {name: tree_map(lambda t: torch.randn(t.shape, generator=draw) * 0.3,
                          init_lora(torch.Generator().manual_seed(i), port, LoraConfig(**LORA)))
           for i, name in enumerate(("vi", "math"))}
    gen = ContinuousEngine(port, port.cfg, n_slots=2, total=128, buckets=(16, 32), chunk_steps=4, default_max_new=6,
                           adapters=ads, lora_config=LoraConfig(**LORA), device="cpu")
    prompt = "xin chào"
    ids = tok.encode(prompt)
    app = ServingApp(_NoRetrieval(), gen=gen, tokenizer=tok, k=3, max_wait_s=0.02)
    httpd = make_server(app, port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        outs = []
        for name in ("vi", "math", None):
            out = _post(f"{url}/generate", {"prompt": prompt, "adapter": name})
            assert out["ids"] == gen.submit(ids, 6, adapter=name).result(timeout=TIMEOUT)["ids"]
            outs.append(out["ids"])
        assert outs[0] != outs[1]
        for payload, frag in (({"prompt": "a", "adapter": 3}, "'adapter' must be a string"),
                              ({"prompt": "a", "adapter": "nope"}, "unknown adapter 'nope'")):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(f"{url}/generate", payload)
            assert err.value.code == 400 and frag in json.loads(err.value.read())["error"]
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["stats"]["generate"]["adapters"] == ["math", "vi"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        th.join(timeout=10)


def test_serve_adapter_flag_loads_both_packages_files(tmp_path):
    """``serve --adapter`` over adapter.npz files written by the port's
    ``cli train --use-lora --checkpoint-dir`` and by the JAX package's
    ``save_pytree`` (its CLI's format), in a subprocess: each loads
    leaf for leaf, /generate answers under both, /healthz lists them."""
    from vietnamese_qa_system_tpu_torch.cli import main as cli
    from vietnamese_qa_system_tpu_torch.cli.main import _causal_preset
    from vietnamese_qa_system_tpu_torch.models import init_causal_lm
    from vietnamese_qa_system_tpu_torch.train.checkpoint import load_pytree

    sample = os.path.join(ROOT, "examples", "sample_instruct.jsonl")
    assert cli(["train", "--model-size", "tiny", "--use-lora", "--train-files", sample, "--max-steps", "1",
                "--log-dir", str(tmp_path / "logs"), "--checkpoint-dir", str(tmp_path / "port"), "--device",
                "cpu"]) == 0
    jparams = jlm.init_causal_lm(jax.random.key(0), jc.tiny_test("causal"))
    jad = jlora.init_lora(jax.random.key(4), jparams, jlora.LoraConfig())  # serve's --adapter-r / -alpha defaults
    jad = jax.tree.map(lambda x: np.asarray(x) + 0.1, jad)
    os.makedirs(tmp_path / "jax")
    jsave(str(tmp_path / "jax" / "adapter.npz"), jad)
    cfg = _causal_preset("tiny")
    cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, ByteTokenizer().vocab_size))
    model = init_causal_lm(cfg, torch.Generator().manual_seed(0))
    lc = LoraConfig()  # serve's --adapter-r / --adapter-alpha defaults
    for name in ("port", "jax"):
        path = str(tmp_path / name / "adapter.npz")
        got = tree_leaves(load_adapter(path, model, lc))
        want = load_pytree(path)
        assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": f"tài liệu {i}"}, ensure_ascii=False) for i in range(4)),
                    encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--batch-size", "4",
                "--max-len", "48"]) == 0
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "vietnamese_qa_system_tpu_torch.cli", "serve", "--index", idx,
                             "--db", db, "--device", "cpu", "--port", "0", "--max-len", "48", "--reader-size", "tiny",
                             "--reader-quantize", "nf4", "--continuous-slots", "2", "--gen-total", "128",
                             "--max-new-tokens", "4", "--adapter", f"port={tmp_path / 'port' / 'adapter.npz'}",
                             "--adapter", f"jax={tmp_path / 'jax' / 'adapter.npz'}"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("serving "):
                break
        assert any("adapters loaded: ['jax', 'port'] (r=8, alpha=16)" in x for x in lines), lines
        url = "http://" + line.split("http://", 1)[1].split(" ", 1)[0]
        outs = [_post(f"{url}/generate", {"prompt": "xin chào", "adapter": a}) for a in ("port", "jax", None)]
        assert all(1 <= o["n_new"] <= 4 for o in outs)
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["stats"]["generate"]["adapters"] == ["jax", "port"]
    finally:
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, out
