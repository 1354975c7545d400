"""The port's HF export (``models/convert_hf.py`` ``to_*_state_dict`` /
``export_*`` / ``export_causal_auto`` / ``export_t5`` through
``models/hf_io.py``'s write half) against the JAX package's, which fills a
transformers model and calls ``save_pretrained(safe_serialization=False)``:

- per family (GPT-NeoX, GPT-Neo, GPT-2, Llama, Mistral, Qwen2, Gemma,
  BLOOM, MPT, T5 untied and tied), the port's export of the carried JAX
  params gives the same files, the same tensor names, shapes, dtypes and
  bytes, tied tensors sharing one storage as in JAX's file, ``AutoConfig``
  dicts equal apart from ``transformers_version`` and ``_name_or_path``,
  and equal generation_config.json files;
- ``to_*_state_dict`` equals the tensors of the file;
- round trip: export -> the port's import gives the model back bit for
  bit, and transformers loads the directory (logits within the import
  tests' 0.05);
- shards: with ``hf_io.MAX_SHARD_BYTES`` lowered the weights go to shards
  behind ``pytorch_model.bin.index.json``, which the port and transformers
  load;
- the export runs with jax, transformers and safetensors blocked;
- the per-family ``convert_*`` / ``load_*`` wrappers equal the JAX ones;
- a quantized layer exports dequantized with its LoRA factors folded in;
  a nonzero MPT norm bias raises as in JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from test_torch_convert_hf import CAUSAL, LOGIT_TOL, _hf_model, _port_cfg, _states_equal
from test_torch_seq2seq import CONFIGS as S2S_CONFIGS
from test_torch_seq2seq import jax_params as s2s_params
from test_torch_seq2seq import port_model as s2s_port

from vietnamese_qa_system_tpu.models import convert_hf as jconv
from vietnamese_qa_system_tpu_torch.models import causal_from_hf, causal_from_jax, seq2seq_from_hf
from vietnamese_qa_system_tpu_torch.models import convert_hf as tconv
from vietnamese_qa_system_tpu_torch.models import hf_io

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T5_NAMES = ("t5", "t5-v1")  # gated untied (mT5's layout), v1.0 tied
T5_IDS = dict(pad_token_id=0, eos_token_id=2, decoder_start_token_id=0)


def _load_bin(d: str) -> dict:
    if os.path.exists(os.path.join(d, hf_io.BIN)):
        return torch.load(os.path.join(d, hf_io.BIN), map_location="cpu", weights_only=True)
    with open(os.path.join(d, hf_io.BIN_INDEX)) as f:
        files = sorted(set(json.load(f)["weight_map"].values()))
    out = {}
    for name in files:
        out.update(torch.load(os.path.join(d, name), map_location="cpu", weights_only=True))
    return out


def _storage_groups(sd: dict) -> list:
    groups = {}
    for k, v in sd.items():
        groups.setdefault(v.untyped_storage().data_ptr(), []).append(k)
    return sorted(sorted(g) for g in groups.values())


def _auto_config(d: str) -> dict:
    cfg = transformers.AutoConfig.from_pretrained(d).to_dict()
    for key in ("transformers_version", "_name_or_path"):
        cfg.pop(key, None)
    return cfg


def _generation(d: str) -> dict:
    with open(os.path.join(d, "generation_config.json")) as f:
        gen = json.load(f)
    gen.pop("transformers_version", None)
    return gen


def assert_same_directory(got: str, want: str, ulp_names=()) -> None:
    """The port's directory ``got`` holds what JAX's ``want`` holds: every
    tensor bit for bit, except those named in ``ulp_names``, which may
    differ by one f32 ulp of the tensor's largest entry."""
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    g, w = _load_bin(got), _load_bin(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape and g[k].is_contiguous(), k
        if k in ulp_names:
            a, b = g[k].numpy(), w[k].numpy()
            assert np.abs(a - b).max() <= np.spacing(np.abs(b).max()), k
        else:
            assert torch.equal(g[k], w[k]), k
    assert _storage_groups(g) == _storage_groups(w)
    assert _auto_config(got) == _auto_config(want)
    assert _generation(got) == _generation(want)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """family -> (JAX params, JAX cfg, the port's model of them)."""
    out = {}
    for family in CAUSAL:
        d = str(tmp_path_factory.mktemp(f"src_{family}"))
        _hf_model(family).save_pretrained(d, safe_serialization=False)
        params, cfg = jconv.load_causal_auto(d)
        params = jax.tree.map(np.asarray, params)
        out[family] = (params, cfg, causal_from_jax(params, _port_cfg(cfg), device="cpu",
                                                    no_bias=tconv.causal_family(family).no_bias))
    for name in T5_NAMES:
        cfg = S2S_CONFIGS[name]
        params = jax.tree.map(np.asarray, s2s_params(cfg, seed=4))
        out[name] = (params, cfg, s2s_port(params, cfg))
    return out


def _export_both(carried, name, tmp_path):
    params, cfg, model = carried[name]
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    if name in T5_NAMES:
        jconv.export_t5(params, cfg, want, **T5_IDS)
        tconv.export_t5(model, got, **T5_IDS)
    else:
        jconv.export_causal_auto(params, cfg, want)
        tconv.export_causal_auto(model, got)
    return got, want


@pytest.mark.parametrize("name", [*CAUSAL, *T5_NAMES])
def test_export_equals_jax(carried, name, tmp_path):
    got, want = _export_both(carried, name, tmp_path)
    assert_same_directory(got, want)
    params, cfg, model = carried[name]
    model_type = "t5" if name in T5_NAMES else tconv.causal_export_type(model.cfg)
    assert _auto_config(got)["model_type"] == model_type
    to_sd = tconv.to_t5_state_dict if name in T5_NAMES else {
        "gpt_neox": tconv.to_gpt_neox_state_dict, "gpt_neo": tconv.to_gpt_neo_state_dict,
        "gpt2": tconv.to_gpt2_state_dict, "llama": tconv.to_llama_state_dict, "bloom": tconv.to_bloom_state_dict,
        "mpt": tconv.to_mpt_state_dict}.get(model_type)
    if to_sd is not None:
        sd, file = to_sd(model), _load_bin(got)
        assert sorted(sd) == sorted(file) and all(torch.equal(sd[k], file[k]) for k in sd)
    # the round trip through the port's import gives the model back
    back = seq2seq_from_hf(got, device="cpu") if name in T5_NAMES else causal_from_hf(got, device="cpu")
    _states_equal(back.state_dict(), model.state_dict())


@pytest.mark.parametrize("family", ["gpt_neox", "llama", "mpt"])
def test_sharded_export_loads_in_the_port_and_transformers(carried, family, tmp_path, monkeypatch):
    _, cfg, model = carried[family]
    whole = str(tmp_path / "whole")
    tconv.export_causal_auto(model, whole)
    monkeypatch.setattr(hf_io, "MAX_SHARD_BYTES", 40_000)
    sharded = str(tmp_path / "sharded")
    tconv.export_causal_auto(model, sharded)
    files = os.listdir(sharded)
    shards = sorted(f for f in files if f.startswith("pytorch_model-"))
    assert hf_io.BIN not in files and hf_io.BIN_INDEX in files and len(shards) > 2
    assert shards[0] == f"pytorch_model-00001-of-{len(shards):05d}.bin"
    with open(os.path.join(sharded, hf_io.BIN_INDEX)) as f:
        index = json.load(f)
    sd = _load_bin(whole)
    assert sorted(index["weight_map"]) == sorted(sd)
    assert index["metadata"]["total_size"] == sum(
        t.untyped_storage().nbytes() for t in {v.untyped_storage().data_ptr(): v for v in sd.values()}.values())
    _states_equal(causal_from_hf(sharded, device="cpu").state_dict(), model.state_dict())
    ids = torch.from_numpy(np.random.default_rng(0).integers(4, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        hf = transformers.AutoModelForCausalLM.from_pretrained(sharded).eval()
        want = hf(ids).logits.numpy()
        got = model(ids, torch.ones_like(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("name", ["gpt2", "bloom", "t5"])
def test_transformers_loads_the_export(carried, name, tmp_path):
    _, cfg, model = carried[name]
    d = str(tmp_path / "out")
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(4, cfg.vocab_size, (2, 10)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        if name == "t5":
            tconv.export_t5(model, d, **T5_IDS)
            hf = transformers.AutoModelForSeq2SeqLM.from_pretrained(d).eval()
            dec = torch.from_numpy(rng.integers(4, cfg.vocab_size, (2, 6)))
            want = hf(input_ids=ids, attention_mask=mask, decoder_input_ids=dec).logits.numpy()
            got = model({"input_ids": ids, "attention_mask": mask, "decoder_input_ids": dec}).numpy()
            assert hf.generation_config.eos_token_id == 2 and hf.config.pad_token_id == 0
            diff = np.abs(got - want)  # tests/test_t5.py's envelope
            assert np.quantile(diff, 0.995) < 0.3 and diff.max() < 1.0
            return
        tconv.export_causal_auto(model, d)
        want = transformers.AutoModelForCausalLM.from_pretrained(d).eval()(ids).logits.numpy()
        got = model(ids, mask).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_export_without_jax_transformers_or_safetensors(carried, tmp_path):
    """A process that cannot import jax, transformers or safetensors writes
    an MPT directory (sharded) and a T5 one, and loads them back."""
    _, _, model = carried["mpt"]
    src = str(tmp_path / "src")
    tconv.export_causal_auto(model, src)
    want = str(tmp_path / "want")
    tconv.export_causal_auto(model, want)
    code = (
        "import sys\n"
        "for name in ('jax', 'transformers', 'safetensors', 'huggingface_hub', 'vietnamese_qa_system_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from vietnamese_qa_system_tpu_torch.models import causal_from_hf, convert_hf, hf_io, config, "
        "init_seq2seq_model, seq2seq_from_hf\n"
        f"m = causal_from_hf({src!r}, device='cpu')\n"
        "hf_io.MAX_SHARD_BYTES = 30_000\n"
        f"convert_hf.export_causal_auto(m, {str(tmp_path / 'out')!r})\n"
        f"back = causal_from_hf({str(tmp_path / 'out')!r}, device='cpu')\n"
        "print(all(torch.equal(a, b) for a, b in zip(back.state_dict().values(), m.state_dict().values())))\n"
        "t5 = init_seq2seq_model(config.tiny_test('seq2seq').__class__(arch='seq2seq', seq2seq_family='t5', "
        "vocab_size=64, d_model=32, n_heads=2, d_kv=8, n_layers=1, n_decoder_layers=1, d_ff=48, "
        "relative_attention_buckets=8, attention_bias=False), torch.Generator().manual_seed(0))\n"
        f"convert_hf.export_t5(t5, {str(tmp_path / 't5')!r}, eos_token_id=2)\n"
        f"print(seq2seq_from_hf({str(tmp_path / 't5')!r}, device='cpu').cfg.vocab_size)\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'transformers', 'safetensors') "
        "and sys.modules[n] is not None))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:3] == ["True", "64", "[]"]
    assert len([f for f in os.listdir(tmp_path / "out") if f.startswith("pytorch_model-")]) > 1
    assert _auto_config(str(tmp_path / "t5"))["eos_token_id"] == 2


@pytest.mark.parametrize("family", ["gpt_neox", "gpt_neo", "gpt2", "llama", "qwen2", "gemma", "bloom", "mpt", "bert",
                                    "mpnet"])
def test_family_wrappers_equal_jax(family, tmp_path):
    """``load_<family>`` and ``convert_<family>`` give JAX's trees and
    configurations (load_qwen2 has no convert: qwen2 converts as llama)."""
    model = _hf_model(family)
    model.save_pretrained(str(tmp_path))
    load = getattr(tconv, f"load_{family}")
    tree, cfg = load(str(tmp_path))
    want, jcfg = getattr(jconv, f"load_{family}")(str(tmp_path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    from vietnamese_qa_system_tpu_torch.utils.tree import flatten_paths

    got_flat = {k: v.numpy() for k, v in flatten_paths(tree).items()}
    want_flat = {k: np.asarray(v) for k, v in flatten_paths(jax.tree.map(np.asarray, want)).items()}
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    convert = getattr(tconv, f"convert_{'llama' if family == 'qwen2' else family}")
    sd = model.state_dict()
    again = flatten_paths(convert(sd, cfg))
    assert sorted(again) == sorted(got_flat) and all(np.array_equal(again[k].numpy(), got_flat[k]) for k in got_flat)


@pytest.mark.parametrize("mode", ["int8", "int8c", "nf4"])
def test_quantized_layers_export_dequantized_with_lora_folded(carried, mode, tmp_path):
    """A quantized model with LoRA factors attached exports each dense
    weight as its dequantized codes plus A @ B, one layer at a time: the
    weight ``dequantize_tree`` folds."""
    from vietnamese_qa_system_tpu_torch.models import (LoraConfig, clear_lora, dequantize_tree, init_lora,
                                                       merge_lora, quantize_dense_tree)
    from vietnamese_qa_system_tpu_torch.utils.tree import tree_leaves

    q = causal_from_jax(carried["llama"][0], _port_cfg(carried["llama"][1]), device="cpu")
    quantize_dense_tree(q, mode)
    lcfg = LoraConfig(r=4, alpha=8)
    adapter = init_lora(torch.Generator().manual_seed(3), q, lcfg)
    g = torch.Generator().manual_seed(4)
    for leaf in tree_leaves(adapter):  # B starts at zero: draw both factors
        leaf.data.copy_(0.05 * torch.randn(leaf.shape, generator=g))
    merge_lora(q, adapter, lcfg)
    out = str(tmp_path / "hf")
    tconv.export_causal_auto(q, out)
    got = _load_bin(out)["model.layers.0.self_attn.q_proj.weight"]
    dense = q.blocks[0].attn.wq
    want = dense.dequantized(torch.float32) + dense.lora_a @ dense.lora_b
    assert torch.equal(got, want.T)
    dequantize_tree(q)
    assert torch.equal(got, dense.w_dequant.T)
    clear_lora(q)


def test_mpt_nonzero_norm_bias_raises(carried, tmp_path):
    params, cfg, model = carried["mpt"]
    with torch.no_grad():
        model.blocks[1].ln2.bias.add_(0.5)
    try:
        with pytest.raises(ValueError, match="nonzero LayerNorm bias"):
            tconv.export_causal_auto(model, str(tmp_path / "out"))
        bad = jax.tree.map(np.copy, params)
        bad["blocks"][1]["ln2"]["bias"] = bad["blocks"][1]["ln2"]["bias"] + 0.5
        with pytest.raises(ValueError, match="nonzero LayerNorm bias"):
            jconv.export_causal_auto(bad, cfg, str(tmp_path / "jax"))
    finally:
        with torch.no_grad():
            model.blocks[1].ln2.bias.sub_(0.5)
