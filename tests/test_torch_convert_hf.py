"""The port's import of local Hugging Face directories against the JAX
package's, for the eleven families (BERT, MPNet, GPT-NeoX, GPT-Neo, GPT-2,
Llama, Mistral, Qwen2, Gemma, BLOOM, MPT), each saved by ``transformers``
as one safetensors file, as sharded safetensors and as ``.bin``:

- the port's ``ModelConfig`` (read from config.json with no
  ``transformers``) equals JAX ``*_config(AutoConfig.from_pretrained)``,
  also for config files that hold only a few keys (the class defaults);
- the port's module state equals ``causal_from_jax`` / ``encoder_from_jax``
  of the JAX ``load_*_auto``, tensor for tensor and bit for bit, also when
  streamed with int8c quantization;
- logits agree with the HF model within the JAX import tests' tolerance
  (atol = rtol = 0.05, argmax agreement > 0.9; encoders' hidden states
  within 0.03), and greedy tokens equal the JAX package's by the margin
  rule of test_torch_generate.py;
- a missing weight raises KeyError; a tied head saved without lm_head
  loads; a process that cannot import jax, transformers or safetensors
  loads a directory;
- ``serve --reader-params``, ``chat --init-params`` and ``train
  --init-params`` run on the CPU;
- the JAX package's ``load_converted_params`` misses an MPT directory that
  its own ``load_causal_auto`` and the port load;
- the seq2seq families (T5 v1.0, mT5, mBART with a nonzero
  ``final_logits_bias``): configs and tensors equal JAX
  ``load_seq2seq_auto``'s, streamed int8c equal to quantizing, logits
  against transformers (mBART within the tolerance above, T5 within
  tests/test_t5.py's envelope), ``hf_config`` answering as ``AutoConfig``
  for full and minimal files, an mBART directory that JAX
  ``load_converted_params`` misses, and ``chat --arch seq2seq``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from vietnamese_qa_system_tpu.models import causal_lm as jlm
from vietnamese_qa_system_tpu.models import convert_hf as jconv
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu_torch.cli.main import main as cli
from vietnamese_qa_system_tpu_torch.models import (ModelConfig, causal_from_hf, causal_from_jax, encoder_from_hf,
                                                   encoder_from_jax, quantize_dense_tree)
from vietnamese_qa_system_tpu_torch.models import convert_hf as tconv
from vietnamese_qa_system_tpu_torch.models import generate as tg
from vietnamese_qa_system_tpu_torch.models import hf_io

torch.set_num_threads(2)
LOGIT_TOL = 0.05  # tests/test_convert_hf.py: bf16 matmuls against torch f32
ENCODER_TOL = 0.03  # tests/test_convert_hf.py's encoder tolerance
MARGIN_TOL = 2e-2  # test_torch_generate.py's margin rule
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# family -> (config class, its keyword arguments, model class, JAX *_config)
FAMILIES = {
    "bert": (transformers.BertConfig, dict(vocab_size=120, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                           intermediate_size=128, max_position_embeddings=64),
             transformers.BertModel, jconv.bert_config),
    "mpnet": (transformers.MPNetConfig, dict(vocab_size=120, hidden_size=64, num_hidden_layers=2,
                                             num_attention_heads=4, intermediate_size=128, max_position_embeddings=64,
                                             relative_attention_num_buckets=32),
              transformers.MPNetModel, jconv.mpnet_config),
    "gpt_neox": (transformers.GPTNeoXConfig, dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                                                  num_attention_heads=4, intermediate_size=256,
                                                  max_position_embeddings=64, rotary_pct=0.25,
                                                  use_parallel_residual=True, tie_word_embeddings=False),
                 transformers.GPTNeoXForCausalLM, jconv.neox_config),
    "gpt_neo": (transformers.GPTNeoConfig, dict(vocab_size=128, hidden_size=64, num_layers=2,
                                                attention_types=[[["global", "local"], 1]], num_heads=4,
                                                intermediate_size=256, max_position_embeddings=64, window_size=8),
                transformers.GPTNeoForCausalLM, jconv.gpt_neo_config),
    "gpt2": (transformers.GPT2Config, dict(vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_inner=256,
                                           n_positions=64),
             transformers.GPT2LMHeadModel, jconv.gpt2_config),
    "llama": (transformers.LlamaConfig, dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                                             num_attention_heads=4, num_key_value_heads=2, intermediate_size=160,
                                             max_position_embeddings=64),
              transformers.LlamaForCausalLM, jconv.llama_config),
    "mistral": (transformers.MistralConfig, dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                                                 num_attention_heads=4, num_key_value_heads=2, intermediate_size=160,
                                                 max_position_embeddings=64, sliding_window=8),
                transformers.MistralForCausalLM, jconv.llama_config),
    "qwen2": (transformers.Qwen2Config, dict(vocab_size=128, hidden_size=48, num_hidden_layers=2,
                                             num_attention_heads=6, num_key_value_heads=2, intermediate_size=96,
                                             max_position_embeddings=64, rope_theta=1e6, tie_word_embeddings=True),
              transformers.Qwen2ForCausalLM, jconv.qwen2_config),
    "gemma": (transformers.GemmaConfig, dict(vocab_size=128, hidden_size=48, num_hidden_layers=2,
                                             num_attention_heads=4, num_key_value_heads=1, head_dim=16,
                                             intermediate_size=96, max_position_embeddings=64,
                                             hidden_act="gelu_pytorch_tanh"),
              transformers.GemmaForCausalLM, jconv.gemma_config),
    "bloom": (transformers.BloomConfig, dict(vocab_size=128, hidden_size=48, n_layer=2, n_head=6),
              transformers.BloomForCausalLM, jconv.bloom_config),
    "mpt": (transformers.MptConfig, dict(vocab_size=128, d_model=48, n_heads=6, n_layers=2, expansion_ratio=4,
                                         max_seq_len=64),
            transformers.MptForCausalLM, jconv.mpt_config),
}
ENCODERS = ("bert", "mpnet")
CAUSAL = tuple(f for f in FAMILIES if f not in ENCODERS)
FORMATS = {"safetensors": dict(), "sharded": dict(max_shard_size="40KB"), "bin": dict(safe_serialization=False)}


def _hf_model(family: str):
    cls, kw, model_cls, _ = FAMILIES[family]
    torch.manual_seed(sum(map(ord, family)))
    model = model_cls(cls(**kw)).eval()
    # every parameter off its init (unit norms, zero biases), so a layout
    # fault cannot hide behind a constant
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """family -> (HF model, {format: directory})."""
    out = {}
    for family in FAMILIES:
        model = _hf_model(family)
        dirs = {}
        for fmt, kw in FORMATS.items():
            d = str(tmp_path_factory.mktemp(f"{family}_{fmt}"))
            model.save_pretrained(d, **kw)
            dirs[fmt] = d
        out[family] = (model, dirs)
    return out


def _port_cfg(cfg) -> ModelConfig:
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def _states_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_and_weights_equal_jax_import(saved, family, fmt):
    d = saved[family][1][fmt]
    files = os.listdir(d)
    assert {"safetensors": "model.safetensors" in files,
            "sharded": "model.safetensors.index.json" in files and sum(f.endswith(".safetensors") for f in files) > 1,
            "bin": "pytorch_model.bin" in files}[fmt]
    jax_cfg = FAMILIES[family][3](transformers.AutoConfig.from_pretrained(d))
    view = tconv.hf_config(d)
    if family in ENCODERS:
        port_cfg = tconv.encoder_family(family).config(view)
        jparams, jcfg = jconv.load_encoder_auto(d)
        want = encoder_from_jax(jax.tree.map(np.asarray, jparams), _port_cfg(jcfg), device="cpu").state_dict()
        got = encoder_from_hf(d, device="cpu")
        assert got.cfg == port_cfg
    else:
        port_cfg = tconv.causal_family(family).config(view)
        jparams, jcfg = jconv.load_causal_auto(d)
        want = causal_from_jax(jax.tree.map(np.asarray, jparams), _port_cfg(jcfg), device="cpu",
                               no_bias=tconv.causal_family(family).no_bias).state_dict()
        got = causal_from_hf(d, device="cpu")
        if port_cfg.tie_embeddings and fmt != "bin":
            # a tied head is saved without lm_head.weight and loads all the same
            with hf_io.Checkpoint(d) as ckpt:
                assert not any(k.endswith("lm_head.weight") or k == "embed_out.weight" for k in ckpt)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg) == dataclasses.asdict(jcfg)
    _states_equal(got.state_dict(), want)


@pytest.mark.parametrize("family", CAUSAL)
def test_streamed_int8c_equals_quantizing_the_loaded_model(saved, family):
    d = saved[family][1]["sharded"]
    streamed = causal_from_hf(d, device="cpu", quantize="int8c")
    whole = quantize_dense_tree(causal_from_hf(d, device="cpu"), "int8c")
    _states_equal(streamed.state_dict(), whole.state_dict())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_minimal_config_json_reads_as_transformers(tmp_path, family):
    """A config.json holding only model_type and the sizes: every other
    field is the transformers class default, in the port as in JAX."""
    cls, kw, _, jax_config = FAMILIES[family]
    keep = {k: v for k, v in kw.items() if k not in ("tie_word_embeddings", "rotary_pct", "use_parallel_residual",
                                                      "window_size", "sliding_window", "rope_theta", "head_dim")}
    raw = dict(keep, model_type=cls.model_type)
    (tmp_path / "config.json").write_text(json.dumps(raw))
    jax_cfg = jax_config(transformers.AutoConfig.from_pretrained(str(tmp_path)))
    fam = tconv.encoder_family(family) if family in ENCODERS else tconv.causal_family(family)
    assert dataclasses.asdict(fam.config(tconv.hf_config(str(tmp_path)))) == dataclasses.asdict(jax_cfg)


def test_mosaicml_mpt_config_reads_as_transformers(tmp_path):
    """PhoGPT's MosaicML layout: nested attn_config, extra MosaicML keys,
    tie_word_embeddings absent."""
    raw = {"architectures": ["MPTForCausalLM"], "model_type": "mpt", "d_model": 96, "n_heads": 6, "n_layers": 2,
           "expansion_ratio": 4, "max_seq_len": 128, "vocab_size": 128, "no_bias": True, "norm_type":
           "low_precision_layernorm", "learned_pos_emb": True, "logit_scale": None, "init_device": "cpu",
           "ffn_config": {"ffn_type": "mptmlp"}, "attn_config": {"alibi": True, "alibi_bias_max": 8,
                                                                  "attn_impl": "flash", "attn_pdrop": 0.0,
                                                                  "attn_type": "multihead_attention",
                                                                  "clip_qkv": None, "qk_ln": False,
                                                                  "softmax_scale": None}}
    (tmp_path / "config.json").write_text(json.dumps(raw))
    want = jconv.mpt_config(transformers.AutoConfig.from_pretrained(str(tmp_path)))
    got = tconv.mpt_config(tconv.hf_config(str(tmp_path)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.tie_embeddings


def _ids(family, vocab, b=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(4, vocab, (b, t)).astype(np.int64)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_outputs_agree_with_transformers(saved, family):
    model, dirs = saved[family]
    vocab = model.config.vocab_size
    ids = _ids(family, vocab)
    mask = np.ones_like(ids)
    with torch.no_grad():
        if family in ENCODERS:
            mask[1, 11:] = 0
            ids[1, 11:] = model.config.pad_token_id
            hf = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
            ours = encoder_from_hf(dirs["safetensors"], device="cpu").encode(
                torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
            valid = mask.astype(bool)
            np.testing.assert_allclose(ours[valid], hf[valid], atol=ENCODER_TOL, rtol=ENCODER_TOL)
            return
        hf = model(torch.from_numpy(ids)).logits.numpy()
        ours = causal_from_hf(dirs["safetensors"], device="cpu")(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, hf, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert (ours.argmax(-1) == hf.argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("family", CAUSAL)
def test_greedy_tokens_equal_jax(saved, family):
    model, dirs = saved[family]
    jparams, jcfg = jconv.load_causal_auto(dirs["safetensors"])
    port = causal_from_hf(dirs["safetensors"], device="cpu")
    ids = _ids(family, model.config.vocab_size, b=2, t=8, seed=1).astype(np.int32)
    mask = np.ones_like(ids)
    want = np.asarray(jg.generate(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=5,
                                  temperature=0.0))
    got = tg.generate(port, torch.from_numpy(ids), torch.from_numpy(mask), max_new_tokens=5).numpy()
    if np.array_equal(got, want):
        return
    logits = np.asarray(jlm.forward(jparams, jcfg, jnp.asarray(want[:, :-1]), jnp.ones_like(want[:, :-1])))
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r, 8:] != want[r, 8:])[0]
        if len(diff):
            top2 = np.sort(logits[r, 8 + diff[0] - 1])[-2:]
            assert top2[1] - top2[0] < MARGIN_TOL, (family, r, diff[0], top2)


@pytest.mark.parametrize("family", ["bert", "gpt_neox", "llama", "mpt"])
def test_missing_weight_raises(saved, family):
    model = saved[family][0]
    sd = dict(model.state_dict())
    victim = next(k for k in sd if "layers.1." in k or "layer.1." in k or "h.1." in k or "blocks.1." in k)
    sd.pop(victim)
    cfg = (tconv.encoder_family if family in ENCODERS else tconv.causal_family)(family).config(
        tconv.hf_config(model.config.to_dict()))
    fam = tconv.encoder_family(family) if family in ENCODERS else tconv.causal_family(family)
    with pytest.raises(KeyError, match="missing weight"):
        tconv.convert(sd, cfg, fam)
    with pytest.raises(FileNotFoundError, match="no weights"):
        hf_io.Checkpoint(os.path.dirname(__file__))


def test_loads_without_jax_transformers_or_safetensors(saved):
    code = (
        "import sys\n"
        "for name in ('jax', 'transformers', 'safetensors', 'vietnamese_qa_system_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from vietnamese_qa_system_tpu_torch.models import causal_from_hf, encoder_from_hf\n"
        f"m = causal_from_hf({saved['mpt'][1]['sharded']!r}, device='cpu', quantize='int8c')\n"
        "print(tuple(m(torch.ones(1, 4, dtype=torch.long)).shape))\n"
        f"e = encoder_from_hf({saved['mpnet'][1]['bin']!r}, device='cpu')\n"
        "print(tuple(e.sentence_embed(torch.full((1, 4), 5), torch.ones(1, 4, dtype=torch.long)).shape))\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'transformers', 'safetensors') "
        "and sys.modules[n] is not None))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:3] == ["(1, 4, 128)", "(1, 64)", "[]"]


# ------------------------------------------------------------------- CLI


def _tiny_neox_dir(tmp_path, **changes) -> str:
    """A GPT-NeoX directory of the port's ``tiny`` reader preset, with
    ``changes`` to its config."""
    hf_cfg = transformers.GPTNeoXConfig(**{**dict(
        vocab_size=512, hidden_size=128, num_hidden_layers=2, num_attention_heads=4, intermediate_size=512,
        max_position_embeddings=256, rotary_pct=1.0, use_parallel_residual=False, tie_word_embeddings=True,
        layer_norm_eps=1e-6), **changes})
    torch.manual_seed(3)
    d = str(tmp_path / "tiny_neox")
    transformers.GPTNeoXForCausalLM(hf_cfg).save_pretrained(d)
    return d


def test_cli_loads_hf_dirs_and_checkpoints(tmp_path, monkeypatch, capsys):
    from vietnamese_qa_system_tpu_torch.cli.main import load_converted_params
    from vietnamese_qa_system_tpu_torch.models import config as mcfg

    hf_dir = _tiny_neox_dir(tmp_path)
    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": f"Tài liệu số {i} về Hà Nội."}, ensure_ascii=False) for i in range(6)),
                    encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--batch-size", "8",
                "--max-len", "32"]) == 0
    lines = iter(["Tài liệu số 2 về Hà Nội.", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert cli(["serve", "--index", idx, "--db", db, "--device", "cpu", "--max-len", "32", "--reader-size", "tiny",
                "--reader-params", hf_dir, "--reader-quantize", "int8c", "--max-new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"reader weights loaded from {hf_dir}" in out and "RANDOM" not in out and "answer" in out

    # train from the HF directory, then chat from the train checkpoint
    ckpt = str(tmp_path / "ckpt")
    assert cli(["train", "--model-size", "tiny", "--init-params", hf_dir, "--train-files",
                os.path.join(ROOT, "examples", "sample_instruct.jsonl"), "--max-steps", "1", "--batch-size", "2",
                "--max-len", "256", "--checkpoint-dir", ckpt, "--save-every-steps", "1", "--log-dir",
                str(tmp_path / "logs"), "--device", "cpu"]) == 0
    cfg = mcfg.tiny_test("causal")
    trained = load_converted_params(ckpt, cfg, "cpu")
    start = causal_from_hf(hf_dir, cfg, device="cpu")
    moved = [n for n, t in trained.state_dict().items() if not torch.equal(t, start.state_dict()[n])]
    assert moved, "the checkpoint's parameters are the trained ones, not the HF start"
    # the JAX loader restores {"params": ...} against a whole trainer state
    # (adapter, opt_state, params, step) and refuses it by its leaf count
    from vietnamese_qa_system_tpu.cli.main import load_converted_params as jax_load
    from vietnamese_qa_system_tpu.models import tiny_test as jax_tiny

    with pytest.raises(ValueError, match="leaves but target structure has"):
        jax_load(ckpt, jax_tiny("causal"))
    lines = iter(["Xin chào", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert cli(["chat", "--model-size", "tiny", "--init-params", ckpt, "--max-len", "64", "--max-new-tokens", "3",
                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"reader weights loaded from {ckpt}" in out and "model> " in out
    # a flat .npz of the parameter tree loads too; a preset of other shapes raises
    from vietnamese_qa_system_tpu_torch.train.checkpoint import save_pytree
    from vietnamese_qa_system_tpu_torch.train.trainer import params_tree

    os.makedirs(tmp_path / "flat")
    flat = str(tmp_path / "flat" / "p.npz")
    save_pytree(flat, params_tree(trained))
    _states_equal(load_converted_params(flat, cfg, "cpu").state_dict(), trained.state_dict())
    with pytest.raises((ValueError, RuntimeError)):
        load_converted_params(hf_dir, dataclasses.replace(cfg, d_ff=256), "cpu")
    with pytest.raises(ValueError, match="leaves"):
        load_converted_params(ckpt, dataclasses.replace(cfg, d_ff=256), "cpu")


@pytest.mark.parametrize("change,field", [(dict(rotary_emb_base=5e5), "rope_theta"),
                                          (dict(layer_norm_eps=1e-5), "norm_eps"),
                                          (dict(use_parallel_residual=True), "parallel_residual")])
def test_hf_dir_of_another_config_than_the_preset_raises(tmp_path, change, field):
    """A field that changes the maths but not the shapes: the preset and
    the file must agree, else the load raises naming the field."""
    from vietnamese_qa_system_tpu_torch.cli.main import load_converted_params
    from vietnamese_qa_system_tpu_torch.models import config as mcfg

    cfg = mcfg.tiny_test("causal")
    assert causal_from_hf(_tiny_neox_dir(tmp_path / "same"), cfg, device="cpu").cfg == cfg
    # the runtime fields may differ
    causal_from_hf(_tiny_neox_dir(tmp_path / "run"), dataclasses.replace(cfg, scan_layers=True,
                                                                         use_flash_attention=True), device="cpu")
    with pytest.raises(ValueError, match=field):
        load_converted_params(_tiny_neox_dir(tmp_path, **change), cfg, "cpu")


def test_missing_bias_raises_unless_the_layout_has_none():
    """Only a layout that states it (GPT-Neo's q/k/v) loads without a bias."""
    from vietnamese_qa_system_tpu.models import tiny_test as jax_tiny

    cfg = jax_tiny("causal")
    params = jax.tree.map(np.asarray, jlm.init_causal_lm(jax.random.key(0), cfg))
    for name in ("wq", "wk", "wv"):
        for block in params["blocks"]:
            del block["attn"][name]["b"]
    with pytest.raises(RuntimeError, match="attn.wq.b"):
        causal_from_jax(params, _port_cfg(cfg), device="cpu")
    model = causal_from_jax(params, _port_cfg(cfg), device="cpu", no_bias=tconv.causal_family("gpt_neo").no_bias)
    assert model.blocks[0].attn.wq.b is None and model.blocks[0].attn.wo.b is not None


@pytest.mark.parametrize("base", ["float", "int8"])
def test_lora_trainer_checkpoint(tmp_path, base):
    """A LoRA run's checkpoint loads with its trained adapter merged into
    the weights (W + alpha / r * A @ B, the adapter.npz the run wrote); a
    QLoRA run's (int8 base) raises saying so."""
    from vietnamese_qa_system_tpu_torch.cli.main import load_converted_params
    from vietnamese_qa_system_tpu_torch.models import CausalLM, causal_from_leaves
    from vietnamese_qa_system_tpu_torch.models import config as mcfg
    from vietnamese_qa_system_tpu_torch.train.checkpoint import load_pytree

    ckpt = str(tmp_path / "ckpt")
    argv = ["train", "--model-size", "tiny", "--use-lora", "--lora-r", "4", "--lora-alpha", "8", "--lr", "1e-2",
            "--train-files", os.path.join(ROOT, "examples", "sample_instruct.jsonl"), "--max-steps", "1",
            "--batch-size", "2", "--max-len", "256", "--checkpoint-dir", ckpt, "--save-every-steps", "1",
            "--log-dir", str(tmp_path / "logs"), "--device", "cpu"]
    assert cli(argv + (["--quantize-base", "int8"] if base == "int8" else [])) == 0
    cfg = mcfg.tiny_test("causal")
    if base == "int8":
        with pytest.raises(ValueError, match="quantized base"):
            load_converted_params(ckpt, cfg, "cpu")
        return
    merged = load_converted_params(ckpt, cfg, "cpu").state_dict()
    step = sorted(os.listdir(ckpt), key=lambda d: int(d.split("_")[1]) if d.startswith("step_") else -1)[-1]
    with np.load(os.path.join(ckpt, step, "state.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    n_params = len(CausalLM(cfg, device="meta").state_dict())
    start = causal_from_leaves(arrays[-1 - n_params:-1], cfg, device="cpu").state_dict()
    adapter = load_pytree(os.path.join(ckpt, "adapter.npz"))
    names = sorted(n[: -len(".w")] for n in start if n.endswith((".wq.w", ".wk.w", ".wv.w", ".wo.w", ".wi.w")))
    assert len(adapter) == 2 * len(names) and any(leaf.abs().max() > 0 for leaf in adapter[1::2])
    for j, name in enumerate(names):  # the adapter's leaves: per layer, a then b, in sorted path order
        a, b = adapter[2 * j], adapter[2 * j + 1]
        assert torch.equal(merged[name + ".w"], start[name + ".w"] + (a @ b) * 2.0), name
    for name in start:
        if name[: -len(".w")] not in names:
            assert torch.equal(merged[name], start[name]), name


def test_checkpoint_leaves_list_form_and_scan_stacked():
    """A flat leaf list in the JAX order, list-form or scan-stacked (a JAX
    ``scan_layers`` model's checkpoint), loads as the same model."""
    from vietnamese_qa_system_tpu.models import tiny_test as jax_tiny
    from vietnamese_qa_system_tpu_torch.models import causal_from_leaves

    cfg = jax_tiny("causal")
    params = jlm.init_causal_lm(jax.random.key(3), cfg)
    want = causal_from_jax(jax.tree.map(np.asarray, params), _port_cfg(cfg), device="cpu").state_dict()
    for tree in (params, jlm.stack_blocks(params)):
        got = causal_from_leaves([np.asarray(x) for x in jax.tree.leaves(tree)], _port_cfg(cfg), device="cpu")
        _states_equal(got.state_dict(), want)
    with pytest.raises(ValueError, match="leaves do not make"):
        causal_from_leaves([np.asarray(x) for x in jax.tree.leaves(params)][1:], _port_cfg(cfg), device="cpu")


def test_quantize_weight_of_a_transposed_view_is_contiguous():
    """An HF (out, in) weight used through ``.T`` quantizes to the same,
    contiguous codes K6 takes."""
    from vietnamese_qa_system_tpu_torch.models import quantize_weight

    w = torch.randn(96, 64)
    got, want = quantize_weight(w.T, "int8c"), quantize_weight(w.T.contiguous(), "int8c")
    assert got["w_q"].is_contiguous() and torch.equal(got["w_q"], want["w_q"]) and torch.equal(got["w_s"], want["w_s"])


def test_jax_load_converted_params_misses_mpt_dirs(saved):
    """JAX ``load_converted_params`` dispatches HF directories for six
    model types only: an MPT directory (PhoGPT-4B's architecture) falls
    through to the checkpoint manager, while its own ``load_causal_auto``
    and the port load it."""
    from vietnamese_qa_system_tpu.cli.main import load_converted_params as jax_load
    from vietnamese_qa_system_tpu_torch.cli.main import load_converted_params as port_load

    d = saved["mpt"][1]["safetensors"]
    jparams, jcfg = jconv.load_causal_auto(d)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        jax_load(d, jcfg)
    port = port_load(d, _port_cfg(jcfg), "cpu")
    _states_equal(port.state_dict(),
                  causal_from_jax(jax.tree.map(np.asarray, jparams), _port_cfg(jcfg), device="cpu").state_dict())


# ------------------------------------------------------ seq2seq directories

# family -> (config class, its keyword arguments, JAX *_config)
SEQ2SEQ = {
    "t5": (transformers.T5Config, dict(vocab_size=128, d_model=64, d_kv=16, d_ff=96, num_layers=2,
                                       num_decoder_layers=3, num_heads=4, relative_attention_num_buckets=8,
                                       relative_attention_max_distance=20), jconv.t5_config),
    "mt5": (transformers.MT5Config, dict(vocab_size=128, d_model=64, d_kv=16, d_ff=96, num_layers=2, num_heads=4,
                                         relative_attention_num_buckets=8), jconv.t5_config),
    "mbart": (transformers.MBartConfig, dict(vocab_size=128, d_model=64, encoder_layers=2, decoder_layers=2,
                                             encoder_attention_heads=4, decoder_attention_heads=4,
                                             encoder_ffn_dim=128, decoder_ffn_dim=128, max_position_embeddings=64,
                                             scale_embedding=True), jconv.mbart_config),
}
# attributes of the transformers classes that hf_config must answer as they do
SEQ2SEQ_ATTRS = {
    "t5": ("feed_forward_proj", "is_gated_act", "dense_act_fn", "tie_word_embeddings", "num_decoder_layers",
           "relative_attention_max_distance", "layer_norm_epsilon", "d_kv", "num_heads", "hidden_size",
           "num_attention_heads", "num_hidden_layers", "pad_token_id", "eos_token_id"),
    "mbart": ("scale_embedding", "forced_eos_token_id", "activation_function", "max_position_embeddings",
              "num_attention_heads", "hidden_size", "pad_token_id", "eos_token_id", "bos_token_id"),
}


@pytest.fixture(scope="module")
def saved_s2s(tmp_path_factory):
    """family -> (HF model, directory of one safetensors file)."""
    out = {}
    for family, (cls, kw, _) in SEQ2SEQ.items():
        torch.manual_seed(sum(map(ord, family)))
        model_cls = transformers.MBartForConditionalGeneration if family == "mbart" else (
            transformers.MT5ForConditionalGeneration if family == "mt5" else transformers.T5ForConditionalGeneration)
        model = model_cls(cls(**kw)).eval()
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
            if family == "mbart":
                model.final_logits_bias.add_(0.05 * torch.randn(model.final_logits_bias.shape, generator=g))
        d = str(tmp_path_factory.mktemp(family))
        model.save_pretrained(d)
        out[family] = (model, d)
    return out


@pytest.mark.parametrize("family", list(SEQ2SEQ))
def test_seq2seq_import_equals_jax(saved_s2s, family):
    """Config and tensors of the port's import equal JAX
    ``load_seq2seq_auto``'s carried across; streamed int8c equals
    quantizing the loaded model; logits agree with transformers."""
    from vietnamese_qa_system_tpu_torch.models import seq2seq_from_hf, seq2seq_from_jax

    model, d = saved_s2s[family]
    jparams, jcfg = jconv.load_seq2seq_auto(d)
    port_cfg = tconv.seq2seq_family(family).config(tconv.hf_config(d))
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jcfg)
    want = seq2seq_from_jax(jax.tree.map(np.asarray, jparams), _port_cfg(jcfg), device="cpu").state_dict()
    got = seq2seq_from_hf(d, device="cpu")
    _states_equal(got.state_dict(), want)
    assert (family == "mbart") == (got.state_dict().get("logits_bias") is not None)
    tree, cfg = tconv.load_seq2seq_auto(d)
    assert cfg == port_cfg and sorted(tree) == sorted(jparams)
    _states_equal(seq2seq_from_hf(d, device="cpu", quantize="int8c").state_dict(),
                  quantize_dense_tree(seq2seq_from_hf(d, device="cpu"), "int8c").state_dict())
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.integers(3, 128, (2, 10)))
    mask = torch.ones_like(enc)
    mask[1, 7:] = 0
    dec = torch.from_numpy(rng.integers(3, 128, (2, 6)))
    with torch.inference_mode():
        want_logits = model(input_ids=enc, attention_mask=mask, decoder_input_ids=dec).logits.numpy()
        got_logits = got({"input_ids": enc, "attention_mask": mask, "decoder_input_ids": dec}).numpy()
    if family == "mbart":
        np.testing.assert_allclose(got_logits, want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    else:
        # tests/test_t5.py's envelope: T5 attention is unscaled, so its bf16
        # noise runs larger (a few tail logits ~0.2 off at magnitudes ~10)
        diff = np.abs(got_logits - want_logits)
        assert np.quantile(diff, 0.995) < 0.3 and diff.max() < 1.0, (np.quantile(diff, 0.995), diff.max())
    assert (got_logits.argmax(-1) == want_logits.argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("minimal", [False, True])
@pytest.mark.parametrize("family", list(SEQ2SEQ))
def test_seq2seq_config_json_reads_as_transformers(tmp_path, family, minimal):
    """A full config.json, or one holding only model_type: the port's view
    answers as ``AutoConfig`` does, and its ModelConfig equals JAX's."""
    cls, kw, jax_config = SEQ2SEQ[family]
    raw = {"model_type": cls.model_type} if minimal else cls(**kw).to_dict()
    (tmp_path / "config.json").write_text(json.dumps(raw))
    hf = transformers.AutoConfig.from_pretrained(str(tmp_path))
    view = tconv.hf_config(str(tmp_path))
    for attr in SEQ2SEQ_ATTRS["mbart" if family == "mbart" else "t5"]:
        assert getattr(view, attr) == getattr(hf, attr), attr
    fam = tconv.seq2seq_family(cls.model_type)
    assert dataclasses.asdict(fam.config(view)) == dataclasses.asdict(jax_config(hf))


def test_jax_load_converted_params_misses_mbart_dirs(saved_s2s):
    """JAX ``load_converted_params`` dispatches t5 / mt5 / longt5
    directories only: an mBART one (vinai-translate's architecture) falls
    through to the checkpoint manager, while its own ``load_seq2seq_auto``
    and the port (here through ``chat --arch seq2seq --init-params``) load it."""
    from vietnamese_qa_system_tpu.cli.main import load_converted_params as jax_load
    from vietnamese_qa_system_tpu_torch.cli.main import load_converted_params as port_load
    from vietnamese_qa_system_tpu_torch.models import seq2seq_from_jax

    d = saved_s2s["mbart"][1]
    jparams, jcfg = jconv.load_seq2seq_auto(d)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        jax_load(d, jcfg)
    port = port_load(d, _port_cfg(jcfg), "cpu")
    _states_equal(port.state_dict(), seq2seq_from_jax(jax.tree.map(np.asarray, jparams), _port_cfg(jcfg),
                                                      device="cpu").state_dict())


def test_seq2seq_dirs_through_the_cli(saved_s2s, tmp_path, monkeypatch, capsys):
    """``chat --arch seq2seq --init-params`` over an mBART directory (its own
    configuration: no preset of its family) and an mT5 one against the
    ``mt5small`` preset, which it does not match, raising."""
    cls, kw, _ = SEQ2SEQ["mbart"]
    torch.manual_seed(0)
    transformers.MBartForConditionalGeneration(cls(**dict(kw, vocab_size=300))).save_pretrained(str(tmp_path))
    lines = iter(["xin chào", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert cli(["chat", "--arch", "seq2seq", "--init-params", str(tmp_path), "--max-new-tokens", "3",
                "--num-beams", "2", "--max-len", "48", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "loaded with its own configuration" in out and "model> " in out
    with pytest.raises(ValueError, match="another model than the configuration"):
        cli(["chat", "--arch", "seq2seq", "--model-size", "mt5small", "--init-params", saved_s2s["mt5"][1],
             "--device", "cpu"])
