"""Import and export of local Hugging Face checkpoints: the causal
families (GPT-NeoX, GPT-Neo, GPT-2, Llama / Mistral, Qwen2, Gemma, BLOOM,
MPT), the BERT / MPNet encoders and the T5 / mT5 / LongT5 and mBART
encoder-decoders.

Counterpart of ``vietnamese_qa_system_tpu/models/convert_hf.py``: the ``*_config``
functions, the converters (which map an HF state dict onto the JAX
package's parameter tree, here with f32 tensors for leaves; one
:class:`Family` each, applied by :func:`convert`) and the
``load_causal_auto`` / ``load_encoder_auto`` / ``load_seq2seq_auto``
dispatch on ``model_type`` (``convert_t5`` / ``load_t5`` and
``convert_mbart`` / ``load_mbart`` are the seq2seq families' wrappers).
The other per-family ``convert_*`` / ``load_*`` wrappers are thin over
the :data:`FAMILIES` table.  The export half (``to_*_state_dict``,
``export_*``, ``export_causal_auto``, ``to_t5_state_dict`` /
``export_t5``) takes the port's module and writes the directory the JAX
package's ``save_pretrained`` leaves, through :mod:`.hf_io`, one layer at
a time.

Nothing here imports ``transformers``.  A directory is read by
:mod:`.hf_io`, and the ``*_config`` functions take :func:`hf_config`, a view
of ``config.json`` that answers every attribute the way the transformers
config class of its ``model_type`` would: the keys of the file, then the
class's defaults, with the class's attribute aliases and the fields its
constructor derives (GPT-Neo's ``attention_layers``, Qwen2's
``sliding_window``, MPT's nested ``attn_config``, ...).

Each converter is written per layer (``_<family>_layer``) and for the
rest of the tree (``_<family>_rest``), so ``models/params.py`` can stream
a multi-billion-parameter checkpoint onto the card one layer at a time.
Weights may carry their class's prefix or not (``gpt_neox.``,
``transformer.``, ``model.``, ``bert.``, ``mpnet.``); a tied head needs no
``lm_head`` tensor; a missing weight raises ``KeyError`` naming it.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Mapping, NamedTuple, Optional

import torch

from .config import ModelConfig
from .hf_io import Checkpoint, read_config
from .quantize import dequantized_weight

# ---------------------------------------------------------------------------
# config.json as the transformers config class would read it
# ---------------------------------------------------------------------------

# PretrainedConfig's own defaults of the attributes the *_config functions read
_BASE = {"tie_word_embeddings": True, "pad_token_id": None}
# each class's constructor defaults (transformers 4.57) of those attributes
_DEFAULTS = {
    "bert": dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512, layer_norm_eps=1e-12, pad_token_id=0),
    "mpnet": dict(vocab_size=30527, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                  intermediate_size=3072, max_position_embeddings=512, layer_norm_eps=1e-12,
                  relative_attention_num_buckets=32, pad_token_id=1),
    "gpt_neox": dict(vocab_size=50432, hidden_size=6144, num_hidden_layers=44, num_attention_heads=64,
                     intermediate_size=24576, rotary_pct=0.25, rotary_emb_base=10000, max_position_embeddings=2048,
                     layer_norm_eps=1e-5, tie_word_embeddings=False, use_parallel_residual=True),
    "gpt_neo": dict(vocab_size=50257, max_position_embeddings=2048, hidden_size=2048, num_layers=24,
                    attention_types=[[["global", "local"], 12]], num_heads=16, intermediate_size=None,
                    window_size=256, layer_norm_epsilon=1e-5),
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12, n_head=12, n_inner=None,
                 layer_norm_epsilon=1e-5),
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
                  num_attention_heads=32, num_key_value_heads=None, max_position_embeddings=2048, rms_norm_eps=1e-6,
                  tie_word_embeddings=False, rope_theta=10000.0, attention_bias=False, head_dim=None),
    "mistral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8, head_dim=None, max_position_embeddings=4096 * 32,
                    rms_norm_eps=1e-6, tie_word_embeddings=False, rope_theta=10000.0, sliding_window=4096),
    "qwen2": dict(vocab_size=151936, hidden_size=4096, intermediate_size=22016, num_hidden_layers=32,
                  num_attention_heads=32, num_key_value_heads=32, max_position_embeddings=32768, rms_norm_eps=1e-6,
                  tie_word_embeddings=False, rope_theta=10000.0, use_sliding_window=False, sliding_window=4096,
                  max_window_layers=28),
    "gemma": dict(vocab_size=256000, hidden_size=3072, intermediate_size=24576, num_hidden_layers=28,
                  num_attention_heads=16, num_key_value_heads=16, head_dim=256, max_position_embeddings=8192,
                  rms_norm_eps=1e-6, pad_token_id=0, tie_word_embeddings=True, rope_theta=10000.0,
                  attention_bias=False),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8, layer_norm_epsilon=1e-5,
                  apply_residual_connection_post_layernorm=False),
    "mpt": dict(d_model=2048, n_heads=16, n_layers=24, expansion_ratio=4, max_seq_len=2048, vocab_size=50368,
                layer_norm_epsilon=1e-5, no_bias=True, attn_config=None),
    "t5": dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6, num_decoder_layers=None, num_heads=8,
               relative_attention_num_buckets=32, relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
               feed_forward_proj="relu", pad_token_id=0, eos_token_id=1),
    "mt5": dict(vocab_size=250112, d_model=512, d_kv=64, d_ff=1024, num_layers=8, num_decoder_layers=None,
                num_heads=6, relative_attention_num_buckets=32, relative_attention_max_distance=128,
                layer_norm_epsilon=1e-6, feed_forward_proj="gated-gelu", tie_word_embeddings=False, pad_token_id=0,
                eos_token_id=1, decoder_start_token_id=0),
    "longt5": dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6, num_decoder_layers=None,
                   num_heads=8, relative_attention_num_buckets=32, relative_attention_max_distance=128,
                   layer_norm_epsilon=1e-6, feed_forward_proj="relu", pad_token_id=0, eos_token_id=1),
    "mbart": dict(vocab_size=50265, max_position_embeddings=1024, encoder_layers=12, encoder_ffn_dim=4096,
                  encoder_attention_heads=16, decoder_layers=12, decoder_ffn_dim=4096, decoder_attention_heads=16,
                  activation_function="gelu", d_model=1024, scale_embedding=False, pad_token_id=1, bos_token_id=0,
                  eos_token_id=2, forced_eos_token_id=2),
}
T5_TYPES = ("t5", "mt5", "longt5")
# MptAttentionConfig's defaults
_MPT_ATTN = dict(attn_type="multihead_attention", attn_pdrop=0, attn_impl="torch", clip_qkv=None, softmax_scale=None,
                 prefix_lm=False, qk_ln=False, attn_uses_sequence_id=False, alibi=True, alibi_bias_max=8)
# each class's attribute_map: the standard name -> the name it stores
_ALIASES = {
    "gpt_neo": {"num_attention_heads": "num_heads", "num_hidden_layers": "num_layers"},
    "gpt2": {"hidden_size": "n_embd", "max_position_embeddings": "n_positions", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "bloom": {"num_hidden_layers": "n_layer", "num_attention_heads": "n_head"},
    "mpt": {"num_attention_heads": "n_heads", "hidden_size": "d_model", "num_hidden_layers": "n_layers"},
    **{t: {"hidden_size": "d_model", "num_attention_heads": "num_heads", "num_hidden_layers": "num_layers",
           "head_dim": "d_kv"} for t in T5_TYPES},
    "mbart": {"num_attention_heads": "encoder_attention_heads", "hidden_size": "d_model"},
}


class _ConfigView(types.SimpleNamespace):
    """Attribute access with the class's aliases (``getattr`` and
    ``hasattr`` see exactly the attributes the class would have)."""

    def __getattribute__(self, name):
        aliases = object.__getattribute__(self, "__dict__").get("_aliases", {})
        return object.__getattribute__(self, aliases.get(name, name))


def _expand_attention_types(attention_types) -> list:
    """GPTNeoConfig.expand_attention_types_params."""
    out = []
    for kinds, repeat in attention_types:
        for _ in range(repeat):
            out.extend(kinds)
    return out


def hf_config(source) -> _ConfigView:
    """A model directory's ``config.json`` (or that dict) as the
    transformers config class of its ``model_type`` reads it; an unknown
    or missing ``model_type`` keeps the file's keys only."""
    raw = read_config(source) if isinstance(source, str) else dict(source)
    model_type = raw.get("model_type", "")
    aliases = _ALIASES.get(model_type, {})
    values = dict(_BASE, **_DEFAULTS.get(model_type, {}))
    for key, value in raw.items():
        values[aliases.get(key, key)] = value
    if model_type == "bloom" and raw.get("n_embed") is not None:
        values["hidden_size"] = raw["n_embed"]
    if model_type in ("llama", "mistral", "qwen2") and values.get("num_key_value_heads") is None:
        values["num_key_value_heads"] = values["num_attention_heads"]
    if model_type == "llama" and values.get("head_dim") is None:
        values["head_dim"] = values["hidden_size"] // values["num_attention_heads"]
    if model_type == "qwen2" and not values["use_sliding_window"]:
        values["sliding_window"] = None
    if model_type == "gpt_neo":
        values["attention_layers"] = _expand_attention_types(values["attention_types"])
        if len(values["attention_layers"]) != values["num_layers"]:
            raise ValueError(f"GPT-Neo attention_types give {len(values['attention_layers'])} layers for "
                             f"num_layers={values['num_layers']}")
    if model_type == "mpt":
        values["attn_config"] = types.SimpleNamespace(**dict(_MPT_ATTN, **(values["attn_config"] or {})))
    if model_type in T5_TYPES:
        # T5Config.__init__: the decoder depth defaults to the encoder's,
        # and feed_forward_proj "[gated-]act" splits into the two flags
        if values["num_decoder_layers"] is None:
            values["num_decoder_layers"] = values["num_layers"]
        act = values["feed_forward_proj"].split("-")
        if len(act) > 1 and act[0] != "gated" or len(act) > 2:
            raise ValueError(f"`feed_forward_proj`: {values['feed_forward_proj']} is not a valid activation function "
                             "of the dense layer")
        values["dense_act_fn"] = "gelu_new" if values["feed_forward_proj"] == "gated-gelu" else act[-1]
        values["is_gated_act"] = act[0] == "gated"
    values["_aliases"] = aliases
    return _ConfigView(**values)


# ---------------------------------------------------------------------------
# weights by name, with the family's prefixes
# ---------------------------------------------------------------------------


class _Weights:
    """``w(name)``: the tensor ``name`` (or ``name`` with the family's
    prefixes added or removed) as f32 on ``device``; ``w.has(name)``."""

    def __init__(self, state: Mapping, prefixes: tuple = (), device=None, root: str = ""):
        self.state = state
        self.prefixes = prefixes
        self.device = device
        self.root = root

    def _key(self, name: str) -> Optional[str]:
        candidates = [name]
        for p in self.prefixes:
            candidates.append(name[len(p):] if name.startswith(p) else p + name)
        return next((self.root + k for k in candidates if self.root + k in self.state), None)

    def has(self, name: str) -> bool:
        return self._key(name) is not None

    def __call__(self, name: str) -> torch.Tensor:
        key = self._key(name)
        if key is None:
            raise KeyError(f"missing weight {name!r} in state dict")
        t = self.state[key]
        if self.device is not None:
            t = t.to(self.device)
        return t.detach().float()


def _linear(w: _Weights, name: str, bias: bool = True) -> dict:
    """An HF Linear (out, in) -> {"w" (in, out)[, "b"]}."""
    p = {"w": w(name + ".weight").T.contiguous()}
    if bias:
        p["b"] = w(name + ".bias")
    return p


def _ln(w: _Weights, name: str) -> dict:
    return {"scale": w(name + ".weight"), "bias": w(name + ".bias")}


def _fused_heads(w_qkv: torch.Tensor, b_qkv: torch.Tensor, h: int, dh: int, d: int) -> dict:
    """A fused QKV packed head-interleaved ((H, 3, Dh) rows: GPT-NeoX,
    BLOOM) -> head-major q / k / v projections."""
    w = w_qkv.reshape(h, 3, dh, d)
    b = b_qkv.reshape(h, 3, dh)
    return {name: {"w": w[:, j].reshape(h * dh, d).T.contiguous(), "b": b[:, j].reshape(h * dh).contiguous()}
            for j, name in enumerate(("wq", "wk", "wv"))}


# ---------------------------------------------------------------------------
# GPT-NeoX (pythia)
# ---------------------------------------------------------------------------


def neox_config(hf_cfg) -> ModelConfig:
    """GPT-NeoX config -> ModelConfig."""
    return ModelConfig(
        arch="causal",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=hf_cfg.num_attention_heads,
        n_layers=hf_cfg.num_hidden_layers,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=float(getattr(hf_cfg, "rotary_emb_base", 10000.0)),
        rope_pct=float(getattr(hf_cfg, "rotary_pct", 1.0)),
        parallel_residual=bool(getattr(hf_cfg, "use_parallel_residual", True)),
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        norm_eps=float(getattr(hf_cfg, "layer_norm_eps", 1e-5)),
    )


def _neox_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    pre = f"gpt_neox.layers.{i}."
    attn = _fused_heads(w(pre + "attention.query_key_value.weight"), w(pre + "attention.query_key_value.bias"),
                        cfg.n_heads, cfg.head_dim, cfg.d_model)
    attn["wo"] = _linear(w, pre + "attention.dense")
    return {
        "ln1": _ln(w, pre + "input_layernorm"),
        "attn": attn,
        "ln2": _ln(w, pre + "post_attention_layernorm"),
        "mlp": {"wi": _linear(w, pre + "mlp.dense_h_to_4h"), "wo": _linear(w, pre + "mlp.dense_4h_to_h")},
    }


def _neox_rest(w: _Weights, cfg: ModelConfig) -> dict:
    params = {"tok_embed": w("gpt_neox.embed_in.weight"), "ln_f": _ln(w, "gpt_neox.final_layer_norm")}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": w("embed_out.weight").T.contiguous()}
    return params


# ---------------------------------------------------------------------------
# GPT-Neo and GPT-2
# ---------------------------------------------------------------------------


def gpt_neo_config(hf_cfg) -> ModelConfig:
    """GPT-Neo config -> ModelConfig: learned positions, no attention
    scaling, per-layer global/local attention, gelu_new, tied head."""
    return ModelConfig(
        arch="causal",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=hf_cfg.num_heads,
        n_layers=hf_cfg.num_layers,
        d_ff=getattr(hf_cfg, "intermediate_size", None) or 4 * hf_cfg.hidden_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        positional="learned",
        norm_eps=float(getattr(hf_cfg, "layer_norm_epsilon", 1e-5)),
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", True)),
        attention_scale=1.0,
        attention_layers=tuple(hf_cfg.attention_layers),
        attention_window=int(getattr(hf_cfg, "window_size", 256)),
        activation="gelu_new",
    )


def _gpt_neo_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    pre = f"h.{i}."
    return {
        "ln1": _ln(w, pre + "ln_1"),
        "attn": {
            "wq": _linear(w, pre + "attn.attention.q_proj", bias=False),
            "wk": _linear(w, pre + "attn.attention.k_proj", bias=False),
            "wv": _linear(w, pre + "attn.attention.v_proj", bias=False),
            "wo": _linear(w, pre + "attn.attention.out_proj"),
        },
        "ln2": _ln(w, pre + "ln_2"),
        "mlp": {"wi": _linear(w, pre + "mlp.c_fc"), "wo": _linear(w, pre + "mlp.c_proj")},
    }


def _learned_rest(w: _Weights, cfg: ModelConfig) -> dict:
    return {"tok_embed": w("wte.weight"), "pos_embed": w("wpe.weight"), "ln_f": _ln(w, "ln_f")}


def gpt2_config(hf_cfg) -> ModelConfig:
    """GPT-2 config -> ModelConfig (learned positions, scaled attention,
    gelu_new, tied head)."""
    return ModelConfig(
        arch="causal",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.n_embd,
        n_heads=hf_cfg.n_head,
        n_layers=hf_cfg.n_layer,
        d_ff=getattr(hf_cfg, "n_inner", None) or 4 * hf_cfg.n_embd,
        max_seq_len=hf_cfg.n_positions,
        positional="learned",
        norm_eps=float(getattr(hf_cfg, "layer_norm_epsilon", 1e-5)),
        tie_embeddings=True,
        activation="gelu_new",
    )


def _gpt2_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    """GPT-2 blocks use Conv1D weights stored (in, out) -- no transpose --
    and a fused c_attn whose output columns are [q | k | v]."""
    d = cfg.d_model
    pre = f"h.{i}."

    def conv1d(name):
        return {"w": w(name + ".weight"), "b": w(name + ".bias")}

    w_qkv = w(pre + "attn.c_attn.weight")  # (D, 3D)
    b_qkv = w(pre + "attn.c_attn.bias")
    attn = {name: {"w": w_qkv[:, j * d:(j + 1) * d].contiguous(), "b": b_qkv[j * d:(j + 1) * d].contiguous()}
            for j, name in enumerate(("wq", "wk", "wv"))}
    attn["wo"] = conv1d(pre + "attn.c_proj")
    return {
        "ln1": _ln(w, pre + "ln_1"),
        "attn": attn,
        "ln2": _ln(w, pre + "ln_2"),
        "mlp": {"wi": conv1d(pre + "mlp.c_fc"), "wo": conv1d(pre + "mlp.c_proj")},
    }


# ---------------------------------------------------------------------------
# Llama, Mistral, Qwen2, Gemma
# ---------------------------------------------------------------------------


def llama_config(hf_cfg) -> ModelConfig:
    """Llama config (Mistral-style configs too) -> ModelConfig: RMSNorm,
    SwiGLU, GQA, full-dim RoPE, bias-free projections.  A bare
    ``sliding_window`` with no Qwen2-style ``use_sliding_window`` gate
    (Mistral) makes every layer local: the flash kernel's window form."""
    n_heads = hf_cfg.num_attention_heads
    n_kv = int(getattr(hf_cfg, "num_key_value_heads", n_heads))
    window = getattr(hf_cfg, "sliding_window", None)
    local = window is not None and not hasattr(hf_cfg, "use_sliding_window")
    return ModelConfig(
        arch="causal",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=n_heads,
        n_layers=hf_cfg.num_hidden_layers,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=float(getattr(hf_cfg, "rope_theta", 10000.0)),
        norm="rmsnorm",
        norm_eps=float(getattr(hf_cfg, "rms_norm_eps", 1e-6)),
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        n_kv_heads=None if n_kv == n_heads else n_kv,
        mlp_gated=True,
        attention_bias=bool(getattr(hf_cfg, "attention_bias", False)),
        attention_layers=("local",) * hf_cfg.num_hidden_layers if local else None,
        attention_window=int(window) if local else 256,
    )


def qwen2_config(hf_cfg) -> ModelConfig:
    """Qwen2 config -> ModelConfig: the llama layout with q/k/v-only
    projection biases; sliding windows only on layers >= max_window_layers."""
    base = llama_config(hf_cfg)
    extra = {}
    if bool(getattr(hf_cfg, "use_sliding_window", False)) and getattr(hf_cfg, "sliding_window", None):
        mwl = int(getattr(hf_cfg, "max_window_layers", hf_cfg.num_hidden_layers))
        extra["attention_layers"] = tuple("global" if i < mwl else "local" for i in range(hf_cfg.num_hidden_layers))
        extra["attention_window"] = int(hf_cfg.sliding_window)
    return dataclasses.replace(base, attention_bias="qkv", **extra)


def gemma_config(hf_cfg) -> ModelConfig:
    """Gemma config -> ModelConfig: the llama layout plus a GeGLU (tanh)
    gate, sqrt(d_model) embedding scaling, an explicit head_dim, and
    (1 + weight) RMSNorms folded into the imported scales."""
    base = llama_config(hf_cfg)
    head_dim = int(getattr(hf_cfg, "head_dim", None) or hf_cfg.hidden_size // hf_cfg.num_attention_heads)
    return dataclasses.replace(
        base,
        activation="gelu_new",
        scale_embedding=True,
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", True)),
        d_kv=head_dim if head_dim * hf_cfg.num_attention_heads != hf_cfg.hidden_size else None,
    )


def _llama_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    """HF llama RoPE uses the same half-split rotate convention as the
    port's ``apply_rope``, so q/k import untouched."""
    pre = f"layers.{i}."

    def lin(name):
        return _linear(w, name, bias=w.has(name + ".bias"))

    return {
        "ln1": {"scale": w(pre + "input_layernorm.weight")},
        "attn": {"wq": lin(pre + "self_attn.q_proj"), "wk": lin(pre + "self_attn.k_proj"),
                 "wv": lin(pre + "self_attn.v_proj"), "wo": lin(pre + "self_attn.o_proj")},
        "ln2": {"scale": w(pre + "post_attention_layernorm.weight")},
        "mlp": {"wg": lin(pre + "mlp.gate_proj"), "wi": lin(pre + "mlp.up_proj"), "wo": lin(pre + "mlp.down_proj")},
    }


def _llama_rest(w: _Weights, cfg: ModelConfig) -> dict:
    params = {"tok_embed": w("embed_tokens.weight"), "ln_f": {"scale": w("norm.weight")}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": w("lm_head.weight").T.contiguous()}
    return params


def _gemma_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    """GemmaRMSNorm computes x_hat * (1 + weight): folded into the scale."""
    blk = _llama_layer(w, cfg, i)
    for name in ("ln1", "ln2"):
        blk[name]["scale"] = blk[name]["scale"] + 1.0
    return blk


def _gemma_rest(w: _Weights, cfg: ModelConfig) -> dict:
    params = _llama_rest(w, cfg)
    params["ln_f"]["scale"] = params["ln_f"]["scale"] + 1.0
    return params


# ---------------------------------------------------------------------------
# BLOOM and MPT (ALiBi)
# ---------------------------------------------------------------------------


def bloom_config(hf_cfg) -> ModelConfig:
    """BLOOM config -> ModelConfig (the bloomz / vietcuna family)."""
    if getattr(hf_cfg, "apply_residual_connection_post_layernorm", False):
        raise ValueError("apply_residual_connection_post_layernorm BLOOM variants are not supported (no released "
                         "checkpoint uses it)")
    return ModelConfig(
        arch="causal",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=hf_cfg.n_head,
        n_layers=hf_cfg.n_layer,
        d_ff=4 * hf_cfg.hidden_size,
        max_seq_len=int(getattr(hf_cfg, "seq_length", 2048)),
        positional="alibi",
        embed_layernorm=True,
        tie_embeddings=True,
        norm_eps=float(getattr(hf_cfg, "layer_norm_epsilon", 1e-5)),
        activation="gelu_new",  # BloomGelu is the tanh approximation
    )


def _bloom_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    """The fused query_key_value rows are head-interleaved (H, 3, Dh), as
    GPT-NeoX packs them."""
    pre = f"transformer.h.{i}."
    attn = _fused_heads(w(pre + "self_attention.query_key_value.weight"),
                        w(pre + "self_attention.query_key_value.bias"), cfg.n_heads, cfg.head_dim, cfg.d_model)
    attn["wo"] = _linear(w, pre + "self_attention.dense")
    return {
        "ln1": _ln(w, pre + "input_layernorm"),
        "attn": attn,
        "ln2": _ln(w, pre + "post_attention_layernorm"),
        "mlp": {"wi": _linear(w, pre + "mlp.dense_h_to_4h"), "wo": _linear(w, pre + "mlp.dense_4h_to_h")},
    }


def _bloom_rest(w: _Weights, cfg: ModelConfig) -> dict:
    return {"tok_embed": w("transformer.word_embeddings.weight"),
            "emb_ln": _ln(w, "transformer.word_embeddings_layernorm"), "ln_f": _ln(w, "transformer.ln_f")}


def mpt_config(hf_cfg) -> ModelConfig:
    """MPT config -> ModelConfig (MosaicML MPT: vinai/PhoGPT-4B is
    ``model_type: mpt``): pre-LN with bias-free LayerNorms, a fused
    bias-free Wqkv, MPT-variant ALiBi slopes, optional ``clip_qkv`` and an
    exact-GELU 4x MLP."""
    attn = hf_cfg.attn_config
    if not getattr(attn, "alibi", True):
        raise ValueError("non-ALiBi MPT configs are not supported (transformers' native MptModel is ALiBi-only "
                         "as well)")
    if getattr(attn, "qk_ln", False):
        raise ValueError("qk_ln MPT variants require trust_remote_code in transformers too (native MptAttention "
                         "has no q/k LayerNorm) -- unsupported")
    scale = getattr(attn, "softmax_scale", None)
    return ModelConfig(
        arch="causal",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.d_model,
        n_heads=hf_cfg.n_heads,
        n_layers=hf_cfg.n_layers,
        d_ff=int(hf_cfg.expansion_ratio * hf_cfg.d_model),
        max_seq_len=int(hf_cfg.max_seq_len),
        positional="alibi",
        alibi_mode="mpt",
        alibi_bias_max=float(getattr(attn, "alibi_bias_max", 8)),
        clip_qkv=float(attn.clip_qkv) if getattr(attn, "clip_qkv", None) else None,
        attention_scale=float(scale) if scale is not None else None,
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", True)),
        attention_bias=not bool(getattr(hf_cfg, "no_bias", True)),
        norm_eps=float(getattr(hf_cfg, "layer_norm_epsilon", 1e-5)),
        activation="gelu",  # MptMLP uses nn.GELU(approximate="none")
    )


def _mpt_ln(w: _Weights, name: str, d: int) -> dict:
    """MPT LayerNorms carry no bias on the Hub: zeros keep the tree a
    mean-subtracting LayerNorm."""
    bias = w(name + ".bias") if w.has(name + ".bias") else torch.zeros(d, device=w.device)
    return {"scale": w(name + ".weight"), "bias": bias}


def _mpt_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    """The fused Wqkv rows are feature-major (q = rows [0, d), k = [d, 2d),
    v = [2d, 3d)), unlike BLOOM's head-interleaved packing."""
    d = cfg.d_model
    pre = f"transformer.blocks.{i}."

    def lin(name):
        return _linear(w, name, bias=w.has(name + ".bias"))

    wqkv = w(pre + "attn.Wqkv.weight")  # (3d, d) rows = out features
    attn = {name: {"w": wqkv[j * d:(j + 1) * d].T.contiguous()} for j, name in enumerate(("wq", "wk", "wv"))}
    if w.has(pre + "attn.Wqkv.bias"):
        bqkv = w(pre + "attn.Wqkv.bias")
        for j, name in enumerate(("wq", "wk", "wv")):
            attn[name]["b"] = bqkv[j * d:(j + 1) * d].contiguous()
    attn["wo"] = lin(pre + "attn.out_proj")
    return {
        "ln1": _mpt_ln(w, pre + "norm_1", d),
        "attn": attn,
        "ln2": _mpt_ln(w, pre + "norm_2", d),
        "mlp": {"wi": lin(pre + "ffn.up_proj"), "wo": lin(pre + "ffn.down_proj")},
    }


def _mpt_rest(w: _Weights, cfg: ModelConfig) -> dict:
    params = {"tok_embed": w("transformer.wte.weight"), "ln_f": _mpt_ln(w, "transformer.norm_f", cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": w("lm_head.weight").T.contiguous()}
    return params


# ---------------------------------------------------------------------------
# BERT and MPNet encoders
# ---------------------------------------------------------------------------


def bert_config(hf_cfg) -> ModelConfig:
    """BERT config -> ModelConfig (post-LN, BERT embeddings): the
    BERT-architecture sentence encoders such as MiniLM."""
    return ModelConfig(
        arch="encoder",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=hf_cfg.num_attention_heads,
        n_layers=hf_cfg.num_hidden_layers,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        positional="learned",
        norm_eps=float(getattr(hf_cfg, "layer_norm_eps", 1e-12)),
        norm_position="post",
        bert_embeddings=True,
        use_flash_attention=True,
        activations_bf16=True,
    )


def _bert_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    pre = f"encoder.layer.{i}."
    return {
        "attn": {"wq": _linear(w, pre + "attention.self.query"), "wk": _linear(w, pre + "attention.self.key"),
                 "wv": _linear(w, pre + "attention.self.value"), "wo": _linear(w, pre + "attention.output.dense")},
        "ln1": _ln(w, pre + "attention.output.LayerNorm"),
        "mlp": {"wi": _linear(w, pre + "intermediate.dense"), "wo": _linear(w, pre + "output.dense")},
        "ln2": _ln(w, pre + "output.LayerNorm"),
    }


def _bert_rest(w: _Weights, cfg: ModelConfig) -> dict:
    return {"tok_embed": w("embeddings.word_embeddings.weight"), "pos_embed": w("embeddings.position_embeddings.weight"),
            "type_embed": w("embeddings.token_type_embeddings.weight"), "emb_ln": _ln(w, "embeddings.LayerNorm")}


def mpnet_config(hf_cfg) -> ModelConfig:
    """MPNet config -> ModelConfig (post-LN, embedding LN, RoBERTa position
    offset, shared bucketed relative attention bias)."""
    return ModelConfig(
        arch="encoder",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_heads=hf_cfg.num_attention_heads,
        n_layers=hf_cfg.num_hidden_layers,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        positional="learned",
        norm_eps=float(getattr(hf_cfg, "layer_norm_eps", 1e-5)),
        norm_position="post",
        embed_layernorm=True,
        position_offset=int(getattr(hf_cfg, "pad_token_id", 1)) + 1,
        relative_attention_buckets=int(getattr(hf_cfg, "relative_attention_num_buckets", 32)),
        use_flash_attention=True,
        activations_bf16=True,
    )


def _mpnet_layer(w: _Weights, cfg: ModelConfig, i: int) -> dict:
    pre = f"encoder.layer.{i}."
    return {
        "attn": {"wq": _linear(w, pre + "attention.attn.q"), "wk": _linear(w, pre + "attention.attn.k"),
                 "wv": _linear(w, pre + "attention.attn.v"), "wo": _linear(w, pre + "attention.attn.o")},
        "ln1": _ln(w, pre + "attention.LayerNorm"),
        "mlp": {"wi": _linear(w, pre + "intermediate.dense"), "wo": _linear(w, pre + "output.dense")},
        "ln2": _ln(w, pre + "output.LayerNorm"),
    }


def _mpnet_rest(w: _Weights, cfg: ModelConfig) -> dict:
    return {"tok_embed": w("embeddings.word_embeddings.weight"), "pos_embed": w("embeddings.position_embeddings.weight"),
            "emb_ln": _ln(w, "embeddings.LayerNorm"), "rel_bias": w("encoder.relative_attention_bias.weight")}


# ---------------------------------------------------------------------------
# T5 / mT5 / LongT5 and mBART encoder-decoders
# ---------------------------------------------------------------------------


def t5_config(hf_cfg) -> ModelConfig:
    """T5 / mT5 config -> ModelConfig (models/t5.py family)."""
    ff_proj = str(getattr(hf_cfg, "feed_forward_proj", "relu"))
    gated = bool(getattr(hf_cfg, "is_gated_act", "gated" in ff_proj))
    return ModelConfig(
        arch="seq2seq",
        seq2seq_family="t5",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.d_model,
        n_heads=hf_cfg.num_heads,
        d_kv=hf_cfg.d_kv,
        n_layers=hf_cfg.num_layers,
        n_decoder_layers=int(getattr(hf_cfg, "num_decoder_layers", None) or hf_cfg.num_layers),
        d_ff=hf_cfg.d_ff,
        max_seq_len=1024,  # T5 has no absolute position table
        mlp_gated=gated,
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", True)),
        relative_attention_buckets=int(hf_cfg.relative_attention_num_buckets),
        relative_attention_max_distance=int(getattr(hf_cfg, "relative_attention_max_distance", 128)),
        norm_eps=float(getattr(hf_cfg, "layer_norm_epsilon", 1e-6)),
        attention_bias=False,
    )


def _t5_attn(w: _Weights, pre: str) -> dict:
    return {name: _linear(w, f"{pre}.{hf}", bias=False) for name, hf in (("wq", "q"), ("wk", "k"), ("wv", "v"),
                                                                          ("wo", "o"))}


def _t5_layer(w: _Weights, cfg: ModelConfig, where) -> dict:
    """HF encoder block = [0: SelfAttention, 1: FFN]; decoder block = [0:
    SelfAttention, 1: EncDecAttention, 2: FFN].  A gated FFN stores the
    gelu gate as wi_0 (``wg``) and the linear branch as wi_1 (``wi``)."""
    stack, i = where
    pre = f"{'encoder' if stack == 'enc_blocks' else 'decoder'}.block.{i}.layer."
    ff = 1 if stack == "enc_blocks" else 2
    dense = pre + f"{ff}.DenseReluDense."
    if cfg.mlp_gated:
        mlp = {"wg": _linear(w, dense + "wi_0", bias=False), "wi": _linear(w, dense + "wi_1", bias=False),
               "wo": _linear(w, dense + "wo", bias=False)}
    else:
        mlp = {"wi": _linear(w, dense + "wi", bias=False), "wo": _linear(w, dense + "wo", bias=False)}
    p = {"ln1": {"scale": w(pre + "0.layer_norm.weight")}, "attn": _t5_attn(w, pre + "0.SelfAttention"),
         "ln2": {"scale": w(pre + f"{ff}.layer_norm.weight")}, "mlp": mlp}
    if ff == 2:
        p["ln_cross"] = {"scale": w(pre + "1.layer_norm.weight")}
        p["cross_attn"] = _t5_attn(w, pre + "1.EncDecAttention")
    return p


def _t5_rest(w: _Weights, cfg: ModelConfig) -> dict:
    """The shared relative bias of each stack lives on its block 0."""
    params = {
        "tok_embed": w("shared.weight"),
        "enc_rel_bias": w("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "dec_rel_bias": w("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "enc_ln_f": {"scale": w("encoder.final_layer_norm.weight")},
        "dec_ln_f": {"scale": w("decoder.final_layer_norm.weight")},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": w("lm_head.weight").T.contiguous()}
    return params


def mbart_config(hf_cfg) -> ModelConfig:
    """MBart config -> ModelConfig (models/bart.py family)."""
    if hf_cfg.encoder_attention_heads != hf_cfg.decoder_attention_heads:
        raise ValueError("mbart import requires equal enc/dec head counts")
    if hf_cfg.encoder_ffn_dim != hf_cfg.decoder_ffn_dim:
        raise ValueError("mbart import requires equal enc/dec FFN dims")
    return ModelConfig(
        arch="seq2seq",
        seq2seq_family="bart",
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.d_model,
        n_heads=int(hf_cfg.encoder_attention_heads),
        n_layers=int(hf_cfg.encoder_layers),
        n_decoder_layers=int(hf_cfg.decoder_layers),
        d_ff=int(hf_cfg.encoder_ffn_dim),
        max_seq_len=int(hf_cfg.max_position_embeddings),
        positional="learned",
        activation=str(getattr(hf_cfg, "activation_function", "gelu")),
        scale_embedding=bool(getattr(hf_cfg, "scale_embedding", False)),
        tie_embeddings=True,
        norm_eps=1e-5,  # torch nn.LayerNorm's default, which HF MBart layers keep
        attention_bias=True,
    )


def _mbart_attn(w: _Weights, pre: str) -> dict:
    return {name: _linear(w, f"{pre}.{hf}") for name, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                                                              ("wo", "out_proj"))}


def _mbart_layer(w: _Weights, cfg: ModelConfig, where) -> dict:
    stack, i = where
    pre = f"{'encoder' if stack == 'enc_blocks' else 'decoder'}.layers.{i}."
    p = {"ln1": _ln(w, pre + "self_attn_layer_norm"), "attn": _mbart_attn(w, pre + "self_attn"),
         "ln2": _ln(w, pre + "final_layer_norm"),
         "mlp": {"fc1": _linear(w, pre + "fc1"), "fc2": _linear(w, pre + "fc2")}}
    if stack == "dec_blocks":
        p["ln_cross"] = _ln(w, pre + "encoder_attn_layer_norm")
        p["cross_attn"] = _mbart_attn(w, pre + "encoder_attn")
    return p


def _mbart_rest(w: _Weights, cfg: ModelConfig) -> dict:
    """``final_logits_bias`` (a zeros buffer in published checkpoints) is
    kept only when nonzero: its presence is self-describing (bart.py)."""
    params = {
        "tok_embed": w("shared.weight"),
        "enc_pos_embed": w("encoder.embed_positions.weight"),
        "dec_pos_embed": w("decoder.embed_positions.weight"),
        "enc_ln_emb": _ln(w, "encoder.layernorm_embedding"),
        "dec_ln_emb": _ln(w, "decoder.layernorm_embedding"),
        "enc_ln_f": _ln(w, "encoder.layer_norm"),
        "dec_ln_f": _ln(w, "decoder.layer_norm"),
    }
    if w.has("final_logits_bias"):
        bias = w("final_logits_bias").reshape(-1)
        if bool((bias != 0.0).any()):
            params["logits_bias"] = bias
    return params


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


class Family(NamedTuple):
    config: Callable  # config view -> ModelConfig
    layer: Callable  # (weights, cfg, i) -> the i-th block of the tree
    rest: Callable  # (weights, cfg) -> the tree without its blocks
    prefixes: tuple  # key prefixes a file may carry or lack
    no_bias: tuple = ()  # dense layers of a block that the files hold without a bias


FAMILIES = {
    "gpt_neox": Family(neox_config, _neox_layer, _neox_rest, ("gpt_neox.",)),
    "gpt_neo": Family(gpt_neo_config, _gpt_neo_layer, _learned_rest, ("transformer.",),
                      ("attn.wq", "attn.wk", "attn.wv")),
    "gpt2": Family(gpt2_config, _gpt2_layer, _learned_rest, ("transformer.",)),
    "llama": Family(llama_config, _llama_layer, _llama_rest, ("model.",)),
    "mistral": Family(llama_config, _llama_layer, _llama_rest, ("model.",)),
    "qwen2": Family(qwen2_config, _llama_layer, _llama_rest, ("model.",)),
    "gemma": Family(gemma_config, _gemma_layer, _gemma_rest, ("model.",)),
    "bloom": Family(bloom_config, _bloom_layer, _bloom_rest, ("transformer.",)),
    "mpt": Family(mpt_config, _mpt_layer, _mpt_rest, ("transformer.",)),
    "bert": Family(bert_config, _bert_layer, _bert_rest, ("bert.",)),
    "mpnet": Family(mpnet_config, _mpnet_layer, _mpnet_rest, ("mpnet.",)),
}
# the encoder-decoders: ``layer(w, cfg, (stack, i))`` for stack enc_blocks / dec_blocks
SEQ2SEQ_FAMILIES = {
    "t5": Family(t5_config, _t5_layer, _t5_rest, ()),
    "mbart": Family(mbart_config, _mbart_layer, _mbart_rest, ("model.",)),
}
ENCODER_TYPES = ("bert", "mpnet")


def causal_family(model_type: str) -> Family:
    """``load_causal_auto``'s dispatch: anything it does not name loads as
    GPT-NeoX."""
    return FAMILIES.get(model_type if model_type in FAMILIES and model_type not in ENCODER_TYPES else "gpt_neox")


def encoder_family(model_type: str) -> Family:
    """``load_encoder_auto``'s dispatch: MPNet, else BERT."""
    return FAMILIES["mpnet" if model_type == "mpnet" else "bert"]


def seq2seq_family(model_type: str) -> Family:
    """``load_seq2seq_auto``'s dispatch: t5 / mt5 / longt5, or mbart; any
    other model type raises."""
    if model_type in T5_TYPES:
        return SEQ2SEQ_FAMILIES["t5"]
    if model_type == "mbart":
        return SEQ2SEQ_FAMILIES["mbart"]
    raise ValueError(f"unsupported seq2seq model_type {model_type!r}")


def weights(state: Mapping, family: Family, prefix: str = "", device=None) -> _Weights:
    """The tensors of ``state`` (under ``prefix``) as the family's
    converters read them, as f32 on ``device`` (default: where they are)."""
    return _Weights(state, family.prefixes, device, prefix)


def convert(state: Mapping, cfg: ModelConfig, family: Family, prefix: str = "") -> dict:
    """A whole HF state dict -> the JAX package's parameter tree (f32
    tensors)."""
    w = weights(state, family, prefix)
    return dict(family.rest(w, cfg), blocks=[family.layer(w, cfg, i) for i in range(cfg.n_layers)])


def load_causal_auto(model_dir: str, device="cuda", quantize: Optional[str] = None):
    """Local HF causal-LM directory -> :class:`CausalLM` of the file's
    configuration (``.cfg``), dispatching on ``model_type``
    (:func:`causal_family`): ``models.params.causal_from_hf``, which
    streams it onto ``device`` a tensor at a time."""
    from .params import causal_from_hf

    return causal_from_hf(model_dir, device=device, quantize=quantize)


def load_encoder_auto(model_dir: str):
    """Local HF encoder directory -> (parameter tree, ModelConfig): MPNet
    or BERT by ``model_type``."""
    family = encoder_family(read_config(model_dir).get("model_type", ""))
    cfg = family.config(hf_config(model_dir))
    with Checkpoint(model_dir) as state:
        return convert(state, cfg, family), cfg


def convert_seq2seq(state: Mapping, cfg: ModelConfig, family: Family) -> dict:
    """A whole HF encoder-decoder state dict -> the JAX package's tree."""
    w = weights(state, family)
    return dict(family.rest(w, cfg),
                enc_blocks=[family.layer(w, cfg, ("enc_blocks", i)) for i in range(cfg.n_layers)],
                dec_blocks=[family.layer(w, cfg, ("dec_blocks", i)) for i in range(cfg.decoder_layers)])


def convert_t5(state_dict: Mapping, cfg: ModelConfig) -> dict:
    """T5 / mT5 state dict -> the models/t5.py tree (f32 tensors)."""
    return convert_seq2seq(state_dict, cfg, SEQ2SEQ_FAMILIES["t5"])


def convert_mbart(state_dict: Mapping, cfg: ModelConfig) -> dict:
    """mBART state dict -> the models/bart.py tree (f32 tensors)."""
    return convert_seq2seq(state_dict, cfg, SEQ2SEQ_FAMILIES["mbart"])


def _load_seq2seq(model_dir: str, family: Family):
    cfg = family.config(hf_config(model_dir))
    with Checkpoint(model_dir) as state:
        return convert_seq2seq(state, cfg, family), cfg


def load_t5(model_dir: str):
    """Local T5 / mT5 / LongT5 directory -> (tree, ModelConfig)."""
    return _load_seq2seq(model_dir, SEQ2SEQ_FAMILIES["t5"])


def load_mbart(model_dir: str):
    """Local mBART directory -> (tree, ModelConfig)."""
    return _load_seq2seq(model_dir, SEQ2SEQ_FAMILIES["mbart"])


def load_seq2seq_auto(model_dir: str):
    """Local HF seq2seq directory -> (tree of f32 tensors, ModelConfig),
    dispatching on ``model_type`` (:func:`seq2seq_family`);
    ``models.params.seq2seq_from_hf`` streams one onto a device instead."""
    return _load_seq2seq(model_dir, seq2seq_family(read_config(model_dir).get("model_type", "")))


# ---------------------------------------------------------------------------
# the per-family wrappers of the JAX package
# ---------------------------------------------------------------------------


def _convert_family(model_type: str):
    def convert_family(state_dict: Mapping, cfg: ModelConfig, prefix: str = "") -> dict:
        return convert(state_dict, cfg, FAMILIES[model_type], prefix)

    convert_family.__doc__ = f"A {model_type} state dict -> the JAX package's parameter tree (f32 tensors)."
    return convert_family


def _load_family(model_type: str):
    def load_family(model_dir: str):
        family = FAMILIES[model_type]
        cfg = family.config(hf_config(model_dir))
        with Checkpoint(model_dir) as state:
            return convert(state, cfg, family), cfg

    load_family.__doc__ = (f"A local {model_type} directory -> (parameter tree of f32 tensors, ModelConfig); "
                           "``models.params.causal_from_hf`` streams one onto a device instead.")
    return load_family


convert_gpt_neox, load_gpt_neox = _convert_family("gpt_neox"), _load_family("gpt_neox")
convert_gpt_neo, load_gpt_neo = _convert_family("gpt_neo"), _load_family("gpt_neo")
convert_gpt2, load_gpt2 = _convert_family("gpt2"), _load_family("gpt2")
convert_llama, load_llama = _convert_family("llama"), _load_family("llama")
load_qwen2 = _load_family("qwen2")
convert_gemma, load_gemma = _convert_family("gemma"), _load_family("gemma")
convert_bloom, load_bloom = _convert_family("bloom"), _load_family("bloom")
convert_mpt, load_mpt = _convert_family("mpt"), _load_family("mpt")
convert_bert, load_bert = _convert_family("bert"), _load_family("bert")
convert_mpnet, load_mpnet = _convert_family("mpnet"), _load_family("mpnet")


# ---------------------------------------------------------------------------
# export: the port's modules -> HF directories
# ---------------------------------------------------------------------------
#
# Counterpart of the JAX package's ``to_*_state_dict`` / ``export_*``, which
# fill a transformers model and call ``save_pretrained(...,
# safe_serialization=False)``.  Here the directory is written without
# transformers (models/hf_io.py): the same files (config.json,
# generation_config.json, pytorch_model.bin), the same tensor names,
# shapes, dtypes (f32) and values, a tied head stored as the embedding's
# storage, and a config.json that ``AutoConfig`` reads as it reads the JAX
# package's.  ``export_*`` reads and writes one layer at a time.

STACKS = ("blocks", "enc_blocks", "dec_blocks")
# each class's ids that GenerationConfig.from_model_config carries into
# generation_config.json (the class defaults; T5's come from export_t5)
_GENERATION = {
    "gpt_neox": dict(bos_token_id=0, eos_token_id=2), "gpt_neo": dict(bos_token_id=50256, eos_token_id=50256),
    "gpt2": dict(bos_token_id=50256, eos_token_id=50256), "llama": dict(bos_token_id=1, eos_token_id=2),
    "qwen2": {}, "gemma": dict(bos_token_id=2, eos_token_id=1, pad_token_id=0),
    "bloom": dict(bos_token_id=1, eos_token_id=2), "mpt": dict(use_cache=False),
}


def _dense_weight(dense) -> torch.Tensor:
    """The f32 weight a dense layer computes with: the float weight (LoRA
    merged where ``merge_lora`` merged it), else its codes dequantized with
    the attached LoRA factors folded in (``quantize.dequantized_weight``,
    one layer at a time)."""
    if dense.w_q is not None:
        return dequantized_weight(dense).detach()
    return (dense.w if dense.w_merged is None else dense.w_merged).detach().float()


def export_tree(module, skip=()) -> dict:
    """``module``'s parameters as the JAX package's tree (its
    ``state_dict`` names nested), f32 on the module's device; a dense
    layer's ``w`` is :func:`_dense_weight`, so a merged model (a quantized
    base dequantized layer by layer) gives the float tree the JAX package's
    ``merged_params`` and ``dequantize_tree`` give (what ``convert-ckpt --format npz`` and
    ``train --push-to-hub`` save).  Children named in ``skip`` are left
    out."""
    from ..utils.tree import nest
    from .layers import Dense

    flat = {}

    def visit(mod, prefix):
        if isinstance(mod, Dense):
            flat[prefix + "w"] = _dense_weight(mod)
            if mod.b is not None:
                flat[prefix + "b"] = mod.b.detach().float()
            return
        for name, t in [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]:
            if t is not None and name not in mod._non_persistent_buffers_set:
                flat[prefix + name] = t.detach().float()
        for name, child in mod.named_children():
            if not (prefix == "" and name in skip):
                visit(child, f"{prefix}{name}.")

    visit(module, "")
    return nest(flat)


def _layers(model, stack: str) -> list:
    return list(getattr(model, stack, None) or [])


def _t(x: torch.Tensor) -> torch.Tensor:
    """An (in, out) weight as HF's (out, in) Linear weight."""
    return x.T.contiguous()


def _hf_config(cfg_class: str, model_type: str, **fields) -> dict:
    return dict(fields, architectures=[cfg_class], model_type=model_type, torch_dtype="float32")


def _gpt_neox_rest(p: dict, cfg: ModelConfig) -> dict:
    embed = p["tok_embed"]
    return {"gpt_neox.embed_in.weight": embed, "gpt_neox.final_layer_norm.weight": p["ln_f"]["scale"],
            "gpt_neox.final_layer_norm.bias": p["ln_f"]["bias"],
            "embed_out.weight": _t(p["lm_head"]["w"]) if "lm_head" in p else embed}


def _fuse_heads(attn: dict, h: int, dh: int, d: int) -> tuple:
    """q / k / v -> one head-interleaved ((H, 3, Dh) rows) weight and bias:
    the inverse of :func:`_fused_heads`."""
    w = torch.stack([attn[n]["w"].T.reshape(h, dh, d) for n in ("wq", "wk", "wv")], dim=1)
    b = torch.stack([attn[n]["b"].reshape(h, dh) for n in ("wq", "wk", "wv")], dim=1)
    return w.reshape(3 * d, d), b.reshape(3 * d)


def _gpt_neox_layer(blk: dict, cfg: ModelConfig, i: int) -> dict:
    pre = f"gpt_neox.layers.{i}."
    w, b = _fuse_heads(blk["attn"], cfg.n_heads, cfg.head_dim, cfg.d_model)
    out = {pre + "attention.query_key_value.weight": w, pre + "attention.query_key_value.bias": b}
    _linear_sd(out, pre + "attention.dense", blk["attn"]["wo"])
    _ln_sd(out, pre + "input_layernorm", blk["ln1"])
    _ln_sd(out, pre + "post_attention_layernorm", blk["ln2"])
    _linear_sd(out, pre + "mlp.dense_h_to_4h", blk["mlp"]["wi"])
    _linear_sd(out, pre + "mlp.dense_4h_to_h", blk["mlp"]["wo"])
    return out


def _gpt_neox_config(cfg: ModelConfig) -> dict:
    return _hf_config("GPTNeoXForCausalLM", "gpt_neox", vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
                      num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads, intermediate_size=cfg.d_ff,
                      max_position_embeddings=cfg.max_seq_len, rotary_pct=cfg.rope_pct,
                      rotary_emb_base=int(cfg.rope_theta), use_parallel_residual=cfg.parallel_residual,
                      tie_word_embeddings=cfg.tie_embeddings, layer_norm_eps=cfg.norm_eps)


def _learned_pos_rest(p: dict, cfg: ModelConfig) -> dict:
    embed = p["tok_embed"]
    return {"transformer.wte.weight": embed, "transformer.wpe.weight": p["pos_embed"],
            "transformer.ln_f.weight": p["ln_f"]["scale"], "transformer.ln_f.bias": p["ln_f"]["bias"],
            "lm_head.weight": embed}


def _ln_sd(out: dict, name: str, ln: dict) -> None:
    out[name + ".weight"], out[name + ".bias"] = ln["scale"], ln["bias"]


def _linear_sd(out: dict, name: str, dense: dict) -> None:
    """{"w" (in, out)[, "b"]} -> an HF Linear's (out, in) weight and its
    bias: the inverse of :func:`_linear`."""
    out[name + ".weight"] = _t(dense["w"])
    if "b" in dense:
        out[name + ".bias"] = dense["b"]


def _gpt_neo_layer(blk: dict, cfg: ModelConfig, i: int) -> dict:
    pre = f"transformer.h.{i}."
    out = {}
    _ln_sd(out, pre + "ln_1", blk["ln1"])
    for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
        out[pre + f"attn.attention.{theirs}.weight"] = _t(blk["attn"][ours]["w"])  # no biases in HF's layout
    _linear_sd(out, pre + "attn.attention.out_proj", blk["attn"]["wo"])
    _ln_sd(out, pre + "ln_2", blk["ln2"])
    _linear_sd(out, pre + "mlp.c_fc", blk["mlp"]["wi"])
    _linear_sd(out, pre + "mlp.c_proj", blk["mlp"]["wo"])
    return out


def _gpt_neo_config(cfg: ModelConfig) -> dict:
    kinds = cfg.attention_layers or ("global",) * cfg.n_layers
    return _hf_config("GPTNeoForCausalLM", "gpt_neo", vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
                      num_layers=cfg.n_layers, attention_types=[[[k], 1] for k in kinds], num_heads=cfg.n_heads,
                      intermediate_size=cfg.d_ff, max_position_embeddings=cfg.max_seq_len,
                      window_size=cfg.attention_window, activation_function="gelu_new",
                      layer_norm_epsilon=cfg.norm_eps, tie_word_embeddings=True)


def _gpt2_layer(blk: dict, cfg: ModelConfig, i: int) -> dict:
    """Conv1D keeps the (in, out) orientation; c_attn fuses [q | k | v]
    columns."""
    pre = f"transformer.h.{i}."
    attn, mlp = blk["attn"], blk["mlp"]
    out = {}
    _ln_sd(out, pre + "ln_1", blk["ln1"])
    out[pre + "attn.c_attn.weight"] = torch.cat([attn[n]["w"] for n in ("wq", "wk", "wv")], dim=1)
    out[pre + "attn.c_attn.bias"] = torch.cat([attn[n]["b"] for n in ("wq", "wk", "wv")])
    out[pre + "attn.c_proj.weight"], out[pre + "attn.c_proj.bias"] = attn["wo"]["w"], attn["wo"]["b"]
    _ln_sd(out, pre + "ln_2", blk["ln2"])
    out[pre + "mlp.c_fc.weight"], out[pre + "mlp.c_fc.bias"] = mlp["wi"]["w"], mlp["wi"]["b"]
    out[pre + "mlp.c_proj.weight"], out[pre + "mlp.c_proj.bias"] = mlp["wo"]["w"], mlp["wo"]["b"]
    return out


def _gpt2_config(cfg: ModelConfig) -> dict:
    return _hf_config("GPT2LMHeadModel", "gpt2", vocab_size=cfg.vocab_size, n_embd=cfg.d_model, n_layer=cfg.n_layers,
                      n_head=cfg.n_heads, n_inner=cfg.d_ff, n_positions=cfg.max_seq_len,
                      layer_norm_epsilon=cfg.norm_eps, tie_word_embeddings=True)


def _llama_layout_rest(p: dict, cfg: ModelConfig) -> dict:
    embed = p["tok_embed"]
    return {"model.embed_tokens.weight": embed, "model.norm.weight": p["ln_f"]["scale"],
            "lm_head.weight": _t(p["lm_head"]["w"]) if "lm_head" in p else embed}


def _llama_layout_layer(blk: dict, cfg: ModelConfig, i: int) -> dict:
    pre = f"model.layers.{i}."
    out = {pre + "input_layernorm.weight": blk["ln1"]["scale"],
           pre + "post_attention_layernorm.weight": blk["ln2"]["scale"]}
    for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
        _linear_sd(out, pre + f"self_attn.{theirs}", blk["attn"][ours])  # Qwen2: q / k / v carry biases
    for ours, theirs in (("wg", "gate_proj"), ("wi", "up_proj"), ("wo", "down_proj")):
        _linear_sd(out, pre + f"mlp.{theirs}", blk["mlp"][ours])
    return out


def _gemma_norms(tree: dict) -> dict:
    """Gemma stores its RMSNorm scales as ``w`` of ``(1 + w)``: the fold of
    the import is undone."""
    return {k: ({"scale": v["scale"] - 1.0} if k in ("ln1", "ln2", "ln_f") else v) for k, v in tree.items()}


def _llama_fields(cfg: ModelConfig) -> dict:
    return dict(vocab_size=cfg.vocab_size, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
                num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.kv_heads, intermediate_size=cfg.d_ff,
                max_position_embeddings=cfg.max_seq_len, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
                tie_word_embeddings=cfg.tie_embeddings)


def _llama_config(cfg: ModelConfig) -> dict:
    return _hf_config("LlamaForCausalLM", "llama", **_llama_fields(cfg), attention_bias=False)


def _qwen2_config(cfg: ModelConfig) -> dict:
    return _hf_config("Qwen2ForCausalLM", "qwen2", **_llama_fields(cfg), use_sliding_window=False)


def _gemma_config(cfg: ModelConfig) -> dict:
    return _hf_config("GemmaForCausalLM", "gemma", **_llama_fields(cfg), head_dim=cfg.head_dim,
                      hidden_act="gelu_pytorch_tanh", attention_bias=False)


def _bloom_rest(p: dict, cfg: ModelConfig) -> dict:
    embed = p["tok_embed"]
    out = {"transformer.word_embeddings.weight": embed, "lm_head.weight": embed}
    _ln_sd(out, "transformer.word_embeddings_layernorm", p["emb_ln"])
    _ln_sd(out, "transformer.ln_f", p["ln_f"])
    return out


def _bloom_layer(blk: dict, cfg: ModelConfig, i: int) -> dict:
    pre = f"transformer.h.{i}."
    w, b = _fuse_heads(blk["attn"], cfg.n_heads, cfg.head_dim, cfg.d_model)
    out = {pre + "self_attention.query_key_value.weight": w, pre + "self_attention.query_key_value.bias": b}
    _linear_sd(out, pre + "self_attention.dense", blk["attn"]["wo"])
    _ln_sd(out, pre + "input_layernorm", blk["ln1"])
    _ln_sd(out, pre + "post_attention_layernorm", blk["ln2"])
    _linear_sd(out, pre + "mlp.dense_h_to_4h", blk["mlp"]["wi"])
    _linear_sd(out, pre + "mlp.dense_4h_to_h", blk["mlp"]["wo"])
    return out


def _bloom_config(cfg: ModelConfig) -> dict:
    return _hf_config("BloomForCausalLM", "bloom", vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
                      n_layer=cfg.n_layers, n_head=cfg.n_heads, layer_norm_epsilon=cfg.norm_eps,
                      tie_word_embeddings=True)


def _mpt_norm(out: dict, name: str, ln: dict) -> None:
    """MPT LayerNorms have no bias on the Hub: a learned nonzero bias
    cannot be written, and raises (LoRA keeps the zeros of the import)."""
    out[name + ".weight"] = ln["scale"]
    bias = ln.get("bias")
    if bias is not None and float(bias.abs().max()) > 1e-6:
        raise ValueError(f"{name}: nonzero LayerNorm bias cannot be exported to the MPT format (HF MptModel pins "
                         "norm biases to None)")


def _mpt_rest(p: dict, cfg: ModelConfig) -> dict:
    embed = p["tok_embed"]
    out = {"transformer.wte.weight": embed, "lm_head.weight": embed if cfg.tie_embeddings else _t(p["lm_head"]["w"])}
    _mpt_norm(out, "transformer.norm_f", p["ln_f"])
    return out


def _mpt_layer(blk: dict, cfg: ModelConfig, i: int) -> dict:
    pre = f"transformer.blocks.{i}."
    attn, mlp = blk["attn"], blk["mlp"]
    out = {}
    _mpt_norm(out, pre + "norm_1", blk["ln1"])
    _mpt_norm(out, pre + "norm_2", blk["ln2"])
    out[pre + "attn.Wqkv.weight"] = torch.cat([attn[n]["w"].T for n in ("wq", "wk", "wv")], dim=0)
    if "b" in attn["wq"]:
        out[pre + "attn.Wqkv.bias"] = torch.cat([attn[n]["b"] for n in ("wq", "wk", "wv")])
    _linear_sd(out, pre + "attn.out_proj", attn["wo"])
    _linear_sd(out, pre + "ffn.up_proj", mlp["wi"])
    _linear_sd(out, pre + "ffn.down_proj", mlp["wo"])
    return out


def _mpt_config(cfg: ModelConfig) -> dict:
    return _hf_config("MptForCausalLM", "mpt", vocab_size=cfg.vocab_size, d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_layers=cfg.n_layers, expansion_ratio=cfg.d_ff // cfg.d_model, max_seq_len=cfg.max_seq_len,
                      layer_norm_epsilon=cfg.norm_eps, no_bias=not bool(cfg.attention_bias),
                      tie_word_embeddings=cfg.tie_embeddings,
                      attn_config={"alibi": True, "alibi_bias_max": cfg.alibi_bias_max, "clip_qkv": cfg.clip_qkv,
                                   "softmax_scale": cfg.attention_scale})


def _t5_rest(p: dict, cfg: ModelConfig) -> dict:
    """The shared embedding is written under its three names, one storage."""
    shared = p["tok_embed"]
    return {"shared.weight": shared, "encoder.embed_tokens.weight": shared, "decoder.embed_tokens.weight": shared,
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": p["enc_rel_bias"],
            "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": p["dec_rel_bias"],
            "encoder.final_layer_norm.weight": p["enc_ln_f"]["scale"],
            "decoder.final_layer_norm.weight": p["dec_ln_f"]["scale"],
            "lm_head.weight": _t(p["lm_head"]["w"]) if "lm_head" in p else shared}


def _t5_layer(blk: dict, cfg: ModelConfig, where) -> dict:
    stack, i = where
    pre = f"{'encoder' if stack == 'enc_blocks' else 'decoder'}.block.{i}.layer."
    ff = 1 if stack == "enc_blocks" else 2
    out = {pre + "0.layer_norm.weight": blk["ln1"]["scale"], pre + f"{ff}.layer_norm.weight": blk["ln2"]["scale"]}
    attns = [("0.SelfAttention", blk["attn"])]
    if ff == 2:
        out[pre + "1.layer_norm.weight"] = blk["ln_cross"]["scale"]
        attns.append(("1.EncDecAttention", blk["cross_attn"]))
    for name, attn in attns:
        for ours, theirs in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o")):
            out[f"{pre}{name}.{theirs}.weight"] = _t(attn[ours]["w"])
    dense, mlp = pre + f"{ff}.DenseReluDense.", blk["mlp"]
    if "wg" in mlp:
        out[dense + "wi_0.weight"], out[dense + "wi_1.weight"] = _t(mlp["wg"]["w"]), _t(mlp["wi"]["w"])
    else:
        out[dense + "wi.weight"] = _t(mlp["wi"]["w"])
    out[dense + "wo.weight"] = _t(mlp["wo"]["w"])
    return out


def _t5_config(cfg: ModelConfig, pad_token_id: int, eos_token_id: int, decoder_start_token_id: int) -> dict:
    return _hf_config("T5ForConditionalGeneration", "t5", vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                      d_kv=cfg.head_dim, d_ff=cfg.d_ff, num_layers=cfg.n_layers,
                      num_decoder_layers=cfg.decoder_layers, num_heads=cfg.n_heads,
                      relative_attention_num_buckets=cfg.relative_attention_buckets,
                      relative_attention_max_distance=cfg.relative_attention_max_distance,
                      feed_forward_proj="gated-gelu" if cfg.mlp_gated else "relu",
                      tie_word_embeddings=cfg.tie_embeddings, layer_norm_epsilon=cfg.norm_eps,
                      decoder_start_token_id=decoder_start_token_id, pad_token_id=pad_token_id,
                      eos_token_id=eos_token_id)


class Exporter(NamedTuple):
    rest: Callable  # (tree without its blocks, cfg) -> {HF name: tensor}
    layer: Callable  # (one block's tree, cfg, i or (stack, i)) -> {HF name: tensor}
    config: Callable  # cfg -> config.json's dict
    generation: dict  # generation_config.json's ids
    tree: Callable = lambda tree: tree  # a tree (or a block's) as the layout reads it


EXPORTERS = {
    "gpt_neox": Exporter(_gpt_neox_rest, _gpt_neox_layer, _gpt_neox_config, _GENERATION["gpt_neox"]),
    "gpt_neo": Exporter(_learned_pos_rest, _gpt_neo_layer, _gpt_neo_config, _GENERATION["gpt_neo"]),
    "gpt2": Exporter(_learned_pos_rest, _gpt2_layer, _gpt2_config, _GENERATION["gpt2"]),
    "llama": Exporter(_llama_layout_rest, _llama_layout_layer, _llama_config, _GENERATION["llama"]),
    "qwen2": Exporter(_llama_layout_rest, _llama_layout_layer, _qwen2_config, _GENERATION["qwen2"]),
    "gemma": Exporter(_llama_layout_rest, _llama_layout_layer, _gemma_config, _GENERATION["gemma"], _gemma_norms),
    "bloom": Exporter(_bloom_rest, _bloom_layer, _bloom_config, _GENERATION["bloom"]),
    "mpt": Exporter(_mpt_rest, _mpt_layer, _mpt_config, _GENERATION["mpt"]),
}


def _generation_config(ids: dict) -> dict:
    """generation_config.json as ``GenerationConfig.from_model_config``
    writes it (without ``transformers_version``)."""
    return {"_from_model_config": True, **ids}


def export_groups(model, exporter: Exporter):
    """The HF tensors of ``model`` in groups, each made when it is asked
    for (on the model's device): the tree without its blocks (with a tied
    head), then one group a block."""
    cfg = model.cfg
    yield exporter.rest(exporter.tree(export_tree(model, STACKS)), cfg)
    for stack in STACKS:
        for i, blk in enumerate(_layers(model, stack)):
            yield exporter.layer(exporter.tree(export_tree(blk)), cfg, i if cfg.arch == "causal" else (stack, i))


def _state_dict(model, exporter: Exporter) -> dict:
    return {k: v.cpu() for group in export_groups(model, exporter) for k, v in group.items()}


def _export(model, out_dir: str, exporter: Exporter, config: dict, generation: dict) -> str:
    """Write ``model`` as an HF directory, one layer at a time: each
    layer's tensors go to the host and into the current shard, and a
    shard is written when it is full (models/hf_io.py ``BinWriter``)."""
    from .hf_io import BinWriter, write_config

    writer = BinWriter(out_dir)
    for group in export_groups(model, exporter):
        writer.add(group)
    writer.close()
    write_config(out_dir, config, _generation_config(generation))
    return out_dir


def _causal_pair(model_type: str):
    exporter = EXPORTERS[model_type]

    def to_state_dict(model) -> dict:
        return _state_dict(model, exporter)

    def export(model, out_dir: str) -> str:
        return _export(model, out_dir, exporter, exporter.config(model.cfg), exporter.generation)

    to_state_dict.__doc__ = (f"A causal LM's weights as an HF {model_type} state dict: f32 host tensors under the "
                             "transformers names, a tied head as the embedding tensor (the inverse of the import).")
    export.__doc__ = (f"Write ``model`` as a transformers-loadable {model_type} directory (config.json, "
                      "generation_config.json, pytorch_model.bin or its shards); returns ``out_dir``.")
    return to_state_dict, export


to_gpt_neox_state_dict, export_gpt_neox = _causal_pair("gpt_neox")
to_gpt_neo_state_dict, export_gpt_neo = _causal_pair("gpt_neo")
to_gpt2_state_dict, export_gpt2 = _causal_pair("gpt2")
to_llama_state_dict, export_llama = _causal_pair("llama")
_, export_qwen2 = _causal_pair("qwen2")
_, export_gemma = _causal_pair("gemma")
to_bloom_state_dict, export_bloom = _causal_pair("bloom")
to_mpt_state_dict, export_mpt = _causal_pair("mpt")
CAUSAL_EXPORTS = {"gpt_neox": export_gpt_neox, "gpt_neo": export_gpt_neo, "gpt2": export_gpt2, "llama": export_llama,
                  "qwen2": export_qwen2, "gemma": export_gemma, "bloom": export_bloom, "mpt": export_mpt}


def causal_export_type(cfg: ModelConfig) -> str:
    """The HF model type a causal configuration exports to, by its
    architecture's fingerprints (the inverse of ``load_causal_auto``):

    - RMSNorm / gated MLP            -> llama (qkv biases -> qwen2,
                                       scale_embedding -> gemma)
    - ALiBi positions                -> bloom (alibi_mode "mpt" -> mpt)
    - learned positions, unscaled    -> gpt_neo (attention_scale == 1.0)
    - learned positions, 1/sqrt(d)   -> gpt2
    - otherwise (RoPE)               -> gpt_neox"""
    if cfg.norm == "rmsnorm" or cfg.mlp_gated:
        if cfg.attention_bias == "qkv":
            return "qwen2"
        return "gemma" if cfg.scale_embedding else "llama"
    if cfg.positional == "alibi":
        return "mpt" if cfg.alibi_mode == "mpt" else "bloom"
    if cfg.positional == "learned":
        return "gpt_neo" if cfg.attention_scale == 1.0 else "gpt2"
    return "gpt_neox"


def export_causal_auto(model, out_dir: str) -> str:
    """Export a causal LM to the HF format its configuration's fingerprints
    name (:func:`causal_export_type`), one layer at a time; returns
    ``out_dir``."""
    return CAUSAL_EXPORTS[causal_export_type(model.cfg)](model, out_dir)


_T5_EXPORTER = Exporter(_t5_rest, _t5_layer, _t5_config, {})


def to_t5_state_dict(model) -> dict:
    """A T5 / mT5 model's weights as an HF T5 state dict (f32 host
    tensors; the shared embedding under its three names)."""
    return _state_dict(model, _T5_EXPORTER)


def export_t5(model, out_dir: str, *, pad_token_id: int = 0, eos_token_id: int = 1,
              decoder_start_token_id: int = 0) -> str:
    """Write a transformers-loadable T5 directory.  The special-token ids
    default to the HF T5 convention (eos 1); a model trained with another
    tokenizer (ByteTokenizer: eos 2) must pass its own, or HF
    ``generate()`` stops on the wrong token."""
    ids = dict(pad_token_id=pad_token_id, eos_token_id=eos_token_id, decoder_start_token_id=decoder_start_token_id)
    return _export(model, out_dir, _T5_EXPORTER, _t5_config(model.cfg, **ids), ids)
