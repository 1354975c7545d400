"""Carry parameters into the port's modules: JAX parameter trees (numpy
leaves) of the causal LMs, the encoders and the encoder-decoders, flat
leaf lists of checkpoints, local Hugging Face directories (streamed onto
the device one layer at a time), and LoRA adapters both ways."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.tree import flatten_paths, nest, tree_leaves
from .causal_lm import CausalLM, unstack_blocks
from .config import ModelConfig
from .encoder import SentenceEncoder
from .layers import _QUANT_KEYS as QUANT_KEYS
from .layers import Dense
from .quantize import quantize_weight


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _flatten(sub, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree
    return out


def encoder_from_jax(params, cfg: ModelConfig, device="cuda") -> SentenceEncoder:
    """The JAX ``init_encoder`` pytree (numpy leaves) -> :class:`SentenceEncoder`.

    Paths join with dots (``params["blocks"][0]["attn"]["wq"]["w"]`` is
    ``blocks.0.attn.wq.w``); dense weights keep their (d_in, d_out) layout.
    Every tensor the module expects must be present, and nothing else."""
    device = resolve_device(device)
    flat = {
        name: torch.tensor(np.asarray(leaf, dtype=np.float32), device=device)
        for name, leaf in _flatten(params, "", {}).items()
    }
    model = SentenceEncoder(cfg, device="meta")
    model.load_state_dict(flat, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def _load_state(model, state: dict, no_bias=()):
    """``model`` (built on the meta device) over the tensors of ``state``:
    quantized dense layers are made to hold their codes, the dense layers
    of each block named in ``no_bias`` lose their bias."""
    for name, mod in model.named_modules():
        if isinstance(mod, Dense) and name.startswith("blocks.") and name.split(".", 2)[2] in no_bias:
            mod.b = None
        if isinstance(mod, Dense) and f"{name}.w_q" in state:
            mod.set_quantized(**{key: torch.empty_like(state[f"{name}.{key}"], device="meta")
                                 for key in QUANT_KEYS if f"{name}.{key}" in state})
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def causal_from_state_dict(state: dict, cfg: ModelConfig, *, no_bias=()) -> CausalLM:
    """A :class:`CausalLM` over the tensors of ``state`` (``state_dict``
    names; quantized layers as ``.w_q`` with ``.w_s``, or nf4-dq's ``.s_q``,
    ``.s_s`` and ``.s_m``), used as they are, on
    their device.  Every tensor the module expects must be present, and
    nothing else.  ``no_bias`` names the dense layers of each block that
    the weights' layout holds without a bias (GPT-Neo's ``attn.wq``,
    ``attn.wk``, ``attn.wv``); those are built without one."""
    return _load_state(CausalLM(cfg, device="meta"), state, no_bias)


def seq2seq_from_state_dict(state: dict, cfg: ModelConfig):
    """The encoder-decoder of ``cfg``'s family (models/families.py) over the
    tensors of ``state``, used as they are, on their device; an mBART
    ``logits_bias`` is kept where ``state`` holds one.  Every tensor the
    module expects must be present, and nothing else."""
    from .families import s2s_class

    cls = s2s_class(cfg)
    kwargs = {"logits_bias": True} if "logits_bias" in state else {}
    return _load_state(cls(cfg, device="meta", **kwargs), state)


def _numpy_state(params, device) -> dict:
    """A JAX tree's leaves by dotted path, as tensors on ``device``: codes
    (int8 / uint8) as they are, everything else f32."""
    flat = {}
    for name, leaf in _flatten(params, "", {}).items():
        leaf = np.asarray(leaf)
        kept = leaf.dtype in (np.int8, np.uint8)  # codes
        flat[name] = torch.from_numpy(np.array(leaf, dtype=leaf.dtype if kept else np.float32)).to(device)
    return flat


def seq2seq_from_jax(params, cfg: ModelConfig, device="cuda"):
    """A JAX encoder-decoder pytree of any family (t5 list-form or
    scan-stacked, bart, native; numpy leaves) -> the port's model, float
    and quantized leaves carried bit for bit as :func:`causal_from_jax`
    carries them."""
    from .families import unstack_for_decode

    device = resolve_device(device)
    return seq2seq_from_state_dict(_numpy_state(unstack_for_decode(params, cfg), device), cfg)


def causal_from_jax(params, cfg: ModelConfig, device="cuda", *, no_bias=()) -> CausalLM:
    """A JAX causal-LM pytree (numpy leaves; list-form or scan-stacked
    blocks) -> :class:`CausalLM`.  Float leaves load as f32; quantized
    leaves are carried bit for bit: ``int8`` / ``int8c`` ``{w_q, w_s[,
    b]}`` (int8 codes, f32 scales), ``nf4`` (uint8 packed codes, f32
    scales) and ``nf4-dq`` ``{w_q, s_q, s_s, s_m[, b]}`` (int8 scale codes).  ``no_bias`` as in
    :func:`causal_from_state_dict` (the JAX import of a GPT-Neo directory
    has no q/k/v biases)."""
    device = resolve_device(device)
    return causal_from_state_dict(_numpy_state(unstack_blocks(params, cfg.n_layers), device), cfg, no_bias=no_bias)


def _quantize_layer(flat: dict, mode: str) -> dict:
    """Every dense weight (``....w``) of one layer's flat tree -> its
    quantized leaves (``w_q`` with ``w_s``, or nf4-dq's ``s_q``, ``s_s``,
    ``s_m``), as ``quantize_dense_tree`` makes them."""
    out = {}
    for name, t in flat.items():
        if name.endswith(".w"):
            out.update({name[:-1] + key: leaf for key, leaf in quantize_weight(t, mode).items()})
        else:
            out[name] = t
    return out


# configuration fields that choose how the model runs, not what it computes
# from its weights: a preset may set them whatever the file says
RUNTIME_FIELDS = ("use_flash_attention", "scan_layers", "remat_policy", "dropout_rate", "activations_bf16")


def _check_config(model_dir: str, cfg: ModelConfig, file_cfg: ModelConfig) -> None:
    """Raise naming the fields where ``cfg`` and the file's configuration
    differ (all but :data:`RUNTIME_FIELDS`)."""
    want, got = dataclasses.asdict(cfg), dataclasses.asdict(file_cfg)
    differ = [f"{k} {want[k]!r} (model) != {got[k]!r} (file)" for k in want
              if k not in RUNTIME_FIELDS and want[k] != got[k]]
    if differ:
        raise ValueError(f"{model_dir} holds another model than the configuration asked for: " + "; ".join(differ))


def causal_from_hf(model_dir: str, cfg: ModelConfig | None = None, *, device="cuda",
                   quantize: str | None = None) -> CausalLM:
    """A local HF causal-LM directory -> :class:`CausalLM` on ``device``,
    streamed: each tensor is read from the file, moved to the device and
    converted there, one layer at a time, and with ``quantize`` (a mode of
    models/quantize.py) each layer is quantized as soon as it is complete, as
    ``init_causal_lm(..., quantize=)`` does for drawn weights.  The host
    never holds more than one tensor of the checkpoint.

    ``cfg`` (default: the file's own) is the model's configuration.  It
    must equal the file's in every field but :data:`RUNTIME_FIELDS`, else
    this raises naming the fields that differ."""
    from .convert_hf import causal_family, hf_config, weights
    from .hf_io import Checkpoint

    device = resolve_device(device)
    view = hf_config(model_dir)
    family = causal_family(getattr(view, "model_type", ""))
    file_cfg = family.config(view)
    cfg = cfg or file_cfg
    _check_config(model_dir, cfg, file_cfg)
    with Checkpoint(model_dir) as ckpt:
        w = weights(ckpt, family, device=device)
        state = _flatten(family.rest(w, file_cfg), "", {})
        for i in range(cfg.n_layers):
            layer = _flatten(family.layer(w, file_cfg, i), f"blocks.{i}.", {})
            state.update(_quantize_layer(layer, quantize) if quantize else layer)
    return causal_from_state_dict(state, cfg, no_bias=family.no_bias)


def seq2seq_from_hf(model_dir: str, cfg: ModelConfig | None = None, *, device="cuda",
                    quantize: str | None = None):
    """A local HF T5 / mT5 / LongT5 or mBART directory -> the port's
    encoder-decoder on ``device``, streamed as :func:`causal_from_hf`
    streams a causal LM: a tensor at a time, each encoder and decoder
    layer quantized (``quantize``) as soon as it is complete; embeddings,
    tables and the LM head stay float.  ``cfg`` (default: the file's own)
    must equal the file's configuration but in :data:`RUNTIME_FIELDS`."""
    from .convert_hf import hf_config, seq2seq_family, weights
    from .hf_io import Checkpoint

    device = resolve_device(device)
    view = hf_config(model_dir)
    family = seq2seq_family(getattr(view, "model_type", ""))
    file_cfg = family.config(view)
    cfg = cfg or file_cfg
    _check_config(model_dir, cfg, file_cfg)
    with Checkpoint(model_dir) as ckpt:
        w = weights(ckpt, family, device=device)
        state = _flatten(family.rest(w, file_cfg), "", {})
        for stack, n in (("enc_blocks", cfg.n_layers), ("dec_blocks", cfg.decoder_layers)):
            for i in range(n):
                layer = _flatten(family.layer(w, file_cfg, (stack, i)), f"{stack}.{i}.", {})
                state.update(_quantize_layer(layer, quantize) if quantize else layer)
    return seq2seq_from_state_dict(state, cfg)


def encoder_from_hf(model_dir: str, device="cuda") -> SentenceEncoder:
    """A local HF BERT or MPNet directory -> :class:`SentenceEncoder`, with
    the configuration the file gives (``.cfg``)."""
    from .convert_hf import load_encoder_auto

    params, cfg = load_encoder_auto(model_dir)
    return encoder_from_jax(params, cfg, device=device)


def _meta_model(cfg: ModelConfig):
    """``cfg``'s float model on the meta device: a causal LM or the
    encoder-decoder of its family."""
    if cfg.arch == "seq2seq":
        from .families import s2s_class

        return s2s_class(cfg)(cfg, device="meta")
    return CausalLM(cfg, device="meta")


def _stacks(cfg: ModelConfig) -> dict:
    """The block lists of ``cfg``'s tree and their layer counts."""
    if cfg.arch == "seq2seq":
        return {"enc_blocks": cfg.n_layers, "dec_blocks": cfg.decoder_layers}
    return {"blocks": cfg.n_layers}


def _leaf_names(cfg: ModelConfig, stacked: bool) -> list:
    """The names of a float model tree's leaves in the JAX order; with
    ``stacked`` the block leaves are one scan-stacked (L, ...) leaf each,
    named with ``*`` for the layer."""
    tree = nest({name: name for name in _meta_model(cfg).state_dict()})
    if stacked:
        for stack in _stacks(cfg):
            rest = [name.split(".", 2)[2] for name in tree_leaves(tree[stack][0])]
            tree[stack] = nest({r: f"{stack}.*." + r for r in rest})
    return tree_leaves(tree)


def model_from_leaves(arrays: list, cfg: ModelConfig, device="cuda"):
    """A float model tree's leaves in the JAX order (list-form or
    scan-stacked blocks, as a checkpoint or ``save_pytree`` stores them)
    -> the :class:`CausalLM` or the encoder-decoder of ``cfg``.  A leaf
    count or shape that does not fit ``cfg``'s model raises."""
    device = resolve_device(device)
    meta = _meta_model(cfg).state_dict()
    layers = _stacks(cfg)

    def state_for(names) -> dict:
        state = {}
        for name, arr in zip(names, arrays):
            t = torch.as_tensor(np.asarray(arr, np.float32))
            n = layers.get(name.split(".", 1)[0], 0)
            parts = [(name.replace("*", str(i)), t[i]) for i in range(n)] if "*" in name else [(name, t)]
            for key, leaf in parts:
                if tuple(leaf.shape) != tuple(meta[key].shape):
                    raise ValueError(f"{key}: a leaf of shape {tuple(leaf.shape)} for a parameter of shape "
                                     f"{tuple(meta[key].shape)}")
                state[key] = leaf
        return state

    forms = [names for names in (_leaf_names(cfg, False), _leaf_names(cfg, True)) if len(names) == len(arrays)]
    if not forms:
        raise ValueError(f"{len(arrays)} leaves do not make a float {cfg.arch} model of this configuration "
                         f"({len(_leaf_names(cfg, False))} leaves, or {len(_leaf_names(cfg, True))} scan-stacked)")
    try:
        state = state_for(forms[0])
    except ValueError:
        if len(forms) == 1:
            raise
        state = state_for(forms[1])  # one layer: both forms have the same leaf count
    state = {k: v.to(device) for k, v in state.items()}
    if cfg.arch == "seq2seq":
        return seq2seq_from_state_dict(state, cfg)
    return causal_from_state_dict(state, cfg)


causal_from_leaves = model_from_leaves


def adapter_from_jax(adapter, device="cuda") -> dict:
    """A JAX LoRA adapter pytree (numpy leaves; list-form or scan-stacked
    blocks) -> the port's adapter tree (list-form nesting, f32 tensors that
    require grad)."""
    device = resolve_device(device)
    blocks = adapter.get("blocks")
    if isinstance(blocks, dict):  # scan-stacked: every leaf (L, ...)
        adapter = unstack_blocks(adapter, len(tree_leaves(blocks)[0]))
    flat = {name: torch.tensor(np.asarray(leaf, dtype=np.float32), device=device).requires_grad_(True)
            for name, leaf in _flatten(adapter, "", {}).items()}
    return nest(flat)


def adapter_to_jax(adapter) -> dict:
    """The port's adapter tree -> the JAX package's pytree, numpy leaves."""
    return nest({name: leaf.detach().cpu().numpy() for name, leaf in flatten_paths(adapter).items()})
