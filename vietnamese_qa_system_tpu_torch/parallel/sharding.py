"""Parameter sharding rules over the device mesh, and the tensor-parallel
reader they place.

Counterpart of ``vietnamese_qa_system_tpu/parallel/sharding.py``.  The
rules and the spec computation are the JAX package's, over the port's
parameter names (``blocks.0.attn.wq.w`` reads as the JAX path
``/blocks/0/attn/wq/w``, so the same regexes match):

- ``dp`` / ``zero2`` -- parameters replicated;
- ``fsdp``    -- the largest divisible dim of every leaf on ``data``;
- ``tp``      -- attention heads / MLP hidden / vocabulary on ``model``:
  column-parallel q/k/v, wi/wg and the untied head, row-parallel output
  projections, a vocab-sharded embedding table;
- ``fsdp_tp`` -- the tp rules, then fsdp's on what they leave (without a
  ``data`` axis it places like ``tp``).

A spec is a tuple with one entry per dim: an axis name or None.  An axis
the mesh lacks, of size 1, or that does not divide the dim leaves the
dim whole, as in the JAX package.  :func:`shard_params` turns a causal
reader into its tensor-parallel form (``models/causal_lm.py``
``TPCausalLM``), and an encoder-decoder (T5 / mT5, mBART, the native
stack) into its family's (``models/families.py`` ``TPEncoderDecoder``),
for serving and, with ``training=True``, for each data row of the
trainer's mesh; ``train/mesh.py`` places the rest by these specs: a
leaf split along ``data`` is stored as per-position parts, one split
along ``model`` as the tensor-parallel form splits it, any other
replicated.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import torch

from ..core.mesh import DATA_AXIS, MODEL_AXIS, Mesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (path-regex, spec template) rules.  A template has one
    entry per tensor dim: an axis name or None.  The first matching rule
    wins; unmatched leaves use FSDP-style auto rules when ``auto_fsdp``,
    else replication."""

    rules: Sequence[tuple[str, tuple]]
    auto_fsdp: bool = False


# Quantized leaves follow the same layout: w_q mirrors w's (d_in, d_out)
# and w_s is (d_in/block, d_out).
TP_RULES = ShardingRules(
    rules=[
        (r".*/(attn|cross_attn)/w[qkv]/(w|w_q|w_s|s_q)$", (None, MODEL_AXIS)),
        (r".*/(attn|cross_attn)/w[qkv]/b$", (MODEL_AXIS,)),
        (r".*/(attn|cross_attn)/wo/(w|w_q|w_s|s_q)$", (MODEL_AXIS, None)),
        (r".*/mlp/(wi|wg)/(w|w_q|w_s|s_q)$", (None, MODEL_AXIS)),
        (r".*/mlp/(wi|wg)/b$", (MODEL_AXIS,)),
        (r".*/mlp/wo/(w|w_q|w_s|s_q)$", (MODEL_AXIS, None)),
        (r".*tok_embed$", (MODEL_AXIS, None)),
        (r".*/lm_head/w$", (None, MODEL_AXIS)),
    ]
)

DP_RULES = ShardingRules(rules=[])
FSDP_RULES = ShardingRules(rules=[], auto_fsdp=True)
FSDP_TP_RULES = ShardingRules(rules=TP_RULES.rules, auto_fsdp=True)

STRATEGIES = {
    "dp": DP_RULES,
    "zero2": DP_RULES,
    "fsdp": FSDP_RULES,
    "tp": TP_RULES,
    "fsdp_tp": FSDP_TP_RULES,
}


def param_path(name: str) -> str:
    """A ``state_dict`` name as the JAX package's tree path string."""
    return "/" + name.replace(".", "/")


def _auto_fsdp_spec(shape, spec, mesh: Mesh) -> tuple:
    """Fill the largest still-replicated, divisible dim with the data axis."""
    if DATA_AXIS not in mesh.shape:
        return spec
    n = mesh.shape[DATA_AXIS]
    best = None
    for i, (dim, s) in enumerate(zip(shape, spec)):
        if s is None and dim % n == 0 and dim >= n:
            if best is None or dim > shape[best]:
                best = i
    if best is None:
        return spec
    out = list(spec)
    out[best] = DATA_AXIS
    return tuple(out)


def _spec_for(path_s: str, shape, rules: ShardingRules, mesh: Mesh) -> tuple:
    spec = tuple(None for _ in shape)
    for pattern, template in rules.rules:
        if re.match(pattern, path_s):
            if len(template) == len(shape) - 1:
                template = (None,) + tuple(template)  # a scan-stacked leaf
            if len(template) != len(shape):
                break
            spec = tuple(ax if ax is not None and ax in mesh.shape and mesh.shape[ax] > 1 and dim % mesh.shape[ax] == 0
                         else None for ax, dim in zip(template, shape))
            break
    if rules.auto_fsdp:
        spec = _auto_fsdp_spec(shape, spec, mesh)
    return spec


def param_sharding(params, mesh: Mesh, strategy: str | ShardingRules = "fsdp") -> dict[str, tuple]:
    """{name: spec} of a model's parameters and buffers (or of a {name:
    array} dict) under the named strategy."""
    rules = STRATEGIES[strategy] if isinstance(strategy, str) else strategy
    leaves = params.state_dict() if isinstance(params, torch.nn.Module) else params
    return {name: _spec_for(param_path(name), tuple(leaf.shape), rules, mesh) for name, leaf in leaves.items()}


def batch_sharding(mesh: Mesh) -> tuple:
    """The spec of batch leaves: the leading (batch) dim on ``data``."""
    return (DATA_AXIS if mesh.shape.get(DATA_AXIS, 1) > 1 else None,)


def accum_batch_sharding(mesh: Mesh) -> tuple:
    """The spec of (accum, batch, ...) leaves: the batch dim on ``data``."""
    return (None,) + batch_sharding(mesh)


def shard_params(model, mesh: Mesh, strategy: str = "tp", *, training: bool = False, row: int = 0):
    """The tensor-parallel form of an unsharded reader -- a causal LM, or
    an encoder-decoder of any family -- over the ``model`` devices of
    ``mesh``'s data row ``row`` under ``strategy`` (tp or fsdp_tp): each
    leaf the specs split on ``model`` is split onto the devices (attention
    by heads, where they divide: every attention of the model splits, or
    none; see ``TPCausalLM``, ``TPEncoderDecoder``), the rest replicated on
    the row's lead device.  A leaf the rules leave whole stays whole: an
    mBART FFN (``fc1`` / ``fc2``), T5's relative-bias tables, a vocabulary
    that does not divide.  The result shares no parameter storage with
    ``model`` except replicated modules already on the lead device.

    Serving (the default) takes a float reader on a ``{"model": n}`` mesh.
    ``training=True`` is the trainer's, for a causal LM or an
    encoder-decoder: the mesh may have a data axis (``train/mesh.py``
    splits the parts over it for fsdp_tp and replicates them over it for
    tp) and the base may be int8, nf4 or nf4-dq (the codes and their
    scales split like ``w``, JAX parallel/sharding.py:44-63;
    ``layers.split_dense``)."""
    from ..models.causal_lm import CausalLM, TPCausalLM
    from ..models.families import EncoderDecoder, TPEncoderDecoder, s2s_module

    if strategy not in ("tp", "fsdp_tp"):
        raise NotImplementedError(f"strategy {strategy!r} shards over the data axis for training (train/mesh.py); "
                                  "shard_params makes the tensor-parallel reader of tp and fsdp_tp")
    if not isinstance(model, (CausalLM, EncoderDecoder)) or isinstance(model, (TPCausalLM, TPEncoderDecoder)):
        raise ValueError("shard_params splits an unsharded causal reader (CausalLM) or encoder-decoder "
                         "(EncoderDecoder)")
    specs = param_sharding(model, mesh, strategy)
    if not training:
        if any(DATA_AXIS in spec for spec in specs.values()):
            raise NotImplementedError("parameters sharded over the data axis (fsdp) are the trainer's; "
                                      "serve over a {'model': n} mesh")
        if any(name.endswith(("w_q", "w_s", "s_q")) for name in specs):
            raise ValueError("--reader-strategy shards plain bf16 readers; drop --reader-quantize (int8/nf4 packing "
                             "hides the dims the sharding rules split)")
    cfg = model.cfg

    def split(name: str, dim: int) -> bool:
        spec = specs.get(name)
        return spec is not None and spec[dim] == MODEL_AXIS

    def dense_split(prefix: str) -> bool:
        return split(f"{prefix}.w", 1) or split(f"{prefix}.w_q", 1)

    if isinstance(model, CausalLM):
        layers = [f"blocks.{i}" for i in range(cfg.n_layers)]
        attns = [f"{layer}.attn" for layer in layers]
        cls = TPCausalLM
    else:
        layers = ([f"enc_blocks.{i}" for i in range(cfg.n_layers)]
                  + [f"dec_blocks.{i}" for i in range(cfg.decoder_layers)])
        attns = [f"{layer}.attn" for layer in layers] + [f"dec_blocks.{i}.cross_attn"
                                                        for i in range(cfg.decoder_layers)]
        cls = s2s_module(cfg).TP_MODEL
    mlp = all(dense_split(f"{layer}.mlp.wi") for layer in layers)
    attn = all(dense_split(f"{name}.wq") for name in attns)
    return cls(model, mesh.grid()[row], split_attention=attn, split_mlp=mlp, split_vocab=split("tok_embed", 0),
               split_head=split("lm_head.w", 1))
