"""Encoder-decoder (seq2seq) families: one place to dispatch on
``ModelConfig.seq2seq_family``.

Counterpart of ``vietnamese_qa_system_tpu/models/families.py``:
``s2s_module`` names the module of a family (models/t5.py, models/bart.py,
models/seq2seq.py), ``s2s_stacked`` and ``unstack_for_decode`` read and
undo the scan-stacked form of a JAX parameter tree (numpy leaves).  The
port keeps a plain list of layers, so a stacked tree is unstacked when it
is carried over (models/params.py).

Every family's model is an :class:`EncoderDecoder` with the same surface,
the JAX functions' call contracts as methods: ``encode(ids, mask)``,
``precompute_cross_kv(enc_out)``, ``decode(dec_ids, enc_out, enc_mask,
dec_mask, *, positions, cache, cache_index, hidden_only, cross_kv)`` and
``forward(batch)``; each family module has ``MODEL`` (its class),
``loss_fn(model, batch)`` and ``init(cfg, generator, quantize=)``.  A cached ``decode`` writes the
new keys and values into ``cache`` (:meth:`EncoderDecoder.make_cache`) in
place and returns only the logits (or hidden states).
"""

from __future__ import annotations

import torch
from torch import nn

from .causal_lm import IGNORE_INDEX, make_cache
from .config import ModelConfig
from .layers import cross_attention_kv


def s2s_module(cfg: ModelConfig):
    """The module implementing ``cfg``'s encoder-decoder family."""
    if cfg.seq2seq_family == "t5":
        from . import t5

        return t5
    if cfg.seq2seq_family == "bart":
        from . import bart

        return bart
    if cfg.seq2seq_family == "native":
        from . import seq2seq

        return seq2seq
    raise ValueError(f"unknown seq2seq_family {cfg.seq2seq_family!r}")


def s2s_stacked(cfg: ModelConfig, params) -> bool:
    """True for a scan-stacked JAX tree (leading layer axis); only the t5
    family has that form."""
    return cfg.seq2seq_family == "t5" and isinstance(params.get("enc_blocks"), dict)


def _unstack(blocks, n: int) -> list:
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    return [take(blocks, i) for i in range(n)]


def unstack_for_decode(params, cfg: ModelConfig):
    """A scan-stacked JAX tree -> list-of-blocks (families.py:43-74): the
    causal ``blocks``, or the t5 ``enc_blocks`` and ``dec_blocks``.  No-op
    on list-form trees."""
    if cfg.arch == "causal":
        from .causal_lm import unstack_blocks

        return unstack_blocks(params, cfg.n_layers)
    if cfg.arch == "seq2seq" and s2s_stacked(cfg, params):
        out = dict(params)
        out["enc_blocks"] = _unstack(params["enc_blocks"], cfg.n_layers)
        out["dec_blocks"] = _unstack(params["dec_blocks"], cfg.decoder_layers)
        return out
    return params


def s2s_class(cfg: ModelConfig):
    """The :class:`EncoderDecoder` subclass of ``cfg``'s family."""
    return s2s_module(cfg).MODEL


def init_seq2seq_model(cfg: ModelConfig, generator: torch.Generator, *, quantize: str | None = None):
    """Random weights of ``cfg``'s family (its ``init_*``), drawn on the
    generator's device, each layer quantized as it is made with
    ``quantize``."""
    return s2s_module(cfg).init(cfg, generator, quantize=quantize)


def loss_fn(model, batch: dict):
    """The family's seq2seq cross-entropy -> (mean_loss, n_target)."""
    return s2s_module(model.cfg).loss_fn(model, batch)


def xent(logits, labels):
    """Token-weighted cross-entropy of (B, T, V) logits with -100 masking
    -> (mean, n) (seq2seq.py:164-178)."""
    valid = labels != IGNORE_INDEX
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None].long())[..., 0]
    n = valid.sum().clamp_min(1)
    return -torch.where(valid, token_ll, 0.0).sum() / n, n


def clamp_positions(positions, rows: int):
    """Positions past a table read its last row, as JAX's clamped gathers do."""
    return positions.long().clamp(0, rows - 1)


class EncoderDecoder(nn.Module):
    """The surface every seq2seq family shares.  Subclasses hold
    ``tok_embed``, ``enc_blocks``, ``enc_ln_f``, ``dec_blocks`` (each with
    a ``cross_attn``) and ``dec_ln_f`` under the JAX tree's names, and
    define ``encode`` and ``decode``."""

    cfg: ModelConfig

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def precompute_cross_kv(self, enc_out) -> list[dict]:
        """Per decoder layer, the cross-attention K/V of ``enc_out``
        (computed once a sequence; the HF past_key_values cross half)."""
        return [cross_attention_kv(blk.cross_attn, enc_out, self.cfg.n_heads) for blk in self.dec_blocks]

    def make_cache(self, b: int, total: int) -> list[dict]:
        """A bf16 decoder self-attention cache, ``total`` slots a row."""
        return make_cache(self.cfg, b, total, self.device, n_layers=self.cfg.decoder_layers)

    def forward(self, batch: dict):
        """{"input_ids", "attention_mask", "decoder_input_ids"[,
        "decoder_attention_mask"]} -> decoder logits (B, T_dec, V) f32."""
        enc_out = self.encode(batch["input_ids"], batch["attention_mask"])
        return self.decode(batch["decoder_input_ids"], enc_out, batch["attention_mask"],
                           batch.get("decoder_attention_mask"))
