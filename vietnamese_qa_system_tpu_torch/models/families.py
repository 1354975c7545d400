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

:class:`TPEncoderDecoder` is an encoder-decoder split tensor-parallel over
a mesh (the counterpart of the JAX package's tp-sharded seq2seq params
under GSPMD), made by ``parallel.sharding.shard_params``; each family
module's ``TP_MODEL`` puts it ahead of the family's class, whose
``encode`` and ``decode`` then run over the parts.
"""

from __future__ import annotations

import torch
from torch import nn

from .causal_lm import IGNORE_INDEX, make_cache
from .config import ModelConfig
from .layers import SplitVocab, clone_module, head_groups, tp_block


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
    define ``encode`` and ``decode``, which read a decoder layer's cache
    and cross K/V through :meth:`layer_cache`."""

    cfg: ModelConfig

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def embed(self, ids):
        """Token embeddings (B, T, D) of ``ids``, unscaled."""
        return self.tok_embed[ids.long()]

    def head_input(self, x):
        """The hidden states as the classifier reads them."""
        return x

    def head_weight(self):
        """(D, V) classifier: the embedding transpose for a tied head."""
        return self.tok_embed.T

    def classifier_parts(self) -> list:
        """The classifier as (D, V_j) parts over consecutive vocabulary
        ranges, each on its device (the chunked loss streams each on its
        device, ops/xent.py): one part here."""
        return [self.head_weight()]

    def precompute_cross_kv(self, enc_out) -> list[dict]:
        """Per decoder layer, the cross-attention K/V of ``enc_out``
        (computed once a sequence; the HF past_key_values cross half)."""
        return [blk.cross_attn.cross_kv(enc_out, self.cfg.n_heads) for blk in self.dec_blocks]

    def make_cache(self, b: int, total: int) -> list[dict]:
        """A bf16 decoder self-attention cache, ``total`` slots a row."""
        return make_cache(self.cfg, b, total, self.device, n_layers=self.cfg.decoder_layers)

    def make_cross_cache(self, b: int, width: int) -> list[dict]:
        """Zero bf16 cross-attention K/V buffers ``width`` encoder positions
        wide, laid out as :meth:`precompute_cross_kv` returns them (the
        slot engine's per-slot cross K/V)."""
        return make_cache(self.cfg, b, width, self.device, n_layers=self.cfg.decoder_layers)

    def layer_cache(self, cache, i: int):
        """Decoder layer ``i``'s part of a cache (or of the cross K/V)."""
        return cache[i]

    def forward(self, batch: dict):
        """{"input_ids", "attention_mask", "decoder_input_ids"[,
        "decoder_attention_mask"]} -> decoder logits (B, T_dec, V) f32."""
        enc_out = self.encode(batch["input_ids"], batch["attention_mask"])
        return self.decode(batch["decoder_input_ids"], enc_out, batch["attention_mask"],
                           batch.get("decoder_attention_mask"))


class TPEncoderDecoder(SplitVocab, EncoderDecoder):
    """An :class:`EncoderDecoder` split tensor-parallel over the ``model``
    axis of a mesh, one controller driving every device.  A family's
    ``TP_MODEL`` (``t5.TPT5``, ``bart.TPBart``, ``seq2seq.TPSeq2Seq``)
    puts this class ahead of the family's in its bases, so ``encode`` and
    ``decode`` are the family's own, run over these parts:

    - the self- and cross-attention of every layer head-parallel
      (:class:`~.layers.TPAttention`) where the heads split over the
      devices, else whole on the lead device.  The decoder cache and the
      cross K/V then hold one dict a (layer, device), layer-major, each
      over the device's own heads (:meth:`make_cache`,
      :meth:`precompute_cross_kv`); a score bias (T5's relative bias) is
      computed once on the lead and sliced by head offset;
    - the MLP hidden split (:class:`~.layers.TPMLP`, the parts of the
      family's feed-forward class) where the sharding rules split it;
    - the vocabulary as :class:`~.layers.SplitVocab` places it; the head
      reads the family's ``head_input`` and adds a logits bias after the
      gather, and the chunked loss streams each vocabulary part on its
      device (``classifier_parts``);
    - norms, position tables, relative-bias tables and the logits bias
      replicated on the lead device, where the residual stream lives.

    For training (``train/mesh.py``; ``shard_params(training=True)``) the
    base may be float, int8, nf4 or nf4-dq, and :meth:`leaf_index` names
    the unsharded leaf each tensor holds.  Each part of a cross-attention
    reads a copy of the encoder output (autograd sums their gradients in
    f32 on the lead, where it lives); T5's relative bias is computed once
    on the lead and each part's slice carries its gradient back to the
    table (the dense path; the flash kernels give the bias a zero
    cotangent, so full fine-tuning with flash is refused)."""

    def __init__(self, model: EncoderDecoder, devices, *, split_attention: bool, split_mlp: bool,
                 split_vocab: bool, split_head: bool):
        nn.Module.__init__(self)
        cfg = self.cfg = model.cfg
        self.devices = list(devices)
        lead = self.lead = self.devices[0]
        self.groups = head_groups(cfg.n_heads, cfg.n_heads, len(self.devices)) if split_attention else None
        self.place_vocab(model, split_vocab, split_head)
        self.logits_bias = None
        for name, p in model.named_parameters(recurse=False):
            if name != "tok_embed":
                setattr(self, name, nn.Parameter(p.detach().to(lead), requires_grad=False))
        for name, mod in model.named_children():
            if name in ("enc_blocks", "dec_blocks"):
                setattr(self, name, nn.ModuleList(tp_block(blk, self.groups, cfg.head_dim, self.devices, lead,
                                                           split_mlp=split_mlp) for blk in mod))
            elif name != "lm_head":
                setattr(self, name, clone_module(mod, lead))

    def head(self, x):
        logits = self.vocab_logits(self.head_input(x))
        return logits if self.logits_bias is None else logits + self.logits_bias

    def precompute_cross_kv(self, enc_out) -> list[dict]:
        if self.groups is None:
            return super().precompute_cross_kv(enc_out)
        return [kv for blk in self.dec_blocks for kv in blk.cross_attn.cross_kv(enc_out)]

    def _per_device(self, b: int, width: int) -> list[dict]:
        return [make_cache(self.cfg, b, width, dev, n_layers=1, kv_heads=q1 - q0)[0]
                for _ in range(self.cfg.decoder_layers) for (q0, q1, _, _), dev in zip(self.groups, self.devices)]

    def make_cache(self, b: int, total: int) -> list[dict]:
        return super().make_cache(b, total) if self.groups is None else self._per_device(b, total)

    def make_cross_cache(self, b: int, width: int) -> list[dict]:
        return super().make_cross_cache(b, width) if self.groups is None else self._per_device(b, width)

    def layer_cache(self, cache, i: int):
        if self.groups is None:
            return cache[i]
        n = len(self.devices)
        return cache[i * n:(i + 1) * n]
