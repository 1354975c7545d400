"""mBART-family encoder-decoder, in the Hugging Face layout.

Counterpart of ``vietnamese_qa_system_tpu/models/bart.py:57-323`` (the
architecture of the vinai-translate en->vi model and mbart-large-50):

- The shared token embedding, scaled by sqrt(d_model) with
  ``scale_embedding``; a tied head, plus ``logits_bias`` where the tree
  holds it (the importer keeps ``final_logits_bias`` only when nonzero).
- Learned absolute positions a stack, read at ``position + 2``
  (:data:`POS_OFFSET`, HF MBartLearnedPositionalEmbedding), also for the
  per-row cursors of the slot engine.
- ``layernorm_embedding`` after the embedding sum, in both stacks.
- Pre-LN blocks with biases everywhere, 1/sqrt(head_dim) attention,
  ``fc2(act(fc1(x)))`` with erf-GELU ("gelu"), "gelu_new" or "relu", and a
  final norm a stack.
- Training shifts the labels the mBART way (:func:`shift_labels_mbart`:
  the last real label rotates to position 0).

``TPBart`` is the family split tensor-parallel (``families.
TPEncoderDecoder``): heads and the vocabulary (where it divides) over a
mesh's ``model`` devices.  The sharding rules name ``wi`` / ``wg`` / ``wo``
only, so ``fc1`` / ``fc2`` stay whole on the lead device, as JAX's rules
leave them.

No scan-stacked form: ``scan_layers`` is refused, as in the JAX package.
The flash kernels are never taken here (the JAX family passes no
``flash=``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .causal_lm import CHUNKED_XENT_MIN_VOCAB, IGNORE_INDEX, _init_dense_norms
from .config import ModelConfig
from .families import EncoderDecoder, TPEncoderDecoder, clamp_positions, xent
from .layers import Attention, Dense, LayerNorm, _matmul, causal_mask, padding_mask
from .quantize import quantize_dense_tree

POS_OFFSET = 2  # HF MBartLearnedPositionalEmbedding offset


class BartFFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device=None):
        super().__init__()
        self.fc1 = Dense(d_model, d_ff, device=device)
        self.fc2 = Dense(d_ff, d_model, device=device)

    def forward(self, x, activation: str):
        h = self.fc1(x)
        if activation == "relu":
            h = F.relu(h)
        else:
            # "gelu" = erf form (mBART's activation_function); "gelu_new" = tanh
            h = F.gelu(h, approximate="tanh" if activation == "gelu_new" else "none")
        return self.fc2(h)


class BartBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, cross: bool, device=None):
        super().__init__()
        d, eps = cfg.d_model, cfg.norm_eps
        self.ln1 = LayerNorm(d, eps, device=device)
        self.attn = Attention(d, device=device)
        if cross:
            self.ln_cross = LayerNorm(d, eps, device=device)
            self.cross_attn = Attention(d, device=device)
        self.ln2 = LayerNorm(d, eps, device=device)
        self.mlp = BartFFN(d, cfg.d_ff, device=device)


class Bart(EncoderDecoder):
    """Parameters named as the JAX bart pytree (``tok_embed``,
    ``enc_pos_embed``, ``dec_pos_embed``, ``enc_ln_emb``, ``dec_ln_emb``,
    ``enc_blocks.0.mlp.fc1.w``, ``dec_blocks.0.cross_attn.wq.b``, ...,
    ``logits_bias`` where the tree has it)."""

    def __init__(self, cfg: ModelConfig, *, logits_bias: bool = False, device=None):
        super().__init__()
        if cfg.arch != "seq2seq" or cfg.seq2seq_family != "bart":
            raise ValueError("Bart needs arch='seq2seq', seq2seq_family='bart'")
        if cfg.scan_layers:
            raise ValueError("the bart family has no scan-over-layers form (mBART-class depth compiles fine "
                             "unrolled) -- set scan_layers=False")
        self.cfg = cfg
        d = cfg.d_model
        rows = cfg.max_seq_len + POS_OFFSET
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_size, d, device=device))
        self.enc_pos_embed = nn.Parameter(torch.empty(rows, d, device=device))
        self.dec_pos_embed = nn.Parameter(torch.empty(rows, d, device=device))
        self.enc_ln_emb = LayerNorm(d, cfg.norm_eps, device=device)
        self.dec_ln_emb = LayerNorm(d, cfg.norm_eps, device=device)
        self.enc_blocks = nn.ModuleList(BartBlock(cfg, cross=False, device=device) for _ in range(cfg.n_layers))
        self.enc_ln_f = LayerNorm(d, cfg.norm_eps, device=device)
        self.dec_blocks = nn.ModuleList(BartBlock(cfg, cross=True, device=device)
                                        for _ in range(cfg.decoder_layers))
        self.dec_ln_f = LayerNorm(d, cfg.norm_eps, device=device)
        self.logits_bias = nn.Parameter(torch.empty(cfg.vocab_size, device=device)) if logits_bias else None

    def _embed(self, ids):
        x = self.embed(ids)
        return x * (float(self.cfg.d_model) ** 0.5) if self.cfg.scale_embedding else x

    def encode(self, ids, attn_mask):
        """ids / attn_mask (B, T) -> (B, T, D) f32 hidden states."""
        cfg = self.cfg
        b, t = ids.shape
        # positions past the table read its last row (see seq2seq.Seq2Seq.encode)
        pos = clamp_positions(torch.arange(t, device=ids.device) + POS_OFFSET, self.enc_pos_embed.shape[0])
        x = self._embed(ids) + self.enc_pos_embed[pos][None]
        x = self.enc_ln_emb(x)
        mask = padding_mask(attn_mask).expand(b, t, t)
        for blk in self.enc_blocks:
            x = x + blk.attn(blk.ln1(x), n_heads=cfg.n_heads, mask=mask)
            x = x + blk.mlp(blk.ln2(x), cfg.activation)
        return self.enc_ln_f(x)

    def head(self, x):
        out = _matmul(x, self.tok_embed.T)
        return out if self.logits_bias is None else out + self.logits_bias

    def decode(self, dec_ids, enc_out, enc_mask, dec_mask=None, *, positions=None, cache=None, cache_index=None,
               hidden_only: bool = False, cross_kv=None):
        """As ``T5.decode``; ``positions`` (B, T) are absolute decoder
        positions (0-based; default ``arange(T)``), offset by 2 here."""
        cfg = self.cfg
        b, t = dec_ids.shape
        if positions is None:
            positions = torch.arange(t, device=dec_ids.device)[None, :].expand(b, t)
        x = self._embed(dec_ids) + self.dec_pos_embed[clamp_positions(positions + POS_OFFSET,
                                                                      self.dec_pos_embed.shape[0])]
        x = self.dec_ln_emb(x)
        cross_mask = padding_mask(enc_mask).expand(b, t, enc_mask.shape[1])
        if cache is None:
            self_mask = causal_mask(t, x.device)
            if dec_mask is not None:
                self_mask = self_mask & dec_mask[:, None, :].bool()
            for blk in self.dec_blocks:
                x = x + blk.attn(blk.ln1(x), n_heads=cfg.n_heads, mask=self_mask)
                x = x + blk.cross_attn(blk.ln_cross(x), n_heads=cfg.n_heads, kv_x=enc_out, mask=cross_mask)
                x = x + blk.mlp(blk.ln2(x), cfg.activation)
        else:
            if cross_kv is None:
                cross_kv = self.precompute_cross_kv(enc_out)
            for i, blk in enumerate(self.dec_blocks):
                x = x + blk.attn(blk.ln1(x), n_heads=cfg.n_heads, mask=dec_mask, cache=self.layer_cache(cache, i),
                                 cache_index=cache_index)
                x = x + blk.cross_attn(blk.ln_cross(x), n_heads=cfg.n_heads, mask=cross_mask,
                                       static_kv=self.layer_cache(cross_kv, i))
                x = x + blk.mlp(blk.ln2(x), cfg.activation)
        x = self.dec_ln_f(x)
        return x if hidden_only else self.head(x)


class TPBart(TPEncoderDecoder, Bart):
    """A :class:`Bart` split tensor-parallel (``families.TPEncoderDecoder``)."""


MODEL = Bart
TP_MODEL = TPBart


def shift_labels_mbart(labels, pad_id: int = 1):
    """mBART's ``shift_tokens_right`` (bart.py:267-283): the labels rotated
    right by one, the last non-ignored token of each row (the language id)
    wrapped to position 0; -100 positions become ``pad_id``."""
    clean = torch.where(labels == IGNORE_INDEX, pad_id, labels)
    last = ((labels != IGNORE_INDEX).sum(dim=1) - 1).clamp_min(0)
    start = clean.gather(1, last[:, None])
    return torch.cat([start, clean[:, :-1]], dim=1)


def loss_fn(model: Bart, batch: dict):
    """Seq2seq cross-entropy with the mBART rotation shift (bart.py:286-323);
    -100 labels excluded.  The chunked head of a real vocabulary has no
    bias hook, so a nonzero ``logits_bias`` raises there."""
    chunked = model.cfg.vocab_size >= CHUNKED_XENT_MIN_VOCAB
    if chunked and model.logits_bias is not None:
        raise ValueError("chunked xent does not support a nonzero final_logits_bias")
    labels = batch["labels"]
    dec_in = shift_labels_mbart(labels)
    dec_mask = (labels != IGNORE_INDEX).to(torch.int32)
    enc_out = model.encode(batch["input_ids"], batch["attention_mask"])
    if chunked:
        from ..ops.xent import masked_mean_xent

        h = model.decode(dec_in, enc_out, batch["attention_mask"], dec_mask, hidden_only=True)
        return masked_mean_xent(h, model.classifier_parts(), labels, IGNORE_INDEX)
    return xent(model.decode(dec_in, enc_out, batch["attention_mask"], dec_mask), labels)


def init(cfg: ModelConfig, generator: torch.Generator, *, quantize: str | None = None) -> Bart:
    """Random weights with the JAX ``init_bart`` distributions: embeddings
    and position tables N(0, 0.02^2), dense weights U(-1/sqrt(d_in),
    1/sqrt(d_in)) with zero biases, unit norms; drawn on the generator's
    device a layer at a time (quantized as made with ``quantize``)."""
    device = generator.device
    model = Bart(cfg, device="meta")
    model.enc_blocks, model.dec_blocks = nn.ModuleList(), nn.ModuleList()
    model.to_empty(device=device)
    with torch.no_grad():
        for p in (model.tok_embed, model.enc_pos_embed, model.dec_pos_embed):
            p.normal_(0.0, 0.02, generator=generator)
        for blocks, n, cross in ((model.enc_blocks, cfg.n_layers, False), (model.dec_blocks, cfg.decoder_layers, True)):
            for _ in range(n):
                blk = BartBlock(cfg, cross=cross, device=device)
                _init_dense_norms(blk, generator)
                if quantize:
                    quantize_dense_tree(blk, quantize)
                blocks.append(blk)
        for ln in (model.enc_ln_emb, model.dec_ln_emb, model.enc_ln_f, model.dec_ln_f):
            _init_dense_norms(ln, generator)
    return model.eval().requires_grad_(False)
