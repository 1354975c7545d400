"""T5 / mT5-family encoder-decoder, in the Hugging Face layout.

Counterpart of ``vietnamese_qa_system_tpu/models/t5.py:48-466``:

- RMS norms with no bias (a bias-free ``LayerNorm``).
- No position table: one shared bucketed relative bias a stack
  (``enc_rel_bias``: bidirectional buckets; ``dec_rel_bias``: causal
  buckets), none on cross-attention.
- Unscaled attention scores (``scale=1.0``), inner width ``n_heads *
  d_kv`` (mt5-small: 384 against d_model 512), no biases anywhere.
- FFN: gated tanh-GELU ``gelu_new(wg(x)) * wi(x) -> wo`` (v1.1 / mT5), or
  ``relu(wi(x)) -> wo`` (v1.0).
- Logits: an untied ``lm_head``, or the tied embedding with the hidden
  states scaled by ``d_model ** -0.5``.
- With ``use_flash_attention`` and T >= 256 the self-attention of both
  stacks runs the flash kernels (K4, K7) with the full (H, T, T) relative
  bias: the encoder's with the encoder mask's ``kv_lens``, the decoder's
  causal with the decoder mask's.  The bias gets a zero cotangent there
  (LoRA and inference only; the trainer refuses full fine-tuning).

``TPT5`` is the family split tensor-parallel (``families.
TPEncoderDecoder``): heads, the FFN hidden and the vocabulary over a
mesh's ``model`` devices, the relative biases computed once on the lead.

The bucket ids are computed on the host in numpy float32, in the JAX
package's order of operations, once per width (bit-equal to JAX's; the
tests hold them over distances 0-4,096).  The per-step decoder bias of a
slot engine's per-row cursors is gathered on the device, by cursor, from
a host-made (total + 1, total) bucket table, so a decode step reads
nothing back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .causal_lm import CHUNKED_XENT_MIN_VOCAB, IGNORE_INDEX, _init_dense_norms
from .config import ModelConfig
from .encoder import relative_attention_bias
from .families import EncoderDecoder, TPEncoderDecoder, xent
from .layers import MLP, Attention, Dense, LayerNorm, _matmul, causal_mask, padding_mask, remat_wrap
from .quantize import quantize_dense_tree


class T5FFN(MLP):
    """T5's feed-forward: gated tanh-GELU ``wo(gelu_new(wg(x)) * wi(x))``
    (v1.1 / mT5), or ``wo(relu(wi(x)))`` (v1.0); ``activation`` is unused
    (a tensor-parallel part is called as an ``MLP``)."""

    def forward(self, x, activation: str | None = None):
        if self.wg is not None:
            h = F.gelu(self.wg(x), approximate="tanh") * self.wi(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(h)


class T5Block(nn.Module):
    """An encoder block (``ln1``, ``attn``, ``ln2``, ``mlp``), or with
    ``cross`` a decoder block (plus ``ln_cross``, ``cross_attn``)."""

    def __init__(self, cfg: ModelConfig, *, cross: bool, device=None):
        super().__init__()
        d, inner, eps = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.norm_eps

        def attn():
            return Attention(d, q_dim=inner, qkv_bias=False, o_bias=False, device=device)

        self.ln1 = LayerNorm(d, eps, bias=False, device=device)
        self.attn = attn()
        if cross:
            self.ln_cross = LayerNorm(d, eps, bias=False, device=device)
            self.cross_attn = attn()
        self.ln2 = LayerNorm(d, eps, bias=False, device=device)
        self.mlp = T5FFN(d, cfg.d_ff, gated=cfg.mlp_gated, use_bias=False, device=device)


def causal_bucket(rel: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5 UNIDIRECTIONAL buckets (int64) of ``rel`` = key - query positions
    (t5.py:134-148): a future key is bucket 0, past distances below
    ``num_buckets // 2`` are exact, farther ones log-spaced, in the JAX
    package's f32 arithmetic."""
    n = -np.minimum(rel, 0)
    max_exact = num_buckets // 2
    f32 = np.float32
    scaled = np.log(n.astype(f32) / f32(max_exact) + f32(1e-9)) / np.log(f32(max_distance / max_exact))
    val_large = max_exact + (scaled * f32(num_buckets - max_exact)).astype(np.int32)
    val_large = np.minimum(val_large, num_buckets - 1)
    return np.where(n < max_exact, n, val_large).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _causal_buckets(total: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """(total + 1, total) :func:`causal_bucket` table for query positions
    0..total against keys 0..total-1."""
    return causal_bucket(np.arange(total)[None, :] - np.arange(total + 1)[:, None], num_buckets, max_distance)


@functools.lru_cache(maxsize=16)
def _causal_bucket_rows(total: int, num_buckets: int, max_distance: int, device: str) -> torch.Tensor:
    """:func:`_causal_buckets` on ``device``, made once a width and
    device; never written to."""
    return torch.from_numpy(_causal_buckets(total, num_buckets, max_distance)).to(device)


def decoder_bias(table, q_pos, total: int, cfg: ModelConfig):
    """(buckets, H) -> the decoder's causal bias against keys 0..total-1
    (t5.py:163-179): for an int ``q_pos`` (1, H, 1, total), for a (B,)
    tensor of per-row positions (B, H, 1, total), gathered by position on
    the device."""
    rows = _causal_bucket_rows(total, cfg.relative_attention_buckets, cfg.relative_attention_max_distance,
                               str(table.device))
    if isinstance(q_pos, torch.Tensor):
        return table[rows[q_pos.long()]].permute(0, 2, 1)[:, :, None, :]
    return table[rows[q_pos]].T[None, :, None, :]


def full_decoder_bias(table, t: int, cfg: ModelConfig):
    """(buckets, H) -> (1, H, T, T) causal bias of T decoder slots."""
    rows = _causal_bucket_rows(t, cfg.relative_attention_buckets, cfg.relative_attention_max_distance,
                               str(table.device))
    return table[rows[:t]].permute(2, 0, 1)[None]


class T5(EncoderDecoder):
    """Parameters named as the JAX t5 pytree (``tok_embed``,
    ``enc_rel_bias``, ``dec_rel_bias``, ``enc_blocks.0.attn.wq.w``,
    ``dec_blocks.0.cross_attn.wk.w``, ``enc_ln_f.scale``, ``lm_head.w``, ...)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.arch != "seq2seq" or cfg.seq2seq_family != "t5":
            raise ValueError("T5 needs arch='seq2seq', seq2seq_family='t5'")
        self.cfg = cfg
        d = cfg.d_model
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_size, d, device=device))
        self.enc_rel_bias = nn.Parameter(torch.empty(cfg.relative_attention_buckets, cfg.n_heads, device=device))
        self.dec_rel_bias = nn.Parameter(torch.empty(cfg.relative_attention_buckets, cfg.n_heads, device=device))
        self.enc_blocks = nn.ModuleList(T5Block(cfg, cross=False, device=device) for _ in range(cfg.n_layers))
        self.enc_ln_f = LayerNorm(d, cfg.norm_eps, bias=False, device=device)
        self.dec_blocks = nn.ModuleList(T5Block(cfg, cross=True, device=device) for _ in range(cfg.decoder_layers))
        self.dec_ln_f = LayerNorm(d, cfg.norm_eps, bias=False, device=device)
        self.lm_head = None if cfg.tie_embeddings else Dense(d, cfg.vocab_size, use_bias=False, device=device)

    def _run(self, layer):
        """A cache-less ``layer``, under per-layer remat where the JAX
        package scans with it (``scan_layers``)."""
        cfg = self.cfg
        if cfg.scan_layers and cfg.remat_policy != "none":
            return remat_wrap(layer, cfg.remat_policy)
        return layer

    def encode(self, ids, attn_mask):
        """ids / attn_mask (B, T) -> (B, T, D) f32 hidden states."""
        cfg = self.cfg
        b, t = ids.shape
        x = self.embed(ids)
        bias = relative_attention_bias(self.enc_rel_bias, t, cfg)
        mask = padding_mask(attn_mask).expand(b, t, t)
        flash = None
        if cfg.use_flash_attention and t >= 256:
            flash = {"kv_lens": attn_mask.sum(dim=1).to(torch.int32), "causal": False}
        for blk in self.enc_blocks:
            def layer(h, blk=blk):
                h = h + blk.attn(blk.ln1(h), n_heads=cfg.n_heads, mask=mask, bias=bias, scale=1.0, flash=flash)
                return h + blk.mlp(blk.ln2(h))

            x = self._run(layer)(x)
        return self.enc_ln_f(x)

    def head_weight(self):
        """(D, V) classifier; a tied head scales its input (see :meth:`head`)."""
        return self.lm_head.w if self.lm_head is not None else self.tok_embed.T

    def head_input(self, x):
        """The hidden states as the classifier reads them: scaled by
        ``d_model ** -0.5`` under a tied head (T5 v1.0)."""
        return x * (self.cfg.d_model ** -0.5) if self.cfg.tie_embeddings else x

    def head(self, x):
        if self.lm_head is not None:
            return self.lm_head(x)
        return _matmul(self.head_input(x), self.tok_embed.T)

    def decode(self, dec_ids, enc_out, enc_mask, dec_mask=None, *, positions=None, cache=None, cache_index=None,
               hidden_only: bool = False, cross_kv=None):
        """Decoder logits (B, T, V) f32, or the final-norm hidden states
        with ``hidden_only``.  Without ``cache``: causal over ``dec_ids``
        (and ``dec_mask`` (B, T) keys), cross-attending ``enc_out``.  With
        ``cache``: ``dec_mask`` (B, T, total) bool covers the attended
        slots, the new K/V are written at ``cache_index`` (an int or (B,)
        per-row cursors) and cross-attention reads ``cross_kv`` (computed
        from ``enc_out`` when None).  ``positions`` is unused: the
        relative bias takes the query position from ``cache_index``."""
        cfg = self.cfg
        b, t = dec_ids.shape
        x = self.embed(dec_ids)
        cross_mask = padding_mask(enc_mask).expand(b, t, enc_mask.shape[1])
        if cache is None:
            bias = full_decoder_bias(self.dec_rel_bias, t, cfg)
            mask = causal_mask(t, x.device)
            if dec_mask is not None:
                mask = mask & dec_mask[:, None, :].bool()
            flash = None
            if cfg.use_flash_attention and t >= 256:
                lens = dec_mask.sum(dim=1).to(torch.int32) if dec_mask is not None else None
                flash = {"kv_lens": lens, "causal": True}
            for blk in self.dec_blocks:
                def layer(h, blk=blk):
                    h = h + blk.attn(blk.ln1(h), n_heads=cfg.n_heads, mask=mask, bias=bias, scale=1.0, flash=flash)
                    h = h + blk.cross_attn(blk.ln_cross(h), n_heads=cfg.n_heads, kv_x=enc_out, mask=cross_mask,
                                           scale=1.0)
                    return h + blk.mlp(blk.ln2(h))

                x = self._run(layer)(x)
        else:
            total = dec_mask.shape[-1] if dec_mask is not None else cache[0]["k"].shape[1]
            bias = decoder_bias(self.dec_rel_bias, cache_index, total, cfg)
            if cross_kv is None:
                cross_kv = self.precompute_cross_kv(enc_out)
            for i, blk in enumerate(self.dec_blocks):
                x = x + blk.attn(blk.ln1(x), n_heads=cfg.n_heads, mask=dec_mask, bias=bias, scale=1.0,
                                 cache=self.layer_cache(cache, i), cache_index=cache_index)
                x = x + blk.cross_attn(blk.ln_cross(x), n_heads=cfg.n_heads, mask=cross_mask, scale=1.0,
                                       static_kv=self.layer_cache(cross_kv, i))
                x = x + blk.mlp(blk.ln2(x))
        x = self.dec_ln_f(x)
        return x if hidden_only else self.head(x)


class TPT5(TPEncoderDecoder, T5):
    """A :class:`T5` split tensor-parallel (``families.TPEncoderDecoder``)."""


MODEL = T5
TP_MODEL = TPT5


def loss_fn(model: T5, batch: dict):
    """Seq2seq cross-entropy (t5.py:436-466): decoder inputs are the labels
    shifted right with start 0 (T5's decoder_start_token_id = pad), -100
    labels excluded; vocabularies of at least CHUNKED_XENT_MIN_VOCAB
    stream the head in chunks (ops/xent.py), each vocabulary part of a
    tensor-parallel head on its device, the input scaled first under a
    tied head (``head_input``).  -> (mean_loss, n)."""
    labels = batch["labels"]
    start = torch.zeros_like(labels[:, :1])
    dec_in = torch.cat([start, torch.where(labels == IGNORE_INDEX, 0, labels)[:, :-1]], dim=1)
    dec_mask = (labels != IGNORE_INDEX).to(torch.int32)
    enc_out = model.encode(batch["input_ids"], batch["attention_mask"])
    if model.cfg.vocab_size >= CHUNKED_XENT_MIN_VOCAB:
        from ..ops.xent import masked_mean_xent

        h = model.decode(dec_in, enc_out, batch["attention_mask"], dec_mask, hidden_only=True)
        return masked_mean_xent(model.head_input(h), model.classifier_parts(), labels, IGNORE_INDEX)
    return xent(model.decode(dec_in, enc_out, batch["attention_mask"], dec_mask), labels)


def init(cfg: ModelConfig, generator: torch.Generator, *, quantize: str | None = None) -> T5:
    """Random weights with the JAX ``init_t5`` distributions: embeddings
    N(0, 1), relative-bias tables and an untied head N(0, 0.02^2), dense
    weights U(-1/sqrt(d_in), 1/sqrt(d_in)), unit norm scales; drawn on the
    generator's device a layer at a time, each quantized as it is made
    with ``quantize``.  Frozen (``requires_grad`` False)."""
    device = generator.device
    model = T5(cfg, device="meta")
    model.enc_blocks, model.dec_blocks = nn.ModuleList(), nn.ModuleList()
    model.to_empty(device=device)
    with torch.no_grad():
        model.tok_embed.normal_(0.0, 1.0, generator=generator)
        model.enc_rel_bias.normal_(0.0, 0.02, generator=generator)
        model.dec_rel_bias.normal_(0.0, 0.02, generator=generator)
        for blocks, n, cross in ((model.enc_blocks, cfg.n_layers, False), (model.dec_blocks, cfg.decoder_layers, True)):
            for _ in range(n):
                blk = T5Block(cfg, cross=cross, device=device)
                _init_dense_norms(blk, generator)
                if quantize:
                    quantize_dense_tree(blk, quantize)
                blocks.append(blk)
        _init_dense_norms(model.enc_ln_f, generator)
        _init_dense_norms(model.dec_ln_f, generator)
        if model.lm_head is not None:
            model.lm_head.w.normal_(0.0, 0.02, generator=generator)
    return model.eval().requires_grad_(False)
