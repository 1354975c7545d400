"""The native encoder-decoder: learned positions in the encoder, RoPE in
the decoder, pre-LN biased blocks with cross-attention.

Counterpart of ``vietnamese_qa_system_tpu/models/seq2seq.py:29-178``
(``encode``, ``precompute_cross_kv``, ``decode`` with a scalar or a (B,)
``cache_index``, ``forward``, ``loss_fn``).  RoPE rotates the decoder's
self-attention only, never the cross half.  ``TPSeq2Seq`` is the stack
split tensor-parallel (``families.TPEncoderDecoder``).
"""

from __future__ import annotations

import torch
from torch import nn

from .causal_lm import CHUNKED_XENT_MIN_VOCAB, IGNORE_INDEX, _init_dense_norms
from .config import ModelConfig
from .families import EncoderDecoder, TPEncoderDecoder, clamp_positions, xent
from .layers import Block, LayerNorm, _matmul, causal_mask, padding_mask, rope_frequencies
from .quantize import quantize_dense_tree


def _block(cfg: ModelConfig, cross: bool, device) -> Block:
    return Block(cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.norm_eps, cross=cross, device=device)


class Seq2Seq(EncoderDecoder):
    """Parameters named as the JAX seq2seq pytree (``tok_embed``,
    ``enc_pos_embed``, ``enc_blocks.0.attn.wq.w``,
    ``dec_blocks.0.cross_attn.wk.b``, ``enc_ln_f.scale``, ...)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.arch != "seq2seq" or cfg.seq2seq_family != "native":
            raise ValueError("Seq2Seq needs arch='seq2seq', seq2seq_family='native'")
        self.cfg = cfg
        d = cfg.d_model
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_size, d, device=device))
        self.enc_pos_embed = nn.Parameter(torch.empty(cfg.max_seq_len, d, device=device))
        self.enc_blocks = nn.ModuleList(_block(cfg, False, device) for _ in range(cfg.n_layers))
        self.enc_ln_f = LayerNorm(d, cfg.norm_eps, device=device)
        self.dec_blocks = nn.ModuleList(_block(cfg, True, device) for _ in range(cfg.decoder_layers))
        self.dec_ln_f = LayerNorm(d, cfg.norm_eps, device=device)

    def encode(self, ids, attn_mask):
        """ids / attn_mask (B, T) -> (B, T, D) f32 hidden states."""
        b, t = ids.shape
        # positions past the table read its last row (JAX's slice raises
        # there): only padding sits past it when the input fits the table
        pos = clamp_positions(torch.arange(t, device=ids.device), self.enc_pos_embed.shape[0])
        x = self.embed(ids) + self.enc_pos_embed[pos][None]
        mask = padding_mask(attn_mask).expand(b, t, t)
        for blk in self.enc_blocks:
            x = blk(x, mask=mask)
        return self.enc_ln_f(x)

    def head(self, x):
        return _matmul(x, self.tok_embed.T)

    def decode(self, dec_ids, enc_out, enc_mask, dec_mask=None, *, positions=None, cache=None, cache_index=None,
               hidden_only: bool = False, cross_kv=None):
        """As ``T5.decode``; ``positions`` (B, T) are the decoder's RoPE
        positions (default ``arange(T)``)."""
        cfg = self.cfg
        b, t = dec_ids.shape
        dev = dec_ids.device
        if positions is None:
            positions = torch.arange(t, device=dev)[None, :].expand(b, t)
        positions = clamp_positions(positions, cfg.max_seq_len)
        x = self.embed(dec_ids)
        rope = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device=dev)
        cross_mask = padding_mask(enc_mask).expand(b, t, enc_mask.shape[1])
        if cache is None:
            mask = causal_mask(t, dev)
            if dec_mask is not None:
                mask = mask & dec_mask[:, None, :].bool()
            for blk in self.dec_blocks:
                x = blk(x, mask=mask, enc_out=enc_out, enc_mask=cross_mask, rope=rope, positions=positions)
        else:
            if cross_kv is None:
                cross_kv = self.precompute_cross_kv(enc_out)
            for i, blk in enumerate(self.dec_blocks):
                x = blk(x, mask=dec_mask, enc_mask=cross_mask, cross_kv=self.layer_cache(cross_kv, i), rope=rope,
                        positions=positions, cache=self.layer_cache(cache, i), cache_index=cache_index)
        x = self.dec_ln_f(x)
        return x if hidden_only else self.head(x)


class TPSeq2Seq(TPEncoderDecoder, Seq2Seq):
    """A :class:`Seq2Seq` split tensor-parallel (``families.TPEncoderDecoder``)."""


MODEL = Seq2Seq
TP_MODEL = TPSeq2Seq


def loss_fn(model: Seq2Seq, batch: dict):
    """Seq2seq cross-entropy (seq2seq.py:145-178): decoder inputs are the
    labels shifted right with start 0, -100 labels excluded, the chunked
    head at real vocabularies."""
    labels = batch["labels"]
    start = torch.zeros_like(labels[:, :1])
    dec_in = torch.cat([start, torch.where(labels == IGNORE_INDEX, 0, labels)[:, :-1]], dim=1)
    dec_mask = (labels != IGNORE_INDEX).to(torch.int32)
    enc_out = model.encode(batch["input_ids"], batch["attention_mask"])
    if model.cfg.vocab_size >= CHUNKED_XENT_MIN_VOCAB:
        from ..ops.xent import masked_mean_xent

        h = model.decode(dec_in, enc_out, batch["attention_mask"], dec_mask, hidden_only=True)
        return masked_mean_xent(h, model.classifier_parts(), labels, IGNORE_INDEX)
    return xent(model.decode(dec_in, enc_out, batch["attention_mask"], dec_mask), labels)


def init(cfg: ModelConfig, generator: torch.Generator, *, quantize: str | None = None) -> Seq2Seq:
    """Random weights with the JAX ``init_seq2seq`` distributions:
    embeddings N(0, 0.02^2), dense weights U(-1/sqrt(d_in), 1/sqrt(d_in))
    with zero biases, unit norms; drawn on the generator's device a layer
    at a time (quantized as made with ``quantize``)."""
    device = generator.device
    model = Seq2Seq(cfg, device="meta")
    model.enc_blocks, model.dec_blocks = nn.ModuleList(), nn.ModuleList()
    model.to_empty(device=device)
    with torch.no_grad():
        model.tok_embed.normal_(0.0, 0.02, generator=generator)
        model.enc_pos_embed.normal_(0.0, 0.02, generator=generator)
        for blocks, n, cross in ((model.enc_blocks, cfg.n_layers, False), (model.dec_blocks, cfg.decoder_layers, True)):
            for _ in range(n):
                blk = _block(cfg, cross, device)
                _init_dense_norms(blk, generator)
                if quantize:
                    quantize_dense_tree(blk, quantize)
                blocks.append(blk)
        _init_dense_norms(model.enc_ln_f, generator)
        _init_dense_norms(model.dec_ln_f, generator)
    return model.eval().requires_grad_(False)
