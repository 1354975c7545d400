"""Bidirectional sentence encoder: token + position embed -> blocks ->
masked mean-pool -> L2 norm.

Counterpart of ``vietnamese_qa_system_tpu/models/encoder.py``, with the
same dispatch rule: the fused flash forward (kernel K4) runs iff
``cfg.use_flash_attention and T >= 256``; shorter inputs take the dense
masked-softmax path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from .config import ModelConfig
from .layers import Block, Dense, LayerNorm, padding_mask


class SentenceEncoder(nn.Module):
    """Parameters named as the JAX encoder pytree (``tok_embed``,
    ``blocks.0.attn.wq.w``, ...)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_size, d, device=device))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq_len, d, device=device))
        self.blocks = nn.ModuleList(
            Block(d, cfg.n_heads, cfg.d_ff, cfg.norm_eps, device=device) for _ in range(cfg.n_layers)
        )
        self.type_embed = nn.Parameter(torch.empty(2, d, device=device)) if cfg.bert_embeddings else None
        has_emb_ln = cfg.bert_embeddings or cfg.embed_layernorm
        self.emb_ln = LayerNorm(d, cfg.norm_eps, device=device) if has_emb_ln else None
        self.rel_bias = (
            nn.Parameter(torch.empty(cfg.relative_attention_buckets, cfg.n_heads, device=device))
            if cfg.relative_attention_buckets else None
        )
        self.ln_f = LayerNorm(d, cfg.norm_eps, device=device) if cfg.norm_position == "pre" else None

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def encode(self, ids: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """ids / attn_mask (B, T) int -> (B, T, D) f32 hidden states."""
        cfg = self.cfg
        t = ids.shape[1]
        if cfg.position_offset:
            # RoBERTa/MPNet indexing: the i-th real token sits at position
            # i + offset, padding at offset - 1
            pos_ids = torch.cumsum(attn_mask, dim=1) * attn_mask + cfg.position_offset - 1
            pos = self.pos_embed[pos_ids]
        else:
            pos = self.pos_embed[:t][None]
        adt = torch.bfloat16 if cfg.activations_bf16 else None
        x = self.tok_embed[ids] + pos
        if self.type_embed is not None:
            x = x + self.type_embed[0][None, None, :]
        if self.emb_ln is not None:
            x = self.emb_ln(x, out_dtype=adt)
        elif adt is not None:
            x = x.to(adt)
        bias = None
        if self.rel_bias is not None:
            bias = relative_attention_bias(self.rel_bias, t, cfg)
        mask = padding_mask(attn_mask).expand(ids.shape[0], t, t)
        flash = None
        if cfg.use_flash_attention and t >= 256:
            flash = {"kv_lens": attn_mask.sum(dim=1).to(torch.int32), "causal": False}
        for blk in self.blocks:
            x = blk(x, mask=mask, flash=flash, norm_position=cfg.norm_position, bias=bias,
                    activation=cfg.activation, activation_dtype=adt)
        if self.ln_f is not None:
            return self.ln_f(x)
        return x.float()

    def sentence_embed(self, ids: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """Masked mean-pool + L2 normalize -> (B, D) unit embeddings."""
        h = self.encode(ids, attn_mask)
        m = attn_mask[:, :, None].float()
        pooled = (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / norm.clamp_min(1e-12)

    forward = sentence_embed


def init_encoder(cfg: ModelConfig, generator: torch.Generator, *, device="cuda") -> SentenceEncoder:
    """Random weights drawn from ``generator`` (a CPU generator, so a seed
    gives the same weights on every device): embeddings and the relative
    bias table N(0, 0.02^2), dense weights U(-1/sqrt(d_in), 1/sqrt(d_in)),
    zero biases, unit norm scales -- the JAX ``init_encoder`` distributions."""
    model = SentenceEncoder(cfg, device="cpu")
    with torch.no_grad():
        for p in (model.tok_embed, model.pos_embed, model.type_embed, model.rel_bias):
            if p is not None:
                p.normal_(0.0, 0.02, generator=generator)
        for mod in model.modules():
            if isinstance(mod, Dense):
                s = 1.0 / mod.w.shape[0] ** 0.5
                mod.w.uniform_(-s, s, generator=generator)
                if mod.b is not None:
                    mod.b.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def relative_position_bucket(rel: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5/MPNet bidirectional log buckets (int64) of ``rel`` = key - query
    positions, in the JAX package's f32 arithmetic (encoder.py:62-80)."""
    n = -rel
    half = num_buckets // 2
    ret = (n < 0).astype(np.int64) * half
    n = np.abs(n)
    max_exact = half // 2
    f32 = np.float32
    scaled = np.log(n.astype(f32) / f32(max_exact) + f32(1e-9)) / np.log(f32(max_distance / max_exact))
    val_large = max_exact + (scaled * f32(half - max_exact)).astype(np.int32)
    val_large = np.minimum(val_large, half - 1)
    return ret + np.where(n < max_exact, n, val_large)


@functools.lru_cache(maxsize=8)
def _relative_position_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """(T, T) :func:`relative_position_bucket` of key - query, computed on
    the host once per T."""
    pos = np.arange(t)
    return relative_position_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)


@functools.lru_cache(maxsize=8)
def _relative_position_bucket_rows(t: int, num_buckets: int, max_distance: int, device: str) -> torch.Tensor:
    """:func:`_relative_position_buckets` on ``device``, copied once a width
    and device (a copy at every forward would wait for it); never written
    to."""
    return torch.from_numpy(_relative_position_buckets(t, num_buckets, max_distance)).to(device)


def relative_attention_bias(table: torch.Tensor, t: int, cfg: ModelConfig) -> torch.Tensor:
    """(buckets, H) table -> (1, H, T, T) additive attention bias."""
    idx = _relative_position_bucket_rows(t, cfg.relative_attention_buckets, cfg.relative_attention_max_distance,
                                         str(table.device))
    return table[idx].permute(2, 0, 1)[None]
