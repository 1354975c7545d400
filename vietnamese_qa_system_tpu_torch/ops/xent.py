"""Chunked softmax cross-entropy: the (M, V) logits are never stored.

Counterpart of ``vietnamese_qa_system_tpu/ops/xent.py`` (XLA there, plain
PyTorch here: no kernel).  The vocabulary is streamed in chunks with an
online logsumexp; the backward recomputes each chunk's softmax from the
saved (M,) logsumexp and accumulates dH and dW chunk by chunk, so neither
the logits nor their gradient ever exist at full width.  The last chunk's
slice is clamped to end at V and overlaps its predecessor, with the
already-counted columns masked out, as in the JAX package.  Products are
f32 products of bf16-rounded inputs (the JAX package's bf16 matmuls with
f32 accumulation).
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _chunk(v: int, chunk: int, ci: int) -> tuple[int, int]:
    """(start, first new column) of chunk ``ci``: the slice is clamped to
    end at V, so the last one may overlap its predecessor."""
    return min(ci * chunk, v - chunk), ci * chunk


def _xent_fwd(h, w, targets, chunk: int):
    m_rows = h.shape[0]
    v = w.shape[1]
    chunk = min(chunk, v)
    hb = _bf16(h)
    m = torch.full((m_rows,), NEG_INF, device=h.device)
    s = torch.zeros(m_rows, device=h.device)
    tl = torch.zeros(m_rows, device=h.device)
    for ci in range(-(-v // chunk)):
        start, first = _chunk(v, chunk, ci)
        lc = hb @ _bf16(w[:, start:start + chunk])
        col = start + torch.arange(chunk, device=h.device)
        lc = torch.where(col[None, :] >= first, lc, NEG_INF)
        m_new = torch.maximum(m, lc.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(lc - m_new[:, None]).sum(dim=1)
        tloc = targets - start
        hit = (tloc >= 0) & (tloc < chunk) & (targets >= first)
        tl_c = torch.gather(lc, 1, tloc.clamp(0, chunk - 1)[:, None])[:, 0]
        tl = torch.where(hit, tl_c, tl)
        m = m_new
    lse = m + torch.log(s)
    return lse - tl, lse


class ChunkedXent(torch.autograd.Function):
    """Per-token NLL (M,) f32 of h (M, D) under the classifier w (D, V);
    the backward recomputes each chunk from the saved logsumexp."""

    @staticmethod
    def forward(ctx, h, w, targets, chunk: int):
        nll, lse = _xent_fwd(h, w, targets, chunk)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.chunk = chunk
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lse = ctx.saved_tensors
        v = w.shape[1]
        chunk = min(ctx.chunk, v)
        want_dh, want_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        hb = _bf16(h)
        gf = g.float()
        dh = torch.zeros(h.shape, device=h.device) if want_dh else None
        dw = torch.zeros(w.shape, device=w.device) if want_dw else None
        for ci in range(-(-v // chunk)):
            start, first = _chunk(v, chunk, ci)
            wc = _bf16(w[:, start:start + chunk])
            lc = hb @ wc
            col = start + torch.arange(chunk, device=h.device)
            valid = col[None, :] >= first  # the clamped overlap contributes nothing
            p = torch.where(valid, torch.exp(lc - lse[:, None]), 0.0)
            onehot = ((col[None, :] == targets[:, None]) & valid).float()
            dlb = _bf16((p - onehot) * gf[:, None])  # d_logits of the chunk, never stored whole
            if want_dh:
                dh += dlb @ wc.T
            if want_dw:
                dw[:, start:start + chunk] += hb.T @ dlb
        return (None if dh is None else dh.to(h.dtype), None if dw is None else dw.to(w.dtype), None, None)


def chunked_xent(h, w, targets, chunk: int = 4096):
    """Per-token negative log-likelihood (M,) f32, vocabulary streamed in
    chunks.  h (M, D); w (D, V) (``tok_embed.T`` for tied heads); targets
    (M,) in [0, V) -- mask invalid positions in the caller."""
    return ChunkedXent.apply(h, w, targets, chunk)


def masked_mean_xent(h, w, labels, ignore_index: int = -100, chunk: int = 4096):
    """Mean NLL over positions where ``labels != ignore_index``; h (B, T, D)
    aligned with labels (B, T).  Returns (mean_loss, n_valid)."""
    b, t, d = h.shape
    lab = labels.reshape(b * t)
    valid = lab != ignore_index
    nll = chunked_xent(h.reshape(b * t, d), w, torch.where(valid, lab, 0), chunk)
    n = valid.sum().clamp_min(1)
    return torch.where(valid, nll, 0.0).sum() / n, n
