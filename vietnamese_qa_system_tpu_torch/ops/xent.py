"""Chunked softmax cross-entropy: the (M, V) logits are never stored.

Counterpart of ``vietnamese_qa_system_tpu/ops/xent.py`` (XLA there, plain
PyTorch here: no kernel).  The vocabulary is streamed in chunks with an
online logsumexp; the backward recomputes each chunk's softmax from the
saved (M,) logsumexp and accumulates dH and dW chunk by chunk, so neither
the logits nor their gradient ever exist at full width.  The last chunk's
slice is clamped to end at V and overlaps its predecessor, with the
already-counted columns masked out, as in the JAX package.  Products are
f32 products of bf16-rounded inputs (the JAX package's bf16 matmuls with
f32 accumulation).  A classifier split by vocabulary over devices (the
tensor-parallel head) streams each part on its own device and combines
the parts' logsumexps on the lead (:class:`SplitXent`).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_reduce_sum

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
    return lse - tl, lse, tl


def _xent_bwd(h, w, targets, lse, g, chunk: int, want_dh: bool, want_dw: bool):
    """dH and dW of the per-token NLL with upstream ``g``, chunk by chunk
    from the saved logsumexp ``lse`` (a target outside [0, V) contributes
    no one-hot term)."""
    v = w.shape[1]
    chunk = min(chunk, v)
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
    return dh, dw


class ChunkedXent(torch.autograd.Function):
    """Per-token NLL (M,) f32 of h (M, D) under the classifier w (D, V);
    the backward recomputes each chunk from the saved logsumexp."""

    @staticmethod
    def forward(ctx, h, w, targets, chunk: int):
        nll, lse, _ = _xent_fwd(h, w, targets, chunk)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.chunk = chunk
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lse = ctx.saved_tensors
        dh, dw = _xent_bwd(h, w, targets, lse, g, ctx.chunk, ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return (None if dh is None else dh.to(h.dtype), None if dw is None else dw.to(w.dtype), None, None)


class SplitXent(torch.autograd.Function):
    """Per-token NLL (M,) f32 of h (M, D) on the lead device under a
    classifier split by vocabulary: ``ws`` are (D, V_j) parts over
    consecutive ranges, each on its device (the tensor-parallel head).
    Each part streams its slice as :class:`ChunkedXent` does and returns
    its rows' logsumexp and target logit; the lead combines them (the
    logsumexp of the parts' logsumexps).  The backward runs each part's
    chunks from the combined logsumexp and sums dH on the lead in f32 in
    part order."""

    @staticmethod
    def forward(ctx, h, targets, chunk: int, *ws):
        lead = h.device
        lses, tl, locs = [], None, []
        lo = 0
        for w in ws:
            t = targets.to(w.device) - lo
            t = torch.where((t >= 0) & (t < w.shape[1]), t, -1)
            _, lse_j, tl_j = _xent_fwd(h.to(w.device), w, t, chunk)
            lses.append(lse_j.to(lead))
            tl = tl_j.to(lead) if tl is None else tl + tl_j.to(lead)
            locs.append(t)
            lo += w.shape[1]
        stack = torch.stack(lses)
        m = stack.amax(dim=0)
        lse = m + torch.log(torch.exp(stack - m).sum(dim=0))
        ctx.save_for_backward(h, lse, *ws, *locs)
        ctx.chunk, ctx.n = chunk, len(ws)
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        h, lse, *rest = ctx.saved_tensors
        ws, locs = rest[:ctx.n], rest[ctx.n:]
        want_dh = ctx.needs_input_grad[0]
        dhs, dws = [], []
        for j, (w, t) in enumerate(zip(ws, locs)):
            dev = w.device
            dh, dw = _xent_bwd(h.to(dev), w, t, lse.to(dev), g.to(dev), ctx.chunk, want_dh,
                               ctx.needs_input_grad[3 + j])
            dhs.append(dh)
            dws.append(None if dw is None else dw.to(w.dtype))
        dh = all_reduce_sum(dhs, h.device).to(h.dtype) if want_dh else None
        return (dh, None, None, *dws)


def chunked_xent(h, w, targets, chunk: int = 4096):
    """Per-token negative log-likelihood (M,) f32, vocabulary streamed in
    chunks.  h (M, D); w (D, V) (``tok_embed.T`` for tied heads); targets
    (M,) in [0, V) -- mask invalid positions in the caller."""
    return ChunkedXent.apply(h, w, targets, chunk)


def masked_mean_xent(h, w, labels, ignore_index: int = -100, chunk: int = 4096):
    """Mean NLL over positions where ``labels != ignore_index``; h (B, T, D)
    aligned with labels (B, T); ``w`` the classifier, or a list of its
    vocabulary parts (one part streams as the whole does, several go
    through :class:`SplitXent`).  Returns (mean_loss, n_valid)."""
    b, t, d = h.shape
    lab = labels.reshape(b * t)
    valid = lab != ignore_index
    targets = torch.where(valid, lab, 0)
    if isinstance(w, (list, tuple)) and len(w) > 1:
        nll = SplitXent.apply(h.reshape(b * t, d), targets, chunk, *w)
    else:
        w = w[0] if isinstance(w, (list, tuple)) else w
        nll = chunked_xent(h.reshape(b * t, d), w, targets, chunk)
    n = valid.sum().clamp_min(1)
    return torch.where(valid, nll, 0.0).sum() / n, n
