"""Flash attention forward in the encoder's form.

Counterpart of ``vietnamese_qa_system_tpu/ops/attention.py:967-1085``.  On a
CUDA tensor the forward runs the hand-written kernel K4 of
``csrc/flash_fwd.cu`` (replaces the Pallas ``_fa_kernel``); on a CPU tensor
its plain PyTorch version :func:`flash_fwd_plain` runs instead.

Ported form: non-causal, per-row key lengths (``kv_lens``), with or
without an (H, Tq, Tk) additive bias -- what the sentence encoder runs at
T >= 256.  The causal, sliding-window and key-only (H, 1, Tk) bias forms
are not ported yet and raise ``NotImplementedError`` on every device.
There is no backward: the port serves, it does not train.
"""

from __future__ import annotations

import torch

from .cuda_kernels import FLASH_FWD, stream_of

NEG_INF = -1e30  # finite, as in the reference: a row with no valid key averages V


def flash_fwd_plain(qb, kb, vb, kv_lens, bias, n_heads: int):
    """Plain version of K4 on (BH, T, D) bf16 slabs -> (o bf16, lse f32).

    Same arithmetic as the kernel without the blocking: f32 scores, the
    bias added before the key mask, probabilities rounded to bf16 for the
    P V product and for the row sum."""
    bh, tq, _ = qb.shape
    tk = kb.shape[1]
    s = torch.bmm(qb.float(), kb.float().transpose(1, 2))
    if bias is not None:
        s = s + bias.float().repeat(bh // n_heads, 1, 1)
    keys = torch.arange(tk, device=qb.device)
    s = torch.where(keys[None, None, :] < kv_lens.reshape(-1)[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(torch.bfloat16).float()
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (torch.bmm(p, vb.float()) / l).to(torch.bfloat16)
    return o, (m + torch.log(l)).squeeze(-1)


def flash_fwd(qb, kb, vb, kv_lens, bias, n_heads: int):
    """K4 on (BH, T, D) bf16 slabs (q pre-scaled), ``kv_lens`` (BH,) int32,
    ``bias`` (H, Tq, Tk) f32 or None -> (o (BH, Tq, D) bf16, lse (BH, Tq) f32)."""
    if not qb.is_cuda:
        if qb.device.type != "cpu":
            raise ValueError(f"unsupported device {qb.device}")
        return flash_fwd_plain(qb, kb, vb, kv_lens, bias, n_heads)
    bh, tq, d = qb.shape
    tk = kb.shape[1]
    for name, t in (("q", qb), ("k", kb), ("v", vb)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != qb.device:
            raise ValueError(f"flash_fwd: {name} must be a contiguous bf16 tensor on {qb.device}")
    if kb.shape != (bh, tk, d) or vb.shape != (bh, tk, d):
        raise ValueError(f"flash_fwd: k {tuple(kb.shape)} / v {tuple(vb.shape)} do not match q {tuple(qb.shape)}")
    if d not in (32, 64, 128):
        raise ValueError(f"flash_fwd kernel supports head dims 32, 64 and 128, got {d}")
    if kv_lens.dtype != torch.int32 or kv_lens.shape != (bh,) or not kv_lens.is_contiguous() or kv_lens.device != qb.device:
        raise ValueError("flash_fwd: kv_lens must be a contiguous (BH,) int32 tensor on the q device")
    if bh % n_heads:
        raise ValueError(f"flash_fwd: BH={bh} is not a multiple of n_heads={n_heads}")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()
                             or bias.shape != (n_heads, tq, tk) or bias.device != qb.device):
        raise ValueError(f"flash_fwd: bias must be a contiguous ({n_heads}, {tq}, {tk}) float32 tensor")
    o = torch.empty((bh, tq, d), dtype=torch.bfloat16, device=qb.device)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=qb.device)
    FLASH_FWD.launch(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), kv_lens.data_ptr(),
        None if bias is None else bias.data_ptr(), bh, n_heads, tq, tk, d,
        o.data_ptr(), lse.data_ptr(), stream_of(qb),
    )
    return o, lse


def flash_attention(q, k, v, *, kv_lens=None, causal: bool = True, scale: float | None = None,
                    bias=None, window: int | None = None):
    """Fused attention over (B, T, H, D) tensors -> (B, Tq, H, D) bf16.

    - ``kv_lens`` (B,) int: valid key length per row (right padding);
      defaults to the full length.
    - ``bias``: optional (H, Tq, Tk) additive score bias shared across the
      batch (MPNet relative positions), added after the scaling.
    - Only ``causal=False`` without ``window`` is ported.
    """
    if causal or window is not None:
        raise NotImplementedError("the causal and sliding-window flash forward are not ported yet")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if bias is not None and bias.shape[1] == 1 and tq != 1:
        raise NotImplementedError("the key-only (H, 1, Tk) bias form is not ported yet")
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d).to(torch.bfloat16).contiguous()

    # the softmax scale is folded into q before the bf16 cast, as the
    # reference does (attention.py:1043): no full-size multiply per block
    qb = to_bh(q * scale if scale != 1.0 else q)
    if kv_lens is None:
        lens = torch.full((b * h,), tk, dtype=torch.int32, device=q.device)
    else:
        lens = torch.as_tensor(kv_lens, device=q.device).to(torch.int32).repeat_interleave(h).contiguous()
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    o, _ = flash_fwd(qb, to_bh(k), to_bh(v), lens, bias, h)
    return o.reshape(b, h, tq, d).permute(0, 2, 1, 3)


def flash_attention_reference(q, k, v, *, kv_lens=None, causal: bool = True, scale=None, window=None):
    """(B, T, H, D) oracle with the reference's masking semantics, all f32."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lens = torch.full((b,), tk, device=q.device) if kv_lens is None else torch.as_tensor(kv_lens, device=q.device)
    k_pos = torch.arange(tk, device=q.device)[None, None, None, :]
    q_pos = torch.arange(tq, device=q.device)[None, None, :, None]
    mask = k_pos < lens.reshape(b, 1, 1, 1)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
