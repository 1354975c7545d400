"""IVF probe-score scan: kernel K5.

Counterpart of ``vietnamese_qa_system_tpu/ops/ivf_probe.py``.  For each
query ``b`` and probe ``p`` the bucket ``probe_ids[b, p]`` of the IVF slab is
scored against the query: the query rounded to bf16, the int8 or bf16 codes
widened to bf16 (exact), the products summed in f32 over D, the per-row
scales applied after the sum when given, pad rows (``gid < 0``) at ``-inf``,
and the bucket's gids copied aligned with the scores.

On a CUDA tensor :func:`ivf_probe_scores` runs the hand-written kernel of
``csrc/ivf_probe.cu`` (replaces the Pallas ``_probe_score_kernel``); on a CPU
tensor its plain version :func:`ivf_probe_scores_plain` (a gather of the
probed buckets, then an f32 product) runs instead.  The TPU's padding of P
to 8 and its scalar prefetch of the probe ids are layout and are not
carried over.
"""

from __future__ import annotations

import torch

from .cuda_kernels import IVF_PROBE, on_card, stream_of

ROWS_PER_BLOCK = 32  # csrc/ivf_probe.cu ROWS: cap must be a multiple
MAX_DIM = 12256      # the query row and 32 row sums fit 48 KB of shared memory


def ivf_probe_scores_plain(q, probe_ids, buckets, bucket_scales, bucket_gids):
    """Plain version: ``buckets[probe_ids]`` gathered, then an f32 product of
    the bf16-rounded query with the (exactly widened) codes."""
    ids = probe_ids.long()
    bq = q.to(torch.bfloat16).float()
    sc = torch.einsum("bd,bpcd->bpc", bq, buckets[ids].float())
    if bucket_scales is not None:
        sc = sc * bucket_scales[ids]
    g = bucket_gids[ids]
    return torch.where(g >= 0, sc, float("-inf")), g


def ivf_probe_scores(q, probe_ids, buckets, bucket_scales, bucket_gids):
    """Score every probed bucket row against its query.

    q (B, D) f32, a global int8 scale already folded in; probe_ids (B, P)
    int32 in [0, C); buckets (C, cap, D) int8 or bf16; bucket_scales
    (C, cap) f32 or None; bucket_gids (C, cap) int32, -1 on pad rows.
    Returns (scores (B, P, cap) f32 with pads at -inf, gids (B, P, cap)
    int32)."""
    b, d = q.shape
    c, cap, d2 = buckets.shape
    if d2 != d or probe_ids.shape[0] != b or bucket_gids.shape != (c, cap):
        raise ValueError(f"ivf_probe_scores: q {tuple(q.shape)}, probe_ids {tuple(probe_ids.shape)}, buckets "
                         f"{tuple(buckets.shape)}, gids {tuple(bucket_gids.shape)} do not match")
    if not on_card(q):
        return ivf_probe_scores_plain(q, probe_ids, buckets, bucket_scales, bucket_gids)
    if buckets.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"ivf_probe_scores needs int8 or bf16 buckets, got {buckets.dtype}")
    if cap % ROWS_PER_BLOCK or d % 16 or d > MAX_DIM:
        raise ValueError(f"ivf_probe_scores kernel needs cap % {ROWS_PER_BLOCK} == 0 and D % 16 == 0, D <= {MAX_DIM} "
                         f"(got cap={cap}, D={d})")
    operands = [buckets, bucket_gids] + ([] if bucket_scales is None else [bucket_scales])
    if any(t.device != q.device or not t.is_contiguous() for t in operands) or buckets.data_ptr() % 16:
        raise ValueError("ivf_probe_scores needs contiguous buckets, scales and gids on the query's device, "
                         "the buckets 16-byte aligned")
    if bucket_gids.dtype != torch.int32 or (bucket_scales is not None and (
            bucket_scales.dtype != torch.float32 or bucket_scales.shape != (c, cap))):
        raise ValueError("ivf_probe_scores needs int32 gids and (C, cap) float32 scales")
    p = probe_ids.shape[1]
    qf = q.float().contiguous()
    ids = probe_ids.to(device=q.device, dtype=torch.int32).contiguous()
    out_s = torch.empty((b, p, cap), dtype=torch.float32, device=q.device)
    out_g = torch.empty((b, p, cap), dtype=torch.int32, device=q.device)
    IVF_PROBE.launch(
        qf.data_ptr(), ids.data_ptr(), buckets.data_ptr(),
        None if bucket_scales is None else bucket_scales.data_ptr(), bucket_gids.data_ptr(),
        int(buckets.dtype == torch.int8), b, p, c, cap, d, out_s.data_ptr(), out_g.data_ptr(), stream_of(q),
        device=q.device,
    )
    return out_s, out_g
