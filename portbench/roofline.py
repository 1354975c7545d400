"""Operations and bytes of the kernels and models on the timed paths, and
the peaks they are held to.

A kernel call's least time is the larger of its operations over the peak
rate of their type and its bytes over the HBM rate, each input byte read
once and each output byte written once, counted from the call's shapes and
valid lengths.  Peaks: NVIDIA's H100 SXM data sheet (dense, 700 W); the
run prints the card's power limit beside its result.
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
PEAK_HBM = 3.35e12  # bytes/s


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(flops / peak, nbytes / PEAK_HBM)


def share(bound_seconds: float, measured_seconds: float):
    """A roofline or peak share in %, None where nothing was measured."""
    if measured_seconds <= 0 or bound_seconds <= 0:
        return None
    return 100.0 * bound_seconds / measured_seconds


# ---------------------------------------------------------------- kernels


def topk_call(b: int, d: int, n: int, k: int) -> tuple[float, float]:
    """K1: bf16 queries (B, D) against a bf16 corpus of N valid rows, top-k
    scores (f32) and ids (int32) out."""
    return 2.0 * b * n * d, 2.0 * n * d + 2.0 * b * d + 8.0 * b * k


def flash_fwd_call(lens, heads: int, hd: int, tq: int, tk: int, bias_rows: int = 0) -> tuple[float, float]:
    """K4, bidirectional, one call over rows of valid lengths ``lens``:
    each valid query against each valid key (QK and PV), q, k, v of the
    valid tokens in and o out in bf16, the f32 lse out, and the f32 bias
    (H, bias_rows, Tk) in."""
    sq = sum(int(x) * int(x) for x in lens)
    tok = sum(int(x) for x in lens)
    flops = 4.0 * hd * heads * sq
    nbytes = 4 * 2.0 * tok * heads * hd + 4.0 * tok * heads + 4.0 * heads * bias_rows * tk
    return flops, nbytes


def w8_call(m: int, k: int, n: int) -> tuple[float, float]:
    """K6: bf16 x (M, K) times int8 codes (K, N) with f32 column scales,
    f32 y (M, N) out."""
    return 2.0 * m * k * n, 1.0 * k * n + 4.0 * n + 2.0 * m * k + 4.0 * m * n


# ----------------------------------------------------------------- models


def encoder_flops(c: dict, lens) -> float:
    """A bidirectional encoder over sequences of valid lengths ``lens``:
    the dense products of every valid token and attention between valid
    tokens (embeddings and norms left out)."""
    d, f, layers = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    tok = sum(int(x) for x in lens)
    sq = sum(int(x) * int(x) for x in lens)
    return layers * (2.0 * tok * (4 * d * d + 2 * d * f) + 4.0 * sq * d)


def scan_flops(b: int, n: int, d: int) -> float:
    """The scores of a top-k scan."""
    return 2.0 * b * n * d


def decoder_flops(c: dict, n_tokens: int, context_sum: int) -> float:
    """A causal decoder over ``n_tokens`` new tokens whose attended
    contexts sum to ``context_sum`` keys: the dense products, the tied
    head and attention."""
    d, layers, v = c["d_model"], c["n_layers"], c["vocab_size"]
    f = d * c["expansion_ratio"]
    return 2.0 * n_tokens * (layers * (4 * d * d + 2 * d * f) + d * v) + 4.0 * layers * d * context_sum
