"""Parity of the port's flash attention in the training forms -- the
causal, sliding-window and key-only-bias forward of K4 and the backward K7,
through their plain CPU versions -- with the JAX package's flash_attention
(Pallas in interpret mode on the CPU, forward and ``jax.grad``).

Each case draws q, k, v and the output cotangent with numpy, runs the
forward and the gradients of sum(o * g) with respect to q, k and v in both
packages.  Tolerances: o max abs 2e-2 (bf16 outputs, a few ulps at
|o| < 2); dq, dk, dv max abs 2e-2 against gradients up to ~5 (the kernels
round P and dS to bf16 and emit bf16 gradients; the two packages tile the
online softmax differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.ops import attention as ja
from vietnamese_qa_system_tpu_torch.ops import attention as ta

torch.set_num_threads(2)

TOL = 2e-2

# name: (B, T, H, D, flash_attention keyword arguments); T = 200 is not a
# multiple of either package's tile
CASES = {
    "causal": (2, 200, 2, 32, dict(causal=True)),
    "causal_key_only_bias": (2, 200, 2, 32, dict(causal=True, bias="key")),
    "causal_window": (2, 200, 2, 32, dict(causal=True, window=48)),
    "bidirectional_full_bias": (2, 200, 2, 32, dict(causal=False, bias="full")),
    "causal_kv_lens": (2, 200, 2, 32, dict(causal=True, kv_lens=np.array([200, 70], np.int32))),
    "causal_bias_d64": (2, 128, 2, 64, dict(causal=True, bias="key")),
    # D = 128 (PhoGPT-4B's head dim), where the reference's row sum keeps the
    # f32 probabilities while P V takes the bf16 ones
    "causal_key_only_bias_d128": (1, 200, 2, 128, dict(causal=True, bias="key")),
    "causal_key_only_bias_d128_t256": (1, 256, 2, 128, dict(causal=True, bias="key")),
    "bidirectional_full_bias_kv_lens_d128": (2, 200, 2, 128, dict(causal=False, bias="full",
                                                                  kv_lens=np.array([200, 90], np.int32))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case):
    b, t, h, d, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, k, v, g = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    kw = dict(kw)
    if kw.get("bias") == "key":  # ALiBi-like: slope_h * key position
        kw["bias"] = (np.arange(t, dtype=np.float32)[None, None, :] * rng.uniform(0.01, 0.2, (h, 1, 1))).astype(
            np.float32)
    elif kw.get("bias") == "full":
        kw["bias"] = rng.standard_normal((h, t, t)).astype(np.float32)
    jkw = {name: jnp.asarray(val) if isinstance(val, np.ndarray) else val for name, val in kw.items()}
    tkw = {name: torch.from_numpy(val) if isinstance(val, np.ndarray) else val for name, val in kw.items()}

    def jax_loss(q_, k_, v_):
        return jnp.sum(ja.flash_attention(q_, k_, v_, **jkw).astype(jnp.float32) * g)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    want_o = np.asarray(ja.flash_attention(*args, **jkw), np.float32)
    want_g = jax.grad(jax_loss, argnums=(0, 1, 2))(*args)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = ta.flash_attention(tq, tk, tv, **tkw)
    assert o.dtype == torch.bfloat16 and o.shape == (b, t, h, d)
    (o.float() * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(o.detach().float().numpy(), want_o, atol=TOL, rtol=0)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), want_g):
        assert np.isfinite(got.numpy()).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0, err_msg=f"d{name}")


def test_bias_cotangent_is_zero_and_lse_masked():
    """The bias gets a zero gradient (as in the JAX package); the plain
    forward's lse is the logsumexp of the kept scores of each row, to 1e-2
    (at D = 32 the row sum adds bf16-rounded probabilities, as the TPU
    kernel does)."""
    bh, t, d, h = 4, 96, 32, 2
    rng = np.random.default_rng(7)
    qb, kb, vb = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(np.float32)).bfloat16() for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((h, 1, t)).astype(np.float32)).requires_grad_(True)
    lens = torch.full((bh,), t, dtype=torch.int32)
    o, lse = ta.FlashAttention.apply(qb.requires_grad_(True), kb, vb, lens, bias, h, True, 16)
    o.float().sum().backward()
    assert torch.equal(bias.grad, torch.zeros_like(bias))
    s = qb.float() @ kb.float().transpose(1, 2) + bias.detach().repeat(bh // h, 1, 1)
    pos = torch.arange(t)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - 16)
    want = torch.logsumexp(torch.where(keep, s, -torch.inf), dim=-1)
    torch.testing.assert_close(lse.detach(), want, atol=1e-2, rtol=0)


def test_flash_bwd_plain_matches_autograd_of_the_reference():
    """K7's plain version against autograd through the all-f32 reference
    (the exact function): the bf16 roundings stay within the tolerance."""
    b, t, h, d = 1, 130, 2, 64
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32)) for _ in range(4))
    qs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (ta.flash_attention_reference(*qs, causal=True, window=50) * g).sum().backward()
    ps = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (ta.flash_attention(*ps, causal=True, window=50).float() * g).sum().backward()
    for want, got in zip(qs, ps):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), atol=5e-2, rtol=0)
