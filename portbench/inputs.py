"""Weights and corpora drawn from ``--seed``, on the device, in a few large
calls.  The program and the reference are each handed the same values:
the reference draws them again from the seed, so it takes nothing that
the program made.

Every draw has a generator of its own, keyed on (seed, what, index), so
one layer or one block of rows is drawn again alone.
"""

from __future__ import annotations

import hashlib

import torch


def generator(device, seed: int, *salt) -> torch.Generator:
    key = hashlib.sha256("/".join(map(str, (seed,) + salt)).encode()).digest()
    return torch.Generator(device=torch.device(device)).manual_seed(int.from_bytes(key[:8], "little") >> 1)


def _uniform(n: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.rand(n, generator=g, device=device).mul_(2.0).sub_(1.0)


def _split(flat: torch.Tensor, shapes: dict) -> dict:
    out, at = {}, 0
    for name, shape in shapes.items():
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[at: at + n].view(shape)
        at += n
    return out


def _scaled(parts: dict) -> dict:
    """U(-1, 1) draws -> dense weights U(-1/sqrt(d_in), 1/sqrt(d_in)),
    biases U(-0.02, 0.02), norm scales 1 + U(-0.1, 0.1), norm biases
    U(-0.02, 0.02)."""
    out = {}
    for name, t in parts.items():
        if name.endswith(".w"):
            out[name] = t.mul_(t.shape[0] ** -0.5)
        elif name.endswith(".scale"):
            out[name] = t.mul_(0.1).add_(1.0)
        else:
            out[name] = t.mul_(0.02)
    return out


# ------------------------------------------------------------ the encoder


def encoder_layer_shapes(c: dict, i: int) -> dict:
    d, f = c["hidden_size"], c["intermediate_size"]
    p = f"blocks.{i}."
    shapes = {}
    for n in ("wq", "wk", "wv", "wo"):
        shapes[p + f"attn.{n}.w"] = (d, d)
        shapes[p + f"attn.{n}.b"] = (d,)
    shapes.update({p + "ln1.scale": (d,), p + "ln1.bias": (d,), p + "mlp.wi.w": (d, f), p + "mlp.wi.b": (f,),
                   p + "mlp.wo.w": (f, d), p + "mlp.wo.b": (d,), p + "ln2.scale": (d,), p + "ln2.bias": (d,)})
    return shapes


def encoder_weights(c: dict, seed: int, device) -> dict:
    """The mpnet encoder's f32 weights under the names of its state dict:
    embeddings and the relative-bias table N(0, 0.02^2), the rest as
    :func:`_scaled` says."""
    d = c["hidden_size"]
    g = generator(device, seed, "encoder", "embed")
    w = {"tok_embed": torch.randn(c["vocab_size"], d, generator=g, device=device).mul_(0.02),
         "pos_embed": torch.randn(c["max_position_embeddings"], d, generator=g, device=device).mul_(0.02),
         "rel_bias": torch.randn(c["relative_attention_num_buckets"], c["num_attention_heads"], generator=g,
                                 device=device).mul_(0.02)}
    ln = _split(_uniform(2 * d, g, device), {"emb_ln.scale": (d,), "emb_ln.bias": (d,)})
    w.update(_scaled(ln))
    for i in range(c["num_hidden_layers"]):
        shapes = encoder_layer_shapes(c, i)
        n = sum(torch.Size(s).numel() for s in shapes.values())
        w.update(_scaled(_split(_uniform(n, generator(device, seed, "encoder", i), device), shapes)))
    return w


# --------------------------------------------------------- the MPT reader


def mpt_layer_shapes(c: dict) -> dict:
    d = c["d_model"]
    f = d * c["expansion_ratio"]
    return {"ln1.scale": (d,), "attn.wq.w": (d, d), "attn.wk.w": (d, d), "attn.wv.w": (d, d), "attn.wo.w": (d, d),
            "ln2.scale": (d,), "mlp.wi.w": (d, f), "mlp.wo.w": (f, d)}


def mpt_layer(c: dict, seed: int, i: int, device) -> dict:
    """Layer ``i`` of the MPT reader, f32, (d_in, d_out) dense weights; MPT
    has no biases (``no_bias``), so its norms' biases are zero."""
    shapes = mpt_layer_shapes(c)
    n = sum(torch.Size(s).numel() for s in shapes.values())
    w = _scaled(_split(_uniform(n, generator(device, seed, "mpt", i), device), shapes))
    d = c["d_model"]
    w["ln1.bias"] = torch.zeros(d, device=device)
    w["ln2.bias"] = torch.zeros(d, device=device)
    return w


def mpt_outer(c: dict, seed: int, device) -> dict:
    """The embedding (tied to the head) N(0, 0.02^2) and the final norm."""
    g = generator(device, seed, "mpt", "outer")
    d = c["d_model"]
    w = {"tok_embed": torch.randn(c["vocab_size"], d, generator=g, device=device).mul_(0.02)}
    w["ln_f.scale"] = _uniform(d, g, device).mul_(0.1).add_(1.0)
    w["ln_f.bias"] = torch.zeros(d, device=device)
    return w


# ------------------------------------------------------------- the corpus


def centres(n: int, dim: int, seed: int, device) -> torch.Tensor:
    c = torch.randn(n, dim, generator=generator(device, seed, "centres"), device=device)
    return c / c.norm(dim=1, keepdim=True)


def clustered(cents: torch.Tensor, start: int, n: int, sigma: float, seed: int) -> torch.Tensor:
    """Rows ``start .. start + n`` of the corpus: unit rows around unit
    centres (random membership) with Gaussian noise of total norm
    ``sigma`` (the recipe of the repo's clustered recall tests)."""
    dev, dim = cents.device, cents.shape[1]
    g = generator(dev, seed, "corpus", start)
    pts = cents[torch.randint(0, cents.shape[0], (n,), generator=g, device=dev)]
    pts += (sigma / dim ** 0.5) * torch.randn(n, dim, generator=g, device=dev)
    return pts / pts.norm(dim=1, keepdim=True)


def corpus_blocks(corpus: dict, dim: int, rows: int, seed: int, device, block: int = 1 << 17):
    """Yield (start, rows) blocks of the first ``rows`` corpus rows (a block
    is drawn the same whatever ``rows`` is)."""
    cents = centres(corpus["centres"], dim, seed, device)
    for start in range(0, rows, block):
        yield start, clustered(cents, start, min(block, rows - start), corpus["sigma"], seed)
