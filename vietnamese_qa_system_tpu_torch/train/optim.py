"""Optimizers: AdamW / Lion, with optional 8-bit (blockwise-quantized)
moment states, global-norm clipping, decoupled weight decay and the
learning-rate schedules.

Counterpart of ``vietnamese_qa_system_tpu/train/optim.py``, which builds
optax chains.  The port re-implements the same chain in plain PyTorch:
clip_by_global_norm -> the moment transform -> add_decayed_weights ->
scale_by_learning_rate (optim.py:194-231), each with optax's arithmetic
(Adam's bias correction at the incremented count, Lion's sign update, the
schedule evaluated at the count *before* the step).  A state is a tuple of
the parts' states, each a NamedTuple of optax's fields in optax's order, so
it flattens (utils/tree.py) to the leaves the JAX package checkpoints: a
checkpoint written by either package resumes in the other.

Trees are nested dicts / lists of f32 tensors (an adapter, or a model's
parameter tree); ``update`` returns the updates and the new state, and
:func:`apply_updates` adds the updates in place.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.tree import tree_leaves, tree_map, tree_unflatten

QBLOCK = 256  # elements per quantization block
LOG_RANGE = 30.0  # code magnitudes span absmax * [2^-30, 1]
_LOG_STEP = LOG_RANGE / 127.0


# ----------------------------------------------------------- 8-bit moments


class QTensor:
    """int8 blockwise-quantized tensor: q (nb, QBLOCK) int8, scales (nb, 1)
    f32, the original size and shape.  Flattens to (q, scales), as its JAX
    pytree node does."""

    def __init__(self, q, scales, size: int, shape: tuple):
        self.q, self.scales, self.size, self.shape = q, scales, size, tuple(shape)

    def tree_children(self):
        return [self.q, self.scales]

    def tree_rebuild(self, children):
        return QTensor(children[0], children[1], self.size, self.shape)


def quantize_blockwise(x: torch.Tensor) -> QTensor:
    """Signed log-magnitude int8 code per element with a per-block absmax
    scale: ``code = sign * round(127 * (1 + log2(|x| / absmax) / 30))``;
    exact zero stays code 0."""
    flat = x.reshape(-1).float()
    size = flat.numel()
    nb = -(-size // QBLOCK)
    flat = torch.nn.functional.pad(flat, (0, nb * QBLOCK - size)).reshape(nb, QBLOCK)
    scales = flat.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    mag = flat.abs() / scales
    code = torch.round((torch.log2(mag.clamp_min(2.0 ** -40)) + LOG_RANGE) / _LOG_STEP).clamp(0, 127)
    return QTensor((torch.sign(flat) * code).to(torch.int8), scales, size, tuple(x.shape))


def dequantize_blockwise(t: QTensor) -> torch.Tensor:
    qf = t.q.float()
    mag = torch.exp2(qf.abs() * _LOG_STEP - LOG_RANGE)
    flat = torch.where(t.q == 0, 0.0, torch.sign(qf) * mag) * t.scales
    return flat.reshape(-1)[: t.size].reshape(t.shape)


# ------------------------------------------------------------------ states


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: dict
    nu: dict


class ScaleByLionState(NamedTuple):
    count: torch.Tensor
    mu: dict


class Adam8bitState(NamedTuple):
    count: torch.Tensor
    mu: dict  # tree of QTensor
    nu: dict


class Lion8bitState(NamedTuple):
    mu: dict


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class Transform(NamedTuple):
    init: Callable
    update: Callable  # (updates, state, params) -> (updates, state)


def _count(like) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(like)[0].device)


def _f32(x, count) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=count.device)


def _on(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``x`` on ``t``'s device (a scalar of the state beside a leaf that a
    mesh placed elsewhere)."""
    return x if x.device == t.device else x.to(t.device)


def global_norm(tree) -> torch.Tensor:
    """The l2 norm of every leaf, summed leaf by leaf on the first leaf's
    device."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(_on(torch.sum(torch.square(g.float())), leaves[0]) for g in leaves))


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        return tree_map(lambda t: torch.where(_on(keep, t), t, (t / _on(g_norm, t)) * max_norm), updates), state

    return Transform(lambda params: EmptyState(), update)


def scale_by_adam(b1: float, b2: float, eps: float) -> Transform:
    def init(params):
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return ScaleByAdamState(_count(params), zeros, tree_map(torch.clone, zeros))

    def update(updates, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, updates, state.nu)
        count = state.count + 1
        c1 = 1 - _f32(b1, count) ** count
        c2 = 1 - _f32(b2, count) ** count
        u = tree_map(lambda m, v: (m / _on(c1, m)) / (torch.sqrt(v / _on(c2, v)) + eps), mu, nu)
        return u, ScaleByAdamState(count, mu, nu)

    return Transform(init, update)


def scale_by_lion(b1: float, b2: float) -> Transform:
    def init(params):
        return ScaleByLionState(_count(params), tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(updates, state, params=None):
        u = tree_map(lambda g, m: torch.sign((1.0 - b1) * g + b1 * m), updates, state.mu)
        mu = tree_map(lambda g, m: (1 - b2) * g + b2 * m, updates, state.mu)
        return u, ScaleByLionState(state.count + 1, mu)

    return Transform(init, update)


def _is_q(node) -> bool:
    return isinstance(node, QTensor)


def _leafwise(updates, *qtrees, fn):
    """``fn(g, *qtensors) -> (u, *new qtensors)`` leaf by leaf over the
    gradients and the QTensor moment trees of the same structure; returns
    (updates, *new moment trees)."""
    columns = [tree_leaves(updates)] + [tree_leaves(t, is_leaf=_is_q) for t in qtrees]
    outs = [fn(*xs) for xs in zip(*columns)]
    return tuple(tree_unflatten(updates, [o[i] for o in outs]) for i in range(1 + len(qtrees)))


def _qzeros(params):
    return tree_unflatten(params, [quantize_blockwise(torch.zeros_like(p, dtype=torch.float32))
                                   for p in tree_leaves(params)])


def scale_by_adam8bit(b1: float, b2: float, eps: float) -> Transform:
    def init(params):
        return Adam8bitState(_count(params), _qzeros(params), _qzeros(params))

    def update(updates, state, params=None):
        count = state.count + 1
        b1c = 1 - _f32(b1, count) ** count.float()
        b2c = 1 - _f32(b2, count) ** count.float()

        def upd(g, mu_q, nu_q):
            g = g.float()
            mu = b1 * dequantize_blockwise(mu_q) + (1 - b1) * g
            nu = b2 * dequantize_blockwise(nu_q) + (1 - b2) * torch.square(g)
            u = (mu / _on(b1c, mu)) / (torch.sqrt(nu / _on(b2c, nu)) + eps)
            return u, quantize_blockwise(mu), quantize_blockwise(nu)

        u, mu, nu = _leafwise(updates, state.mu, state.nu, fn=upd)
        return u, Adam8bitState(count, mu, nu)

    return Transform(init, update)


def scale_by_lion8bit(b1: float, b2: float) -> Transform:
    def init(params):
        return Lion8bitState(_qzeros(params))

    def update(updates, state, params=None):
        def upd(g, mu_q):
            g = g.float()
            mu = dequantize_blockwise(mu_q)
            return torch.sign(b1 * mu + (1 - b1) * g), quantize_blockwise(b2 * mu + (1 - b2) * g)

        u, mu = _leafwise(updates, state.mu, fn=upd)
        return u, Lion8bitState(mu)

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params=None):
        return tree_map(lambda u, p: u + weight_decay * p.detach().float(), updates, params), state

    return Transform(lambda params: EmptyState(), update)


def scale_by_learning_rate(lr) -> Transform:
    """``-lr`` times the updates; a schedule is evaluated at the count
    before the step (optax's ``scale_by_schedule``)."""
    if not callable(lr):
        return Transform(lambda params: EmptyState(),
                         lambda updates, state, params=None: (tree_map(lambda u: -lr * u, updates), state))

    def init(params):
        return ScaleByScheduleState(_count(params))

    def update(updates, state, params=None):
        step = -float(lr(int(state.count)))
        return tree_map(lambda u: step * u, updates), ScaleByScheduleState(state.count + 1)

    return Transform(init, update)


def chain(*parts: Transform) -> Transform:
    def init(params):
        return tuple(p.init(params) for p in parts)

    def update(updates, state, params=None):
        new = []
        for part, s in zip(parts, state):
            updates, s = part.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return Transform(init, update)


def apply_updates(params, updates) -> None:
    """``p += u`` for every leaf, in place (optax's ``apply_updates``: the
    sum in f32, stored in p's dtype)."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.copy_((p.float() + u).to(p.dtype))


# --------------------------------------------------------------- factories


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def make_schedule(name: str, lr: float, total_steps: int, warmup_steps: int = 0):
    """linear | cosine | constant with linear warmup (optax's
    linear_schedule, cosine_decay_schedule and join_schedules); a float
    for constant without warmup."""
    if name == "constant":
        return _linear(0.0, lr, warmup_steps) if warmup_steps else lr
    decay_steps = max(total_steps - warmup_steps, 1)
    if name == "linear":
        sched = _linear(lr, 0.0, decay_steps)
    elif name == "cosine":
        def sched(count):
            return lr * 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
    else:
        raise ValueError(f"unknown schedule {name!r}")
    if warmup_steps:
        warm = _linear(0.0, lr, warmup_steps)
        return lambda count: warm(count) if count < warmup_steps else sched(count - warmup_steps)
    return sched


def make_optimizer(name: str = "adamw", lr=3e-4, *, weight_decay: float = 0.0, max_grad_norm: Optional[float] = 1.0,
                   b1: float = 0.9, b2: Optional[float] = None, eps: float = 1e-8) -> Transform:
    """adamw | lion | adamw8bit | lion8bit, with global-norm clipping,
    decoupled weight decay and the learning rate, in optax's chain order.
    ``b2=None`` picks the family default (adam 0.999, lion 0.99)."""
    if b2 is None:
        b2 = 0.99 if name.startswith("lion") else 0.999
    cores = {
        "adamw": lambda: scale_by_adam(b1, b2, eps),
        "adamw8bit": lambda: scale_by_adam8bit(b1, b2, eps),
        "lion": lambda: scale_by_lion(b1, b2),
        "lion8bit": lambda: scale_by_lion8bit(b1, b2),
    }
    if name not in cores:
        raise ValueError(f"unknown optimizer {name!r}")
    parts = []
    if max_grad_norm is not None:
        parts.append(clip_by_global_norm(max_grad_norm))
    parts.append(cores[name]())
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(scale_by_learning_rate(lr))
    return chain(*parts)
