"""The train step, over a device mesh: the dp / zero2 / fsdp / tp / fsdp_tp
strategies of the JAX trainer (trainer.py:330-420) on one controller.  A
trainer on one device is the mesh of one position: one row, one unit a
trainable leaf on that device (the JAX trainer's step, trainer.py:167-254).

The JAX trainer is one SPMD program: every state leaf carries a
``NamedSharding`` from ``param_sharding`` and XLA inserts the collectives.
Here one process drives the mesh (``core/mesh.py``): each data index ``i``
holds a *row* -- a replica of the model on ``grid[i][0]``, or its
tensor-parallel form over ``grid[i]`` (``TPCausalLM`` or a family's
``TPEncoderDecoder``, made by ``parallel.sharding.shard_params``; their
``leaf_index`` names the whole leaf each tensor holds) -- and the step
runs the rows one after another, merging through the collectives of
``parallel/collectives.py``.

Every leaf of the state is a *whole* leaf of the JAX tree (the unsharded
model's ``state_dict`` names, the adapter, the optimizer state), stored as
*pieces*: tensors on mesh positions, each holding one index region of the
whole leaf.

- A leaf the strategy leaves replicated has one piece a row (the row's own
  tensor; on a repeated-device mesh the rows' frozen tensors are one).
- A leaf split along ``model`` has the tensor-parallel form's parts as
  pieces (int8, nf4 and nf4-dq codes and scales too, ``layers.
  split_dense``).
- A leaf split along ``data`` (fsdp, fsdp_tp) is stored as one part a data
  index: between steps every row's module holds only its own part, and a
  sublayer's whole weight exists only while that sublayer runs.  A forward
  wrapper of each sublayer of a layer (its norms, attention,
  cross-attention and MLP: a family may call them without the layer's own
  forward) gathers its parts (``all_gather``, which hands each part its
  slice of the gradient in the backward) and gives the row its part back
  after it; it runs under a checkpoint (the model's per-layer remat, or
  one of its own), so its backward re-runs the wrapper and regathers.
  The leaves outside the layers (embeddings, final norm, head) are
  gathered for the row's whole loss.

The optimizer runs over *units*: each trainable leaf split into the index
regions where its optimizer state lives (one unit on the lead for dp; one
a data index along the fsdp spec's dim for zero2 / fsdp, JAX
``param_sharding(opt_state, mesh, "fsdp")``; the tensor-parallel parts for
tp, further split over data for fsdp_tp; whole units for the 8-bit
optimizers, whose moments are quantized in blocks of the whole flattened
leaf).  A unit's gradient is the f32 sum, in row order, of every row's
gradient over its region (``reduce_scatter_sum``; an ``all_reduce_sum`` to
the lead for dp); the optimizer chain runs once over all units (the clip
norm is the norm of every unit); each unit's new value is computed once
and copied into every piece that holds its region.  So no replica is ever
updated more than once, whether or not its tensor aliases another's.

LoRA: the adapter is replicated under every strategy (JAX
trainer.py:367-371): the lead holds the whole leaves, and each row takes a
copy every microbatch.  On a column-split part ``x @ A`` is computed whole
and B's columns for the part apply; on a row-split part A's rows for the
part apply and the row-parallel sum adds the partial products.  A float
base merges ``W + scale * A @ B`` where the weight is whole: at once, or
in the layer's gather under fsdp (``lora.attach_factors`` either way).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import tracing
from ..core.mesh import DATA_AXIS, Mesh
from ..models.causal_lm import clone_module
from ..models.layers import Dense
from ..models.lora import attach_factors, clear_lora
from ..models.quantize import dequantize_tree
from ..parallel.collectives import all_gather, all_reduce_sum, broadcast, reduce_scatter_sum
from ..parallel.sharding import param_sharding, shard_params
from ..utils.tree import flatten_paths, nest, tree_leaves, tree_unflatten
from .optim import QTensor, global_norm

LAYER_LISTS = ("blocks", "enc_blocks", "dec_blocks")


def _whole_index(shape) -> tuple:
    return tuple(slice(0, int(d)) for d in shape)


def _overlap(a: tuple, b: tuple) -> Optional[tuple]:
    """The intersection of two index regions, or None."""
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _rel(region: tuple, within: tuple) -> tuple:
    """``region`` as an index into a tensor holding ``within``."""
    return tuple(slice(r.start - w.start, r.stop - w.start) for r, w in zip(region, within))


def _split(index: tuple, dim: int, n: int) -> list[tuple]:
    """``index`` cut into ``n`` equal regions along ``dim``."""
    step = (index[dim].stop - index[dim].start) // n
    return [index[:dim] + (slice(index[dim].start + k * step, index[dim].start + (k + 1) * step),) + index[dim + 1:]
            for k in range(n)]


def _nbytes(t) -> int:
    if isinstance(t, QTensor):
        return _nbytes(t.q) + _nbytes(t.scales)
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Piece:
    """A tensor holding ``index`` of a whole leaf; ``holders`` are the mesh
    positions (data, model) that logically keep it."""

    tensor: torch.Tensor
    index: tuple
    holders: list


@dataclasses.dataclass
class Unit:
    """An index region of a trainable leaf where its optimizer state lives
    (on ``device``; logically kept by ``holders``)."""

    leaf: str
    index: tuple
    device: torch.device
    holders: list


class _Slot:
    """A module attribute that holds an fsdp-split leaf: its own part
    between steps, the gathered whole while its layer runs."""

    def __init__(self, module, attr: str, kind: str, parts: list, dim: int, own: int, device):
        self.module, self.attr, self.kind = module, attr, kind
        self.parts, self.dim, self.own, self.device = parts, dim, own, device

    def set(self, t) -> None:
        getattr(self.module, self.kind)[self.attr] = t

    def gather(self) -> None:
        self.set(all_gather(self.parts, self.device, dim=self.dim))

    def release(self) -> None:
        self.set(self.parts[self.own])


def _per_layer_remat(model) -> bool:
    """Whether the model wraps each layer in a checkpoint already
    (causal_lm.py / t5.py: ``scan_layers`` with a remat policy); every
    other family (mBART, the native stack; T5 without a scan) gets a
    checkpoint of its own around each gathering sublayer."""
    cfg = model.cfg
    return bool(cfg.scan_layers and cfg.remat_policy != "none" and
                (cfg.arch == "causal" or cfg.seq2seq_family == "t5"))


class MeshTrainState:
    """The trainer's model, adapter and optimizer state placed over a mesh
    by ``strategy`` (see the module docstring)."""

    def __init__(self, model, mesh: Mesh, strategy: str, tx, *, adapter=None, lora=None,
                 once: Optional[bool] = None):
        """``model``: the unsharded model (left as it is: the rows are
        copies, sharing its frozen tensors where they live on its device);
        ``adapter``: the whole LoRA adapter to train (None trains every
        parameter); ``once``: None for the fused dequantization, else
        whether the "once" placement folds the factors."""
        self.mesh, self.lora, self.once = mesh, lora, once
        probe = tx.init([torch.zeros(1)])
        eight_bit = any(isinstance(x, QTensor) for x in tree_leaves(probe, is_leaf=lambda x: isinstance(x, QTensor)))
        self.grid = grid = mesh.grid()
        self.n_data, self.n_model = len(grid), len(grid[0])
        self.lead = grid[0][0]
        tp = strategy in ("tp", "fsdp_tp") and self.n_model > 1
        self.fsdp = strategy in ("fsdp", "fsdp_tp") and self.n_data > 1
        all_model = list(range(self.n_model))
        # the rows: replicas, or tensor-parallel forms along each data row
        if tp:
            self.rows = [shard_params(model, mesh, strategy, training=True, row=i) for i in range(self.n_data)]
            for i in range(1, self.n_data):
                self._alias_row(self.rows[i], self.rows[0])
            maps = [r.leaf_index() for r in self.rows]
        else:
            self.rows = [clone_module(model, grid[i][0]) for i in range(self.n_data)]
            maps = [{name: (name, _whole_index(t.shape), 0) for name, t in r.state_dict(keep_vars=True).items()}
                    for r in self.rows]
        whole = model.state_dict(keep_vars=True)
        self.param_shapes = {n: (tuple(t.shape), t.dtype) for n, t in whole.items()}
        self.param_names = _jax_order(whole)
        specs = param_sharding(model, mesh, strategy) if self.fsdp else {}
        self.dense_map = [self._dense_map(r, m) for r, m in zip(self.rows, maps)]
        # pieces of every parameter leaf; fsdp parts replace the rows' own tensors
        self.pieces: dict[str, list[Piece]] = {n: [] for n in self.param_names}
        self.slots: list[list[tuple[str, _Slot]]] = [[] for _ in range(self.n_data)]
        mods = [dict(r.named_modules()) for r in self.rows]
        tensors = [r.state_dict(keep_vars=True) for r in self.rows]
        copies = {}  # the tensors of a row that hold some of each leaf
        for wname, _, _ in maps[0].values():
            copies[wname] = copies.get(wname, 0) + 1
        for name, (wname, index, j) in maps[0].items():
            t0 = tensors[0][name]
            # a leaf held whole by one tensor stands for every model position;
            # a part (or a part's own copy of a whole leaf: a kv head, nf4-dq's
            # s_s) for its own
            whole_leaf = index == _whole_index(self.param_shapes[wname][0]) and copies[wname] == 1
            holders_j = all_model if whole_leaf else [j]
            spec = specs.get(wname)
            dim = spec.index(DATA_AXIS) if spec is not None and DATA_AXIS in spec else None
            if dim is not None and t0.shape[dim] % self.n_data == 0:
                regions = _split(index, dim, self.n_data)
                step = t0.shape[dim] // self.n_data
                parts = []
                for k in range(self.n_data):
                    src = t0.narrow(dim, k * step, step)
                    part = torch.empty(src.shape, dtype=src.dtype, device=grid[k][j]).copy_(src.detach())
                    if isinstance(t0, nn.Parameter):
                        part = nn.Parameter(part, requires_grad=False)
                    parts.append(part)
                    self.pieces[wname].append(Piece(part, regions[k], [(k, jj) for jj in holders_j]))
                for i in range(self.n_data):
                    mod_name, attr = name.rsplit(".", 1) if "." in name else ("", name)
                    mod = mods[i][mod_name]
                    kind = "_parameters" if attr in mod._parameters else "_buffers"
                    slot = _Slot(mod, attr, kind, parts, dim, i, grid[i][j])
                    slot.release()
                    self.slots[i].append((mod_name, slot))
            else:
                for i in range(self.n_data):
                    self.pieces[wname].append(Piece(tensors[i][name], index, [(i, jj) for jj in holders_j]))
        self.root_slots: dict = {}
        self.rooted: dict = {}  # row -> what eval_rows gathered outside its layers
        if self.fsdp:
            for i, row in enumerate(self.rows):
                self._wrap_layers(row, self.slots[i])
        self.adapter = adapter
        self.pending: dict = {}  # Dense -> (a, b): a float merge done at the Dense's gather
        # the trainable leaves, their pieces and the optimizer's units
        if adapter is not None:
            self.adapter_flat = flatten_paths(adapter)
            self.train_names = _jax_order(self.adapter_flat)
            self.train_pieces = {n: [Piece(t, _whole_index(t.shape), self._everyone())]
                                 for n, t in self.adapter_flat.items()}
            shapes = {n: tuple(t.shape) for n, t in self.adapter_flat.items()}
        else:
            self.train_names = [n for n in self.param_names if whole[n].is_floating_point()]
            self.train_pieces = {n: self.pieces[n] for n in self.train_names}
            shapes = {n: self.param_shapes[n][0] for n in self.train_names}
            for n in self.train_names:
                for p in self.pieces[n]:
                    p.tensor.requires_grad_(True)
        # where the optimizer state of a replicated leaf lives: JAX
        # trainer.py:384-389's param_sharding(opt_state, mesh, "fsdp" for
        # zero2 / fsdp / fsdp_tp, else "dp")
        opt_specs = param_sharding({n: torch.empty(shape, device="meta") for n, shape in shapes.items()}, mesh,
                                   "fsdp" if strategy in ("zero2", "fsdp", "fsdp_tp") else "dp")
        everyone = self._everyone()
        self.units: list[Unit] = []
        for n in self.train_names:
            whole_ix = _whole_index(shapes[n])
            if adapter is None and (tp or self.fsdp) and not eight_bit:
                # the optimizer state follows the split parameters: a unit a
                # distinct part (a kv head copied on several devices is one)
                regions: dict = {}
                for p in self.pieces[n]:
                    key = tuple((sl.start, sl.stop) for sl in p.index)
                    if key in regions:
                        regions[key][2].extend(h for h in p.holders if h not in regions[key][2])
                    elif all(_overlap(p.index, r[0]) is None for r in regions.values()):
                        regions[key] = (p.index, p.tensor.device, list(p.holders))
                self.units += [Unit(n, ix, dev, holders) for ix, dev, holders in regions.values()]
                continue
            spec = opt_specs[n]
            dim = spec.index(DATA_AXIS) if DATA_AXIS in spec and not eight_bit else None
            if dim is None:
                self.units.append(Unit(n, whole_ix, self.lead, everyone))
            else:
                self.units += [Unit(n, region, grid[k][0], [(k, j) for j in all_model])
                               for k, region in enumerate(_split(whole_ix, dim, self.n_data))]
        self.units_of = {n: [u for u in self.units if u.leaf == n] for n in self.train_names}
        self.tx = tx
        self.opt_state = tx.init(self.unit_values())

    # ------------------------------------------------------------ placement

    def _everyone(self) -> list:
        return [(i, j) for i in range(self.n_data) for j in range(self.n_model)]

    @staticmethod
    def _alias_row(row, first) -> None:
        """Point a row's tensors at the first row's where they live on one
        device (a repeated-device mesh keeps one copy of a frozen weight)."""
        src = first.state_dict(keep_vars=True)
        mods = dict(row.named_modules())
        for name, t in row.state_dict(keep_vars=True).items():
            if src[name].device == t.device:
                mod_name, attr = name.rsplit(".", 1) if "." in name else ("", name)
                mod = mods[mod_name]
                (mod._parameters if attr in mod._parameters else mod._buffers)[attr] = src[name]

    @staticmethod
    def _dense_map(row, leaf_map) -> dict:
        """{Dense of the row: the name of the unsharded model's Dense}."""
        out = {}
        for name, mod in row.named_modules():
            if isinstance(mod, Dense):
                for leaf in ("w", "w_q"):
                    if f"{name}.{leaf}" in leaf_map:
                        out[mod] = leaf_map[f"{name}.{leaf}"][0].rsplit(".", 1)[0]
        return out

    def _wrap_layers(self, row, slots) -> None:
        """Gather each sublayer's parts around its forward (under a
        checkpoint unless the model remats its layers already): the
        children of each layer (its norms, attention, cross-attention,
        MLP), since a family may call them without the layer's own forward
        (T5 and mBART do), and around a cross-attention's ``cross_kv``
        (generation projects the encoder output once a sequence); slots
        held by a layer itself gather around the layer's forward.  The
        other slots are the row's root, gathered around its whole loss."""
        own_ckpt = not _per_layer_remat(row)
        claimed = set()
        for list_name in LAYER_LISTS:
            mods = getattr(row, list_name, None)
            if not isinstance(mods, nn.ModuleList):
                continue
            for k, layer in enumerate(mods):
                prefix = f"{list_name}.{k}"
                scopes = [(f"{prefix}.{child}", mod) for child, mod in layer.named_children()] + [(prefix, layer)]
                for scope, mod in scopes:
                    mine = [s for name, s in slots if id(s) not in claimed
                            and (name == scope or name.startswith(scope + "."))]
                    if mine:
                        claimed.update(id(s) for s in mine)
                        mod.forward = self._gathering(mod.forward, mine, mod, own_ckpt)
                        if hasattr(mod, "cross_kv"):  # a decoder's cross K/V, projected once a sequence
                            mod.cross_kv = self._gathering(mod.cross_kv, mine, mod, False)
        self.root_slots[id(row)] = [s for _, s in slots if id(s) not in claimed]

    def _materialize(self, slots, scope) -> list:
        """Gather ``slots`` and give the float Dense layers of ``scope``
        their pending LoRA merges and, under a "once" placement, the
        quantized ones their float weights; returns what to undo."""
        for s in slots:
            s.gather()
        done = []
        for mod in scope:
            if mod in self.pending:
                attach_factors(mod, *self.pending[mod], self.lora.scale)
                done.append(mod)
            if self.once is not None and isinstance(mod, Dense) and mod.w_q is not None:
                dequantize_tree(mod, torch.bfloat16, fold_lora=self.once)
                done.append(mod)
        return done

    @staticmethod
    def _dematerialize(slots, done) -> None:
        for mod in done:
            mod.w_merged = mod.w_dequant = None
            mod.lora_folded = False
        for s in slots:
            s.release()

    def _gathering(self, forward, slots, layer, own_ckpt: bool):
        def run(*a, **k):
            done = self._materialize(slots, list(layer.modules()))
            try:
                return forward(*a, **k)
            finally:
                self._dematerialize(slots, done)

        def wrapped(*a, **k):
            if own_ckpt and torch.is_grad_enabled():
                return checkpoint(run, *a, use_reentrant=False, **k)
            return run(*a, **k)

        return wrapped

    def _root_modules(self, i: int) -> list:
        row = self.rows[i]
        inner = {id(m) for name in LAYER_LISTS if isinstance(getattr(row, name, None), nn.ModuleList)
                 for m in getattr(row, name).modules()}
        return [m for m in row.modules() if id(m) not in inner]

    @contextlib.contextmanager
    def root(self, i: int):
        """Row ``i``'s leaves outside its layers, gathered inside the block."""
        slots = self.root_slots.get(id(self.rows[i]), [])
        done = self._materialize(slots, self._root_modules(i))
        try:
            yield
        finally:
            self._dematerialize(slots, done)

    def _unroot(self) -> None:
        """Give the rows gathered for eval their own parts back."""
        for i, done in self.rooted.items():
            self._dematerialize(self.root_slots.get(id(self.rows[i]), []), done)
        self.rooted = {}

    # ----------------------------------------------------------------- LoRA

    def row_adapters(self, detach: bool = False) -> list[dict]:
        """Every row's copy of the adapter ({dotted name: leaf}, on the row's
        lead device; ``broadcast`` of the whole leaves): one leaf of its own
        under autograd a row and device (rows on one device share it; each
        row's backward differentiates its own loss)."""
        devices = [row[0] for row in self.grid]
        per_leaf = {n: broadcast(t.detach() if detach else t.detach().requires_grad_(True), devices)
                    for n, t in self.adapter_flat.items()}
        return [{n: copies[i] for n, copies in per_leaf.items()} for i in range(self.n_data)]

    def attach(self, i: int, flat: dict) -> None:
        """Attach the adapter ``flat`` to row ``i``'s Dense layers and parts
        (``lora.attach_factors``); a float layer whose weight fsdp splits
        merges where its layer gathers the weight."""
        split = {id(s.module) for _, s in self.slots[i]}
        for dense, whole in self.dense_map[i].items():
            if f"{whole}.a" not in flat:
                continue
            a, b = flat[f"{whole}.a"], flat[f"{whole}.b"]
            if dense.w_q is None and id(dense) in split:
                self.pending[dense] = (a, b)
            else:
                attach_factors(dense, a, b, self.lora.scale)

    def detach_lora(self, i: int) -> None:
        clear_lora(self.rows[i])
        for dense in self.dense_map[i]:
            self.pending.pop(dense, None)

    def eval_rows(self) -> list:
        """Every row with the trained adapter attached (detached factors),
        for eval and generation: under fsdp each layer gathers its parts as
        it runs, and the leaves outside the layers stay gathered until the
        next step."""
        self._unroot()
        with torch.no_grad():
            copies = self.row_adapters(detach=True) if self.adapter is not None else None
            for i in range(self.n_data):
                self.detach_lora(i)
                if copies is not None:
                    self.attach(i, copies[i])
                self.rooted[i] = self._materialize(self.root_slots.get(id(self.rows[i]), []),
                                                   self._root_modules(i))
        return list(self.rows)

    # ----------------------------------------------------------------- step

    def step(self, rows: list, counts: list, loss_of, *, remat: bool = False) -> dict:
        """One optimizer step.  ``rows[a][i]`` is microbatch ``a``'s share
        of data row ``i`` (on the row's lead device), ``counts[a][i]`` its
        number of supervised targets.  Each row's loss is its summed NLL
        over the microbatch's targets, so the rows' gradients add to the
        microbatch's; the metrics are the one-device trainer's."""
        with tracing.span("train.step"):
            return self._step(rows, counts, loss_of, remat)

    def _step(self, rows: list, counts: list, loss_of, remat: bool) -> dict:
        self._unroot()
        for i in range(self.n_data):
            self.detach_lora(i)  # what eval_rows attached
        copies = self.row_adapters() if self.adapter is not None else None
        accum = len(rows)
        loss_sum = torch.zeros((), device=self.lead)
        n_sum = 0
        acc = None
        for mb_rows, mb_counts in zip(rows, counts):
            total = max(sum(mb_counts), 1)
            grads = []
            for i, (mb, c) in enumerate(zip(mb_rows, mb_counts)):
                row = self.rows[i]
                ad = None if copies is None else copies[i]
                if ad is not None:
                    self.attach(i, ad)
                try:
                    if self.once is not None and not self.fsdp:
                        dequantize_tree(row, torch.bfloat16, fold_lora=self.once)

                    def loss_for(batch, row=row):
                        return loss_of(row, batch)

                    if remat and not self.fsdp and not _per_layer_remat(row):
                        plain = loss_for

                        def loss_for(batch, plain=plain):
                            return checkpoint(plain, batch, use_reentrant=False)

                    with self.root(i):
                        loss, _ = loss_for(mb)
                        keys, ts = self.trainable_tensors(ad)
                        gs = torch.autograd.grad(loss * (c / total), ts, allow_unused=True)
                finally:
                    self.detach_lora(i)
                grads.append({k: g for k, g in zip(keys, gs) if g is not None})
                loss_sum = loss_sum + (loss.detach() * c).to(self.lead)
            n_sum += total
            g_units = self.reduce(grads)
            acc = g_units if acc is None else [x + y for x, y in zip(acc, g_units)]
        grads = [g / accum for g in acc]
        values = self.unit_values()
        updates, self.opt_state = self.tx.update(grads, self.opt_state, values)
        for u, p, up in zip(self.units, values, updates):
            self.write(u.leaf, u.index, (p.float() + up).to(p.dtype))
        return {"loss": loss_sum / max(n_sum, 1), "grad_norm": global_norm(grads)}

    # ------------------------------------------------------------ the units

    def _value(self, pieces: list, index: tuple, device, dtype=None, copy: bool = False) -> torch.Tensor:
        """The values of ``index`` of a leaf on ``device``: a view of a piece
        there that holds the region (unless ``copy``), else gathered from
        the pieces."""
        if not copy:
            for p in pieces:
                if p.tensor.device == device and _overlap(p.index, index) == index:
                    return p.tensor.detach()[_rel(index, p.index)]
        out = torch.empty([s.stop - s.start for s in index], dtype=dtype or pieces[0].tensor.dtype, device=device)
        for p in pieces:
            ov = _overlap(p.index, index)
            if ov is not None:
                out[_rel(ov, index)] = p.tensor.detach()[_rel(ov, p.index)].to(device)
        return out

    def unit_values(self) -> list[torch.Tensor]:
        return [self._value(self.train_pieces[u.leaf], u.index, u.device) for u in self.units]

    def write(self, leaf: str, index: tuple, value: torch.Tensor) -> None:
        """Copy ``value`` (the values of ``index``) into every piece of the
        trainable ``leaf`` that holds part of it."""
        with torch.no_grad():
            for p in self._distinct(self.train_pieces[leaf]):
                ov = _overlap(p.index, index)
                if ov is not None:
                    p.tensor.data[_rel(ov, p.index)] = value[_rel(ov, index)].to(p.tensor.device)

    @staticmethod
    def _distinct(pieces: list) -> list:
        """The pieces with tensors of their own (aliased rows count once)."""
        seen, out = set(), []
        for p in pieces:
            if id(p.tensor) not in seen:
                seen.add(id(p.tensor))
                out.append(p)
        return out

    def reduce(self, grads: list[dict]) -> list[torch.Tensor]:
        """The units' f32 gradients from every row's ({leaf name: whole grad}
        for an adapter copy, {id of a piece's tensor: grad} for parameter
        pieces), each the sum over the rows in row order: the reduce-scatter
        of the data axis (an all-reduce to the lead where the unit is
        whole)."""
        out = []
        for n in self.train_names:
            units = self.units_of[n]
            if self.adapter is not None:
                whole = [g[n] for g in grads if n in g]
                if len(units) > 1:
                    dim = next(d for d, (a, b) in enumerate(zip(units[0].index, units[1].index)) if a != b)
                    out += reduce_scatter_sum(whole, [u.device for u in units], dim=dim)
                else:
                    out.append(all_reduce_sum(whole, units[0].device))
                continue
            pieces = self._distinct(self.train_pieces[n])
            for u in units:
                shape = [s.stop - s.start for s in u.index]
                contrib = []
                for g in grads:
                    for p in pieces:
                        gp = g.get(id(p.tensor))
                        ov = None if gp is None else _overlap(p.index, u.index)
                        if ov is None:
                            continue
                        part = gp[_rel(ov, p.index)]
                        if ov != u.index:
                            full = torch.zeros(shape, device=u.device)
                            full[_rel(ov, u.index)] = part.to(u.device, torch.float32)
                            part = full
                        contrib.append(part)
                out.append(all_reduce_sum(contrib, u.device) if contrib else torch.zeros(shape, device=u.device))
        return out

    def trainable_tensors(self, row_adapter: Optional[dict]) -> tuple[list, list]:
        """(keys, tensors) that a row's backward differentiates: the row's
        adapter copy, or every distinct piece of the trainable parameters."""
        if row_adapter is not None:
            return list(row_adapter), list(row_adapter.values())
        ps = [p for n in self.train_names for p in self._distinct(self.train_pieces[n])]
        return [id(p.tensor) for p in ps], [p.tensor for p in ps]

    # ----------------------------------------------------------- whole state

    def param_tensors(self) -> list[torch.Tensor]:
        """Every distinct tensor of the model's pieces, leaf by leaf in the
        JAX order (a tensor that several pieces alias comes once)."""
        seen, out = set(), []
        for n in self.param_names:
            for p in self.pieces[n]:
                if id(p.tensor) not in seen:
                    seen.add(id(p.tensor))
                    out.append(p.tensor)
        return out

    @staticmethod
    def _live(pieces: list, shape) -> Optional[torch.Tensor]:
        """The one tensor that holds a whole leaf, if there is one."""
        own = MeshTrainState._distinct(pieces)
        return own[0].tensor if len(own) == 1 and own[0].index == _whole_index(shape) else None

    def whole_params(self) -> dict:
        """The unsharded model's tensors: each leaf the one tensor that holds
        it whole (live), else a copy assembled on the host from its parts."""
        host = torch.device("cpu")
        out = {}
        for n in self.param_names:
            shape, dtype = self.param_shapes[n]
            live = self._live(self.pieces[n], shape)
            out[n] = live if live is not None else self._value(self.pieces[n], _whole_index(shape), host, dtype,
                                                               copy=True)
        return nest(out)

    def _shapes(self) -> dict:
        if self.adapter is not None:
            return {n: (tuple(t.shape), t.dtype) for n, t in self.adapter_flat.items()}
        return {n: self.param_shapes[n] for n in self.train_names}

    def _template(self):
        """The JAX-structured optimizer state of the whole trainable tree,
        on the meta device (its structure only)."""
        like = nest({n: torch.empty(shape, dtype=dt, device="meta") for n, (shape, dt) in self._shapes().items()})
        return self.tx.init(like)

    def whole_opt_state(self):
        """The optimizer state in the JAX tree's structure: a leaf kept in one
        whole unit is that unit's (live), a split one a copy assembled on
        the host."""
        shapes = self._shapes()
        index_of = {id(u): k for k, u in enumerate(self.units)}

        def walk(tmpl, st):
            if isinstance(tmpl, tuple):
                parts = [walk(a, b) for a, b in zip(tmpl, st)]
                return type(tmpl)(*parts) if hasattr(tmpl, "_fields") else tuple(parts)
            if isinstance(tmpl, (dict, list)):
                leaves = []
                for n in self.train_names:
                    units = self.units_of[n]
                    first = st[index_of[id(units[0])]]
                    if len(units) == 1:  # a whole unit (8-bit moments are always whole)
                        leaves.append(first)
                        continue
                    buf = torch.empty(shapes[n][0], dtype=first.dtype)
                    for u in units:
                        buf[u.index] = st[index_of[id(u)]].cpu()
                    leaves.append(buf)
                return tree_unflatten(tmpl, leaves)
            return st

        return walk(self._template(), self.opt_state)

    def load_opt_state(self, whole) -> None:
        """Split a whole optimizer state (the JAX structure) into the units'."""
        def walk(st, src):
            if isinstance(st, tuple):
                parts = [walk(a, b) for a, b in zip(st, src)]
                return type(st)(*parts) if hasattr(st, "_fields") else tuple(parts)
            if isinstance(st, list):
                flat = dict(zip(self.train_names, tree_leaves(src, is_leaf=lambda x: isinstance(x, QTensor))))
                out = []
                for u in self.units:
                    leaf = flat[u.leaf]
                    if isinstance(leaf, QTensor):
                        out.append(QTensor(leaf.q.to(u.device), leaf.scales.to(u.device), leaf.size, leaf.shape))
                    else:
                        out.append(leaf[u.index].to(u.device).clone())
                return out
            return src.to(st.device).clone()

        self.opt_state = walk(self.opt_state, whole)

    def load_params(self, params: dict) -> None:
        flat = flatten_paths(params)
        with torch.no_grad():
            for n in self.param_names:
                for p in self._distinct(self.pieces[n]):
                    p.tensor.data.copy_(flat[n][p.index].to(p.tensor.device, p.tensor.dtype))

    def load_adapter(self, adapter: dict) -> None:
        with torch.no_grad():
            for n, t in flatten_paths(adapter).items():
                self.adapter_flat[n].copy_(t.to(self.adapter_flat[n].device))

    # ---------------------------------------------------------------- bytes

    def position_bytes(self, device_only: bool = False) -> dict:
        """{(data, model) position: {"param_bytes", "opt_bytes"}}: what each
        position keeps (the base, the adapter and the optimizer state), as
        it would on a card of its own, whether or not its tensors alias
        another position's here; with ``device_only`` what of it lives on a
        GPU (host offload keeps the rest in host memory between steps)."""
        def nbytes(t) -> int:
            leaf = t.q if isinstance(t, QTensor) else t
            return 0 if device_only and leaf.device.type == "cpu" else _nbytes(t)

        out = {(i, j): {"param_bytes": 0, "opt_bytes": 0} for i in range(self.n_data) for j in range(self.n_model)}
        pieces = [p for ps in self.pieces.values() for p in ps]
        if self.adapter is not None:
            pieces += [p for ps in self.train_pieces.values() for p in ps]
        for p in pieces:
            for h in p.holders:
                out[h]["param_bytes"] += nbytes(p.tensor)
        per_unit = [0] * len(self.units)
        scalars = 0

        def walk(st):
            nonlocal scalars
            if isinstance(st, tuple):
                for x in st:
                    walk(x)
            elif isinstance(st, list):
                for k, x in enumerate(st):
                    per_unit[k] += sum(nbytes(t) for t in tree_leaves(x))
            elif isinstance(st, torch.Tensor):
                scalars += nbytes(st)

        walk(self.opt_state)
        for u, nb in zip(self.units, per_unit):
            for h in u.holders:
                out[h]["opt_bytes"] += nb
        for h in out:
            out[h]["opt_bytes"] += scalars
        return out


def _jax_order(flat: dict) -> list[str]:
    """The dotted names of ``flat`` in the JAX tree's flattening order."""
    return tree_leaves(nest({n: n for n in flat}))


def split_rows(x: torch.Tensor, grid) -> list[torch.Tensor]:
    """A batch's rows split evenly over the data rows of ``grid``, each on
    its row's lead device (the placement ``batch_sharding`` names)."""
    if x.shape[0] % len(grid):
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over the mesh's {len(grid)} data rows")
    step = x.shape[0] // len(grid)
    return [x[i * step:(i + 1) * step].to(row[0]) for i, row in enumerate(grid)]


def split_microbatches(cfg, batch: dict, grid) -> tuple[list, list]:
    """(accum, micro_b, ...) leaves (host arrays or tensors) -> (rows,
    counts): ``rows[a][i]`` is microbatch ``a``'s share of data row ``i`` on
    the row's lead device, ``counts[a][i]`` its supervised targets."""
    labels = batch["labels"]
    labels = labels.cpu().numpy() if isinstance(labels, torch.Tensor) else np.asarray(labels)
    step = labels.shape[1] // len(grid)
    rows = [[dict(zip(batch, parts)) for parts in zip(*(split_rows(torch.as_tensor(v[a]), grid)
                                                         for v in batch.values()))]
            for a in range(labels.shape[0])]
    counts = [[target_count(cfg, labels[a][r * step:(r + 1) * step]) for r in range(len(grid))]
              for a in range(labels.shape[0])]
    return rows, counts


def target_count(cfg, labels: np.ndarray) -> int:
    """The supervised targets of a batch's loss: the causal loss predicts
    ``labels[:, 1:]``, the seq2seq losses every label."""
    labels = np.asarray(labels)
    if cfg.arch == "causal":
        labels = labels[:, 1:]
    return int((labels != -100).sum())


def check_micro_batch(gb: int, accum: int, n_data: int) -> None:
    """JAX trainer.py:475-490's divisibility errors."""
    if gb % accum:
        raise ValueError(f"global batch {gb} not divisible by accum {accum}")
    if (gb // accum) % n_data:
        raise ValueError(f"micro-batch {gb // accum} (global batch {gb} / grad_accum {accum}) must be divisible by "
                         f"the data mesh axis ({n_data} devices) -- raise --batch-size or shrink the data axis")


def data_replicas(model, mesh: Optional[Mesh]) -> list:
    """One model a data row of ``mesh`` (``model`` itself when it is a list
    of rows), each on its row's lead device; the model itself where the
    device is its own."""
    if isinstance(model, (list, tuple)):
        return list(model)
    if mesh is None:
        return [model]
    return [model if row[0] == model.device else clone_module(model, row[0]) for row in mesh.grid()]
