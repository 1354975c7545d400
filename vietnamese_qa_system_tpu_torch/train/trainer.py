"""Training engine: the train step, grad accumulation, LoRA, checkpoints.

Counterpart of ``vietnamese_qa_system_tpu/train/trainer.py``, for causal
LMs and the encoder-decoders (T5 / mT5, mBART, the native stack;
trainer.py:142-163 dispatch init and loss by family).  The step
(trainer.py:167-254, ``train/mesh.py``) runs ``grad_accum`` microbatches,
each through the model's loss (``causal_lm.loss_fn`` or the family's
seq2seq loss, whose batches add "labels" of the decoder side) with the
adapter attached to the frozen base (``lora.attach_factors``), sums the
gradients of the trainable tree -- the adapter under LoRA, every parameter
otherwise -- divides by ``grad_accum``, and applies the optimizer chain
(train/optim.py) in place.  Metrics are the token-weighted ``loss`` and the
``grad_norm`` of the averaged gradients.

A quantized base (``quantize_base`` int8, nf4 or nf4-dq) is dequantized
where ``qlora_dequant`` says (trainer.py:184-199): at each matmul
("fused"), or all of it to bf16 once per microbatch before the forward,
with the LoRA factors applied lazily ("once") or folded into the weights
("once_folded", whose backward forms a full-size weight gradient per
layer).

``host_offload`` ("optimizer", "params" or "all") keeps the persistent
copy of the optimizer state and / or the parameters in host memory
(pinned when the device is a GPU) and stages it through the device around
each step (trainer.py:338-470), under every strategy: one host buffer a
distinct piece of the model (a tensor that several rows or positions
alias is copied once) and a leaf of each optimizer unit's state, each
staged back to the device it came from; scalar leaves stay on the device.
``profile_steps`` writes a ``torch.profiler`` trace of the first steps
after start or resume to ``profile_dir``; ``sharded_checkpoint`` writes
the per-host checkpoint layout (train/checkpoint.py).

One device is the mesh of one position.  Over a mesh (``Trainer(cfg,
mesh=...)``, or ``cfg.mesh_axes`` on the device: host repeats with
``device="cpu"``, the visible GPUs with "cuda") the step runs under
``cfg.strategy`` -- dp, zero2, fsdp, tp or fsdp_tp (trainer.py:330-420).
``whole_state()`` gives the JAX package's ``{"params", "adapter",
"opt_state", "step"}`` with the model's tensors as the "params" tree, so
checkpoints flatten in the JAX order and move between the packages: the
live tensors where one tensor holds a whole leaf (every leaf, on one
device), copies assembled on the host from the parts elsewhere.

Not ported yet (it raises): encoder training.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from ..core.device import make_generator, resolve_device
from ..core.mesh import DATA_AXIS, Mesh, create_mesh, mesh_on
from ..core.profiling import bytes_to_mb, device_memory_stats
from ..core.tracing import start_trace, stop_trace
from ..models import causal_lm, families
from ..models.causal_lm import init_causal_lm
from ..models.config import ModelConfig
from ..models.layers import Dense
from ..models.lora import LoraConfig, init_lora
from ..models.quantize import quantize_dense_tree
from ..utils.trackers import make_tracker
from ..utils.tree import nest, tree_leaves, tree_unflatten
from .checkpoint import CheckpointManager
from .mesh import MeshTrainState, check_micro_batch, split_microbatches
from .optim import Transform, make_optimizer, make_schedule


@dataclasses.dataclass
class TrainConfig:
    """The training-loop settings of the JAX package's ``TrainConfig``
    (trainer.py:48-119), field for field."""

    model: ModelConfig
    lora: Optional[LoraConfig] = None
    optimizer: str = "adamw"
    lr: float = 2e-4
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0
    schedule: str = "linear"
    warmup_steps: int = 0
    epochs: int = 1
    grad_accum: int = 1  # microbatches per step
    strategy: str = "dp"  # dp | zero2 | fsdp | tp | fsdp_tp (train/mesh.py)
    mesh_axes: Optional[dict] = None  # e.g. {"data": 4} / {"data": 2, "model": 2}; None: one device
    host_offload: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    sharded_checkpoint: bool = False
    save_every_steps: Optional[int] = None
    save_every_seconds: Optional[float] = None
    async_checkpoint: bool = False
    keep_checkpoints: int = 3
    resume: bool = False
    # quantize the frozen base ("int8", "nf4", "nf4-dq"); LoRA trains over it
    quantize_base: Optional[str] = None
    # where the quantized base is dequantized: "fused" = at each matmul;
    # "once" = all of it to bf16 before each microbatch's forward, the
    # factors applied lazily; "once_folded" = the same with the factors
    # folded into the weights
    qlora_dequant: str = "fused"
    seed: int = 42
    log_every: int = 10
    log_dir: str = "runs/logs"
    report_to: str = "jsonl"
    run_name: Optional[str] = None
    remat: bool = False  # checkpoint the whole loss (when no per-layer remat applies)
    profile_steps: int = 0
    profile_dir: str = "runs/profile"


def _factory_wants_epoch(factory: Callable) -> bool:
    """True if the batch factory takes a positional epoch index."""
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):
        return False
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD, p.VAR_POSITIONAL):
            return True
        if p.kind == p.KEYWORD_ONLY and p.default is p.empty:
            return False
    return False


def params_tree(model: torch.nn.Module) -> dict:
    """The model's tensors (the live parameters and buffers) nested as the
    JAX parameter pytree."""
    return nest(dict(model.state_dict(keep_vars=True)))


def model_loss_fn(cfg: ModelConfig):
    """The training loss of ``cfg``'s architecture (trainer.py:153-163)."""
    if cfg.arch == "causal":
        return causal_lm.loss_fn
    if cfg.arch == "seq2seq":
        return families.loss_fn
    raise ValueError(f"no training loss for arch {cfg.arch!r}")


def init_model(cfg: ModelConfig, generator: torch.Generator, *, quantize: Optional[str] = None):
    """Random weights of ``cfg``'s architecture and family (trainer.py:142-151)."""
    if cfg.arch == "causal":
        return init_causal_lm(cfg, generator, quantize=quantize)
    if cfg.arch == "seq2seq":
        return families.init_seq2seq_model(cfg, generator, quantize=quantize)
    raise ValueError(f"no trainable model for arch {cfg.arch!r}")


def dequant_once(cfg: TrainConfig) -> Optional[bool]:
    """None for the fused dequantization, else whether the "once"
    placement folds the factors into the weights."""
    return None if cfg.quantize_base is None or cfg.qlora_dequant == "fused" else cfg.qlora_dequant == "once_folded"


def one_position(device) -> Mesh:
    """The mesh of one position on ``device``: the one-device trainer's."""
    return create_mesh({DATA_AXIS: 1}, devices=[device])


def make_train_step(cfg: TrainConfig, tx: Transform, model):
    """The JAX package's functional (state, batch) -> (state, metrics) step
    on the model's device: the trainer's step over one position.  ``state``
    holds the model's own tensors as "params", the adapter, the optimizer
    state of the trainable tree in the JAX structure and "step"; batch
    leaves are (grad_accum, microbatch, T) tensors.  The trainable tree is
    updated in place."""
    mesh = one_position(model.device)
    loss_of = model_loss_fn(cfg.model)

    def step_fn(state, batch):
        placed = MeshTrainState(model, mesh, "dp", tx, adapter=state["adapter"] if cfg.lora is not None else None,
                                lora=cfg.lora, once=dequant_once(cfg))
        placed.load_opt_state(state["opt_state"])
        metrics = placed.step(*split_microbatches(cfg.model, batch, placed.grid), loss_of, remat=cfg.remat)
        state["opt_state"] = placed.whole_opt_state()
        state["step"] = state["step"] + 1
        return state, metrics

    return step_fn


STRATEGIES = ("dp", "zero2", "fsdp", "tp", "fsdp_tp")


class Trainer:
    """init -> (resume) -> fit on one device (``device``, default the card)
    or over a mesh (``mesh``, or ``cfg.mesh_axes`` on ``device``).

    ``params``: a :class:`CausalLM` or an encoder-decoder to start from (its
    configuration is replaced by ``cfg.model``); None draws random weights
    from ``cfg.seed`` on the device, layer by layer, each layer quantized
    as it is made when ``quantize_base`` is set."""

    def __init__(self, cfg: TrainConfig, *, params=None, mesh: Optional[Mesh] = None,
                 total_steps: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        m = cfg.model
        if cfg.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, got {cfg.strategy!r}")
        if m.arch not in ("causal", "seq2seq"):
            raise NotImplementedError(f"{m.arch} training is not ported yet")
        if mesh is None and cfg.mesh_axes:
            mesh = mesh_on(resolve_device(device), cfg.mesh_axes)
        if mesh is not None and len(mesh.grid()) * len(mesh.grid()[0]) == 1:
            device, mesh = mesh.grid()[0][0], None  # one position: the one-device trainer
        self.mesh = mesh
        if mesh is not None:
            device = mesh.grid()[0][0]
        if cfg.qlora_dequant not in ("fused", "once", "once_folded"):
            raise ValueError(f"qlora_dequant must be 'fused', 'once' or 'once_folded', got {cfg.qlora_dequant!r}")
        if cfg.host_offload is not None and cfg.host_offload not in ("optimizer", "params", "all"):
            raise ValueError(f"host_offload must be optimizer|params|all, got {cfg.host_offload!r}")
        if cfg.lora is None and m.use_flash_attention and (m.seq2seq_family == "t5" or m.relative_attention_buckets):
            raise ValueError(
                "full fine-tuning with use_flash_attention on a relative-bias family (T5/MPNet) would silently "
                "freeze the bias tables (the fused kernel's bias cotangent is zero) -- disable flash attention "
                "or train with LoRA")
        if m.scan_layers and m.attention_layers is not None and len(set(m.attention_layers)) > 1:
            raise ValueError("scan_layers requires homogeneous layers (attention_layers alternation cannot be "
                             "scanned)")
        if cfg.quantize_base is not None and cfg.lora is None:
            raise ValueError("quantize_base requires LoRA: int8 / nf4 codes cannot take gradient updates")
        device = resolve_device(device)
        if params is None:
            model = init_model(m, make_generator(cfg.seed, device), quantize=cfg.quantize_base)
        else:
            model = params
            model.cfg = m
            if cfg.quantize_base is not None:
                quantize_dense_tree(model, cfg.quantize_base)
        self.device = model.device
        if cfg.lora is not None:
            self.adapter = init_lora(make_generator(cfg.seed + 1, self.device), model, cfg.lora)
        else:
            self.adapter = None
            for mod in model.modules():
                if isinstance(mod, Dense) and mod.w_q is not None:
                    raise ValueError("full fine-tuning needs a float base; this one is quantized")
        sched = make_schedule(cfg.schedule, cfg.lr, total_steps or 10_000, cfg.warmup_steps)
        self.tx = make_optimizer(cfg.optimizer, sched, weight_decay=cfg.weight_decay,
                                 max_grad_norm=cfg.max_grad_norm)
        placement = (mesh, cfg.strategy) if mesh is not None else (one_position(self.device), "dp")
        self.placed = MeshTrainState(model, *placement, self.tx, adapter=self.adapter, lora=cfg.lora,
                                     once=dequant_once(cfg))
        self.model = self.placed.rows[0]
        self.global_step = 0
        self._loss_of = model_loss_fn(m)
        # host offload: the persistent copies, pinned on a GPU's host
        self._pin = self.device.type == "cuda"
        self._offload_params = cfg.host_offload in ("params", "all")
        self._offload_opt = cfg.host_offload in ("optimizer", "all")
        self._host_params = self._host_opt = None
        self._param_devices = [t.device for t in self.placed.param_tensors()]
        self._opt_devices = [t.device for t in tree_leaves(self.placed.opt_state)]
        if self._offload_params:
            self._host_params = [self._host_buffer(t) for t in self.placed.param_tensors()]
            self._params_to_host()
        if self._offload_opt:
            self._host_opt = [self._host_buffer(t) for t in tree_leaves(self.placed.opt_state)]
            self.placed.opt_state = self._opt_to_host(self.placed.opt_state)
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, cfg.keep_checkpoints, sharded=cfg.sharded_checkpoint)
                     if cfg.checkpoint_dir else None)
        self.tracker = make_tracker(cfg.report_to, cfg.log_dir, cfg.run_name)
        self.start_step = 0
        if cfg.resume and self.ckpt is not None:
            restored, meta = self.ckpt.restore(self.whole_state())
            if restored is not None:
                self.load_state(restored)
                self.start_step = int(meta["step"])
                print(f"resumed from step {self.start_step}", flush=True)

    # ----------------------------------------------------------------- state

    def whole_state(self) -> dict:
        """{"params", "adapter", "opt_state", "step"} in the JAX package's
        structure: each leaf the live tensor that holds it whole (every
        leaf on one device; the adapter always), else a copy assembled on
        the host from its parts -- over a mesh of several devices, a copy
        of the whole model and optimizer state."""
        return {"params": self.placed.whole_params(), "adapter": self.adapter,
                "opt_state": self.placed.whole_opt_state(),
                "step": torch.tensor(self.global_step, dtype=torch.int32, device=self.device)}

    def position_bytes(self, device_only: bool = False) -> dict:
        """{(data, model) position: {"param_bytes", "opt_bytes"}} that each
        mesh position keeps (train/mesh.py); with ``device_only`` what of
        it lives on a GPU between steps (host offload keeps the rest on the
        host)."""
        return self.placed.position_bytes(device_only)

    # ---------------------------------------------------------- host offload

    def _host_buffer(self, t: torch.Tensor):
        """A host tensor the shape of ``t`` (pinned on a GPU's host), or
        None for a scalar, which stays on the device."""
        if t.dim() == 0:
            return None
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=self._pin)

    def _params_to_host(self) -> None:
        """The model's tensors point at their host copies, updated from the device."""
        with torch.no_grad():
            for t, host in zip(self.placed.param_tensors(), self._host_params):
                if host is not None and t.data.data_ptr() != host.data_ptr():
                    host.copy_(t.data)
                    t.data = host

    def _params_to_device(self) -> None:
        with torch.no_grad():
            for t, host, dev in zip(self.placed.param_tensors(), self._host_params, self._param_devices):
                if host is not None:
                    t.data = t.data.to(dev, non_blocking=True)

    def _opt_to_device(self, opt_state):
        return tree_unflatten(opt_state, [t.to(dev, non_blocking=True)
                                          for t, dev in zip(tree_leaves(opt_state), self._opt_devices)])

    def _opt_to_host(self, opt_state):
        out = []
        for t, host in zip(tree_leaves(opt_state), self._host_opt):
            if host is None:
                out.append(t)
            else:
                host.copy_(t)
                out.append(host)
        return tree_unflatten(opt_state, out)

    def run_step(self, batch: dict) -> dict:
        """One optimizer step on a :meth:`device_batch`; returns its metrics.
        With host offload the host-resident parts are staged onto the device
        before it and written back after it (trainer.py:380-402)."""
        if self._offload_params:
            self._params_to_device()
        if self._offload_opt:
            self.placed.opt_state = self._opt_to_device(self.placed.opt_state)
        metrics = self.placed.step(batch["rows"], batch["counts"], self._loss_of, remat=self.cfg.remat)
        self.global_step += 1
        if self._offload_params:
            self._params_to_host()
        if self._offload_opt:
            self.placed.opt_state = self._opt_to_host(self.placed.opt_state)
        return metrics

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a host batch (as ``fit`` takes them)."""
        return self.run_step(self.device_batch(batch))

    def load_state(self, state: dict) -> None:
        """Take a whole state (``whole_state``'s structure, e.g. restored):
        every piece of the model and the adapter is overwritten in place,
        the optimizer state and step replaced."""
        self.placed.load_params(state["params"])
        if self.adapter is not None:
            self.placed.load_adapter(state["adapter"])
        self.placed.load_opt_state(state["opt_state"])
        if self._offload_opt:  # the loaded state lands in the persistent host buffers
            self.placed.opt_state = self._opt_to_host(self.placed.opt_state)
        self.global_step = int(state["step"])

    # ------------------------------------------------------------------ fit

    def device_batch(self, batch: dict) -> dict:
        """(global_b, ...) host arrays -> {"rows": each microbatch's share of
        every data row on the row's device (JAX's ``accum_batch_sharding``),
        "counts": their supervised targets, "input_ids": the host ids}."""
        a = self.cfg.grad_accum
        gb = np.asarray(batch["input_ids"]).shape[0]
        check_micro_batch(gb, a, len(self.placed.grid))
        host = {k: np.asarray(v).astype(np.int64).reshape(a, gb // a, *np.asarray(v).shape[1:])
                for k, v in batch.items()}
        rows, counts = split_microbatches(self.cfg.model, host, self.placed.grid)
        return {"rows": rows, "counts": counts, "input_ids": host["input_ids"]}

    def fit(self, train_batches: Callable[..., Iterable[dict]], *, eval_fn: Optional[Callable[[Any, int], dict]] = None,
            max_steps: Optional[int] = None) -> int:
        """train_batches: factory of one epoch's iterable of host batches
        {"input_ids", "attention_mask", "labels"} with a global batch dim;
        a factory taking a positional argument receives the epoch index (so
        a resumed run repeats the original shuffles).  Resume fast-forwards
        within the epoch, as trainer.py:495-613 does.  ``eval_fn(rows,
        epoch)`` gets :meth:`merged_replicas` after each epoch.  Returns the
        step reached."""
        cfg = self.cfg
        epoch_iter = (lambda e: train_batches(e)) if _factory_wants_epoch(train_batches) else (
            lambda e: train_batches())
        step = self.start_step
        last_save = time.time()
        skip = self.start_step
        steps_per_epoch = None
        if skip > 0:
            probe = epoch_iter(0)
            if hasattr(probe, "__len__"):
                steps_per_epoch = len(probe)
        on_card = self.device.type == "cuda"
        prof = None
        if cfg.profile_steps > 0:
            prof = start_trace(cfg.profile_dir, self.device)
            profile_until = step + cfg.profile_steps
        for epoch in range(cfg.epochs):
            if steps_per_epoch is not None and skip >= steps_per_epoch:
                skip -= steps_per_epoch
                continue  # epoch fully trained before the restart
            epoch_tokens, epoch_steps, n_batches = 0, 0, 0
            t0 = time.time()
            if on_card:
                torch.cuda.reset_peak_memory_stats(self.device)
            for i, batch in enumerate(epoch_iter(epoch)):
                n_batches = i + 1
                if skip > 0:
                    skip -= 1
                    continue  # fast-forward within the resume epoch
                dev_batch = self.device_batch(batch)
                n_tok = int(np.prod(dev_batch["input_ids"].shape))
                metrics = self.run_step(dev_batch)
                step += 1
                epoch_steps += 1
                epoch_tokens += n_tok
                if prof is not None and step >= profile_until:
                    if on_card:
                        torch.cuda.synchronize(self.device)
                    print(f"profiler trace written to {stop_trace(prof, cfg.profile_dir)}", flush=True)
                    prof = None
                if step % cfg.log_every == 0:
                    loss = float(metrics["loss"])
                    self.tracker.log({"loss": loss, "grad_norm": float(metrics["grad_norm"]), "epoch": epoch,
                                      "tokens_per_s": epoch_tokens / max(time.time() - t0, 1e-9)}, step)
                if self._should_save(step, last_save):
                    self.save(step)
                    last_save = time.time()
                if max_steps is not None and step >= max_steps:
                    break
            if steps_per_epoch is None:
                steps_per_epoch = n_batches
            if n_batches == 0:
                print("WARNING: epoch produced 0 batches -- check the batch size and that examples fit --max-len",
                      file=sys.stderr)
            if epoch_steps == 0 and n_batches > 0 and step == self.start_step:
                continue  # epoch consumed entirely by fast-forward counting
            mem = device_memory_stats(self.device)
            peak = f"{bytes_to_mb(mem['peak_bytes_in_use'])}MB" if mem["supported"] else "n/a (host)"
            print(f"epoch {epoch}: steps={epoch_steps} device_mem_peak={peak}", flush=True)
            if eval_fn is not None:
                eval_metrics = eval_fn(self.merged_replicas(), epoch)
                self.tracker.log({f"eval_{k}": v for k, v in eval_metrics.items()}, step)
            if self.ckpt is not None:
                self.save(step)
            if max_steps is not None and step >= max_steps:
                break
        if prof is not None:
            print(f"profiler trace written to {stop_trace(prof, cfg.profile_dir)}", flush=True)
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.global_step

    def _should_save(self, step: int, last_save: float) -> bool:
        if self.ckpt is None:
            return False
        if self.cfg.save_every_steps and step % self.cfg.save_every_steps == 0:
            return True
        return bool(self.cfg.save_every_seconds and time.time() - last_save > self.cfg.save_every_seconds)

    def save(self, step: int) -> None:
        if self.ckpt is not None:
            meta = {"config": repr(self.cfg)}
            if self.cfg.async_checkpoint:
                self.ckpt.save_async(step, self.whole_state(), meta)
            else:
                self.ckpt.save(step, self.whole_state(), meta)

    # ---------------------------------------------------------------- export

    def merged_params(self):
        """The model with the trained adapter attached (detached factors;
        the adapter merged into float layers), for inference and export.
        Offloaded parameters come back to the device (the next step
        returns them to the host).  Over a mesh, the first data row's model
        (:meth:`merged_replicas` gives every row's)."""
        return self.merged_replicas()[0]

    def merged_replicas(self) -> list:
        """One model with the trained adapter attached a data row (the
        mesh's ``perplexity_eval(mesh=)`` / ``generative_eval(mesh=)`` split
        their batches over them)."""
        if self._offload_params:
            self._params_to_device()
        return self.placed.eval_rows()
