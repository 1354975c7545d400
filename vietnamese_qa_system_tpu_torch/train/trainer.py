"""Training engine: the train step, grad accumulation, LoRA, checkpoints.

Counterpart of ``vietnamese_qa_system_tpu/train/trainer.py`` on one
device, for causal LMs and the encoder-decoders (T5 / mT5, mBART, the
native stack; trainer.py:142-163 dispatch init and loss by family).  The
step (trainer.py:167-254) runs ``grad_accum`` microbatches, each through
the model's loss (``causal_lm.loss_fn`` or the family's seq2seq loss,
whose batches add "labels" of the decoder side) with the adapter attached to the frozen
base (``merge_lora``), sums the gradients of the trainable tree -- the
adapter under LoRA, every parameter otherwise -- divides by
``grad_accum``, and applies the optimizer chain (train/optim.py) in place.
Metrics are the token-weighted ``loss`` and the ``grad_norm`` of the
averaged gradients.

A quantized base (``quantize_base`` int8, nf4 or nf4-dq) is dequantized
where ``qlora_dequant`` says (trainer.py:184-199): at each matmul
("fused"), or all of it to bf16 once per microbatch before the forward,
with the LoRA factors applied lazily ("once") or folded into the weights
("once_folded", whose backward forms a full-size weight gradient per
layer).

``host_offload`` ("optimizer", "params" or "all") keeps the persistent
copy of the optimizer state and / or the parameters in host memory
(pinned when the device is a GPU) and stages it through the device around
each step (trainer.py:338-470); scalar leaves stay on the device.
``profile_steps`` writes a ``torch.profiler`` trace of the first steps
after start or resume to ``profile_dir``; ``sharded_checkpoint`` writes
the per-host checkpoint layout (train/checkpoint.py).

The trainer's state is the JAX package's ``{"params", "adapter",
"opt_state", "step"}`` with the model's tensors as the "params" tree, so
checkpoints flatten in the JAX order and move between the packages.

Not ported yet (each raises): strategies other than "dp", and encoder
training.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import make_generator, resolve_device
from ..core.profiling import bytes_to_mb, device_memory_stats
from ..core.tracing import start_trace, stop_trace
from ..models import causal_lm, families
from ..models.causal_lm import init_causal_lm
from ..models.config import ModelConfig
from ..models.layers import Dense
from ..models.lora import LoraConfig, clear_lora, init_lora, merge_lora
from ..models.quantize import dequantize_tree, quantize_dense_tree
from ..utils.trackers import make_tracker
from ..utils.tree import nest, tree_leaves, tree_map, tree_unflatten
from .checkpoint import CheckpointManager
from .optim import Transform, apply_updates, global_norm, make_optimizer, make_schedule


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
    strategy: str = "dp"  # only "dp" (one device) is ported
    mesh_axes: Optional[dict] = None
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


def make_train_step(cfg: TrainConfig, tx: Transform, model):
    """The (state, batch) -> (state, metrics) step; batch leaves are
    (grad_accum, microbatch, T) tensors on the model's device.  The state's
    trainable tree and optimizer state are updated in place / replaced."""
    use_lora = cfg.lora is not None
    loss_of = model_loss_fn(cfg.model)

    once = cfg.quantize_base is not None and cfg.qlora_dequant != "fused"

    def loss_for(mb):
        if once:
            # the whole frozen base to bf16 before the forward (trainer.py:184-199)
            dequantize_tree(model, torch.bfloat16, fold_lora=cfg.qlora_dequant == "once_folded")
        return loss_of(model, mb)

    if cfg.remat and not (cfg.model.scan_layers and cfg.model.remat_policy != "none"):
        # whole-loss remat only where no per-layer remat applies: both would
        # recompute the forward twice (trainer.py:204-214)
        plain = loss_for

        def loss_for(mb):
            return checkpoint(plain, mb, use_reentrant=False)

    def step_fn(state, batch):
        with torch.profiler.record_function("train.step"):
            return _step(state, batch)

    def _step(state, batch):
        trainable = state["adapter"] if use_lora else state["params"]
        leaves = tree_leaves(trainable)
        g_acc = [torch.zeros_like(leaf, dtype=torch.float32) for leaf in leaves]
        loss_sum = torch.zeros((), device=leaves[0].device)
        n_sum = 0
        for a in range(batch["input_ids"].shape[0]):
            mb = {k: v[a] for k, v in batch.items()}
            if use_lora:
                merge_lora(model, trainable, cfg.lora)
            try:
                loss, n = loss_for(mb)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            finally:
                if use_lora:
                    clear_lora(model)
            for acc, g in zip(g_acc, grads):
                if g is not None:
                    acc += g
            loss_sum = loss_sum + loss.detach() * n
            n_sum = n_sum + n
        grads = tree_unflatten(trainable, [g / cfg.grad_accum for g in g_acc])
        updates, state["opt_state"] = tx.update(grads, state["opt_state"], trainable)
        apply_updates(trainable, updates)
        state["step"] = state["step"] + 1
        metrics = {"loss": loss_sum / torch.clamp(torch.as_tensor(n_sum).float(), min=1.0),
                   "grad_norm": global_norm(grads)}
        return state, metrics

    return step_fn


class Trainer:
    """init -> (resume) -> fit on one device (``device``, default the card).

    ``params``: a :class:`CausalLM` or an encoder-decoder to start from (its
    configuration is replaced by ``cfg.model``); None draws random weights
    from ``cfg.seed`` on the device, layer by layer, each layer quantized
    as it is made when ``quantize_base`` is set."""

    def __init__(self, cfg: TrainConfig, *, params=None, total_steps: Optional[int] = None, device="cuda"):
        self.cfg = cfg
        m = cfg.model
        for what, unported in (("strategy " + repr(cfg.strategy), cfg.strategy != "dp"),
                               (f"{m.arch} training", m.arch not in ("causal", "seq2seq"))):
            if unported:
                raise NotImplementedError(f"{what} is not ported yet")
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
        self.model = model
        self.device = model.device
        if cfg.lora is not None:
            self.adapter = init_lora(make_generator(cfg.seed + 1, self.device), model, cfg.lora)
        else:
            self.adapter = None
            for mod in model.modules():
                if isinstance(mod, Dense) and mod.w_q is not None:
                    raise ValueError("full fine-tuning needs a float base; this one is quantized")
            model.requires_grad_(True)
        sched = make_schedule(cfg.schedule, cfg.lr, total_steps or 10_000, cfg.warmup_steps)
        self.tx = make_optimizer(cfg.optimizer, sched, weight_decay=cfg.weight_decay,
                                 max_grad_norm=cfg.max_grad_norm)
        self.state = {"params": params_tree(model), "adapter": self.adapter, "opt_state": None,
                      "step": torch.zeros((), dtype=torch.int32, device=self.device)}
        self.state["opt_state"] = self.tx.init(self.adapter if self.adapter is not None else self.state["params"])
        self._step_fn = make_train_step(cfg, self.tx, model)
        # host offload: the persistent copies, pinned on a GPU's host
        self._pin = self.device.type == "cuda"
        self._offload_params = cfg.host_offload in ("params", "all")
        self._offload_opt = cfg.host_offload in ("optimizer", "all")
        self._host_params = self._host_opt = None
        if self._offload_params:
            self._host_params = [self._host_buffer(t) for t in tree_leaves(self.state["params"])]
            self._params_to_host()
        if self._offload_opt:
            self._host_opt = [self._host_buffer(t) for t in tree_leaves(self.state["opt_state"])]
            self.state["opt_state"] = self._opt_to_host(self.state["opt_state"])
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, cfg.keep_checkpoints, sharded=cfg.sharded_checkpoint)
                     if cfg.checkpoint_dir else None)
        self.tracker = make_tracker(cfg.report_to, cfg.log_dir, cfg.run_name)
        self.start_step = 0
        if cfg.resume and self.ckpt is not None:
            restored, meta = self.ckpt.restore(self.state)
            if restored is not None:
                self.load_state(restored)
                self.start_step = int(meta["step"])
                print(f"resumed from step {self.start_step}", flush=True)

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
            for t, host in zip(tree_leaves(self.state["params"]), self._host_params):
                if host is not None and t.data.data_ptr() != host.data_ptr():
                    host.copy_(t.data)
                    t.data = host

    def _params_to_device(self) -> None:
        with torch.no_grad():
            for t, host in zip(tree_leaves(self.state["params"]), self._host_params):
                if host is not None:
                    t.data = t.data.to(self.device, non_blocking=True)

    def _opt_to_host(self, opt_state):
        out = []
        for t, host in zip(tree_leaves(opt_state), self._host_opt):
            if host is None:
                out.append(t)
            else:
                host.copy_(t)
                out.append(host)
        return tree_unflatten(opt_state, out)

    def _run_step(self, state: dict, batch: dict):
        """One optimizer step; with host offload the host-resident parts are
        staged onto the device before it and written back after it
        (trainer.py:380-402)."""
        if self._offload_params:
            self._params_to_device()
        if self._offload_opt:
            state["opt_state"] = tree_map(lambda t: t.to(self.device, non_blocking=True), state["opt_state"])
        state, metrics = self._step_fn(state, batch)
        if self._offload_params:
            self._params_to_host()
        if self._offload_opt:
            state["opt_state"] = self._opt_to_host(state["opt_state"])
        return state, metrics

    def load_state(self, state: dict) -> None:
        """Take a restored state: the model's tensors and the adapter are
        overwritten in place, the optimizer state and step replaced."""
        with torch.no_grad():
            for key in ("params", "adapter"):
                for live, new in zip(tree_leaves(self.state[key]), tree_leaves(state[key])):
                    live.copy_(new)
        self.state["opt_state"] = state["opt_state"]
        self.state["step"] = state["step"]

    # ------------------------------------------------------------------ fit

    def _device_batch(self, batch: dict) -> dict:
        """(global_b, ...) numpy -> (accum, micro_b, ...) tensors on the device."""
        a = self.cfg.grad_accum
        out = {}
        for k, v in batch.items():
            x = np.asarray(v)
            if x.shape[0] % a:
                raise ValueError(f"global batch {x.shape[0]} not divisible by accum {a}")
            out[k] = torch.from_numpy(x.reshape(a, x.shape[0] // a, *x.shape[1:]).astype(np.int64)).to(self.device)
        return out

    def fit(self, train_batches: Callable[..., Iterable[dict]], *, eval_fn: Optional[Callable[[Any, int], dict]] = None,
            max_steps: Optional[int] = None):
        """train_batches: factory of one epoch's iterable of host batches
        {"input_ids", "attention_mask", "labels"} with a global batch dim;
        a factory taking a positional argument receives the epoch index (so
        a resumed run repeats the original shuffles).  Resume fast-forwards
        within the epoch, as trainer.py:495-613 does."""
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
                dev_batch = self._device_batch(batch)
                n_tok = int(np.prod(dev_batch["input_ids"].shape))
                self.state, metrics = self._run_step(self.state, dev_batch)
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
                eval_metrics = eval_fn(self.state, epoch)
                self.tracker.log({f"eval_{k}": v for k, v in eval_metrics.items()}, step)
            if self.ckpt is not None:
                self.save(step)
            if max_steps is not None and step >= max_steps:
                break
        if prof is not None:
            print(f"profiler trace written to {stop_trace(prof, cfg.profile_dir)}", flush=True)
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.state

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
                self.ckpt.save_async(step, self.state, meta)
            else:
                self.ckpt.save(step, self.state, meta)

    # ---------------------------------------------------------------- export

    def merged_params(self):
        """The model with the trained adapter attached (detached factors;
        the adapter merged into float layers), for inference and export.
        Offloaded parameters come back to the device (the next step
        returns them to the host)."""
        if self._offload_params:
            self._params_to_device()
        if self.adapter is None:
            return self.model
        return merge_lora(self.model, tree_map(lambda t: t.detach(), self.adapter), self.cfg.lora)
