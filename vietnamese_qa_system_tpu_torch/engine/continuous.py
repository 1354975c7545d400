"""Continuous-batching scheduler over models/decode_engine.py.

Counterpart of ``vietnamese_qa_system_tpu/engine/continuous.py``
(:58-856): ``ContinuousEngine`` keeps ``n_slots`` causal or seq2seq
sequences in flight.  A scheduler thread admits queued requests between chunks (prefill
at a bucketed width, through the prefix cache when a stored prompt is a
prefix, or piece by piece with ``prefill_chunk``), inserts each into a free
slot, and dispatches decode chunks over all slots: speculative prompt-lookup
chunks while every request is greedy, plain chunks otherwise.

The host reads the device once per chunk, pipelined one chunk deep: chunk
k + 1 is dispatched before chunk k's tokens are read.  Each chunk's tokens
(and each request's first token) are copied into pinned host memory
behind a CUDA event as soon as they are enqueued, and the harvest waits on
that event alone, so it never waits for the chunk dispatched after it.
Every step of a chunk has static shapes and reads nothing back.

Each request's greedy stream equals a standalone greedy ``generate()`` of
its prompt, however requests interleave (tests/test_torch_continuous.py
holds it to the JAX engine).  Sampled requests draw from the engine's
``torch.Generator``: the JAX engine's distributions, other numbers.

Multi-LoRA serving (continuous.py:266-280): ``adapters`` {name: adapter
tree} over the shared base are stacked into one bank (index 0 the base
model), laid onto the reader's dense layers once (on a tensor-parallel
reader each split part holds its slice on its device); a request names
its adapter in :meth:`submit`, its slot keeps the bank index, and each
chunk runs every slot under its own adapter.  The prefix cache is keyed
by (tokens, adapter index), so adapters never share prompt KV.

A seq2seq reader's slots (continuous.py:207-255, :516-565) hold their own
cross-attention K/V and encoder mask; prompts are bucketed on the encoder
side only (the largest bucket may reach ``total``), each decoder row
holds BOS and at most ``total - 1`` generated tokens, and adapters, the
prefix cache, chunked prefill and an int8 KV cache are refused, with
speculation off, as the JAX engine refuses them.

While a ``torch.profiler`` session runs, the scheduler records spans
(core/tracing.py), per turn and per request, never per token:
``engine.queue`` (``submit()`` to the pop that gives the request a slot),
``engine.prefill`` (that pop to the insert done), ``engine.first`` (the
insert to the first token handed to the stream): the three cover a
request's wait for its first token without a gap; ``engine.admit``,
``engine.chunk`` (models/decode_engine.py), ``engine.harvest`` with its
``engine.fetch`` (the wait on the chunk's copy), ``engine.wait`` (idle).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import tracing
from ..core.device import resolve_device
from ..models import decode_engine as de
from ..models.decode_engine import TOPK_CAP
from ..models.lora import LoraConfig, place_bank, stack_adapters

_rids = itertools.count()  # request ids, unique in the process


@dataclass
class _Request:
    ids: list[int]
    max_new: int
    future: Future
    stream: Optional[Callable[[int], None]] = None
    out: list[int] = field(default_factory=list)
    remaining: int = 0  # tokens still expected from decode chunks
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # the first token, on its way to the host (see _Fetch)
    pending_first: object = None
    # first chunk index whose emissions belong to this request
    start_chunk: int = -1
    adapter_ix: int = 0  # LoRA bank index (0 = the base model)
    rid: int = field(default_factory=lambda: next(_rids))
    # time.time_ns() at submit(), at the pop that gave it a slot, at the insert's end (the spans' ends)
    t_submit: int = field(default_factory=time.time_ns)
    t_pop: int = 0
    t_install: int = 0
    reused: int = 0  # prompt tokens taken from the prefix cache


def _validate_sampling(temperature, top_k, top_p) -> None:
    if not (isinstance(temperature, (int, float)) and not isinstance(temperature, bool) and 0.0 <= temperature):
        raise ValueError(f"temperature must be a float >= 0, got {temperature!r}")
    if not (isinstance(top_k, int) and not isinstance(top_k, bool) and 0 <= top_k <= TOPK_CAP):
        raise ValueError(f"top_k must be an int in [0, {TOPK_CAP}], got {top_k!r}")
    if not (isinstance(top_p, (int, float)) and not isinstance(top_p, bool) and 0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be a float in (0, 1], got {top_p!r}")


class _Fetch:
    """Device tensors copied to the host without blocking the enqueueing
    thread: into pinned buffers behind a CUDA event on a card, plainly on
    the CPU.  :meth:`get` waits for this copy alone."""

    def __init__(self, *tensors):
        if tensors[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = [t.clone() for t in tensors], None

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class _PrefixCache:
    """Host-managed LRU of device-resident prompt-KV prefixes
    (continuous.py:94), keyed by the prompt's token tuple and adapter index
    (an adapter changes K/V, so adapters never share entries).  ``lookup``
    returns the longest stored entry of the same adapter that is a strict
    prefix of the new prompt (capped at len - 1, so at least one suffix
    token runs); eviction is LRU by the entries' tensor bytes."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.bytes = 0
        self.tick = 0
        self._entries: dict[tuple, dict] = {}

    @staticmethod
    def _nbytes(kv) -> int:
        return sum(leaf.numel() * leaf.element_size() for layer in kv for leaf in layer.values())

    def lookup(self, ids: Sequence[int], adapter_ix: int = 0):
        best, best_p = None, 0
        for (toks, aix), ent in self._entries.items():
            if aix != adapter_ix:
                continue
            p_eff = min(len(toks), len(ids) - 1)
            if p_eff <= best_p:
                continue
            if tuple(ids[:p_eff]) == toks[:p_eff]:
                best, best_p = ent, p_eff
        if best is not None:
            self.tick += 1
            best["tick"] = self.tick
            return best, best_p
        return None

    def store(self, ids: Sequence[int], kv, adapter_ix: int = 0) -> None:
        key = (tuple(ids), adapter_ix)
        if key in self._entries or self.max_bytes <= 0:
            return
        nb = self._nbytes(kv)
        if nb > self.max_bytes:
            return
        while self.bytes + nb > self.max_bytes and self._entries:
            victim = min(self._entries, key=lambda k: self._entries[k]["tick"])
            self.bytes -= self._entries.pop(victim)["bytes"]
        self.tick += 1
        self._entries[key] = {"kv": kv, "bytes": nb, "tick": self.tick}
        self.bytes += nb

    def __len__(self) -> int:
        return len(self._entries)


class ContinuousEngine:
    """Slot-scheduled generation over a causal or seq2seq LM
    (continuous.py:162).

    ``model`` (a CausalLM or an encoder-decoder on ``device``) and ``cfg``
    its configuration; ``total`` cache columns per slot; prompts are
    right-padded to the smallest bucket that fits, so a causal request's
    headroom is ``total - len(prompt)``, a seq2seq one's ``total - 1``.  Sampling knobs are engine defaults, overridable per
    request in :meth:`submit`; greedy by default.  ``adapters`` {name:
    adapter tree} (LoRA fine-tunes of this base, made under
    ``lora_config``, default ``LoraConfig()``) are served by name.
    ``device`` defaults to the card (a missing GPU raises); tests pass
    ``"cpu"``."""

    def __init__(
        self,
        model,
        cfg,
        *,
        n_slots: int = 8,
        total: Optional[int] = None,
        chunk_steps: int = 16,
        buckets: Optional[Sequence[int]] = None,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        default_max_new: int = 128,
        adapters=None,
        lora_config=None,
        prefix_cache_mb: float = 0.0,
        min_cached_prompt: int = 16,
        speculative: str = "ngram",
        draft_tokens: int = 8,
        draft_ngram: int = 3,
        spec_steps: int = 4,
        kv_dtype: str = "bf16",
        prefill_chunk: int = 0,
        bos_id: int = 0,
        device="cuda",
    ):
        if cfg.arch not in ("causal", "seq2seq"):
            raise ValueError(f"ContinuousEngine serves causal or seq2seq LMs, got arch={cfg.arch!r}")
        self._s2s = cfg.arch == "seq2seq"
        if self._s2s:
            # the prompt never enters the decoder cache (no prefix reuse or
            # piecewise prefill of it) and drafting reads the causal stream
            unsupported = [name for name, on in (
                ("adapters (multi-LoRA)", bool(adapters)), ("prefix_cache_mb", prefix_cache_mb > 0),
                ("prefill_chunk", bool(prefill_chunk)), ("kv_dtype", kv_dtype != "bf16")) if on]
            if unsupported:
                raise ValueError("seq2seq continuous serving does not support: " + ", ".join(unsupported))
            speculative = "off"
        if model.device.type != resolve_device(device).type:
            raise ValueError(f"the model is on {model.device}, the engine on {device}")
        self.device = model.device
        self.model = model
        self.cfg = cfg
        self.bos_id = int(bos_id)
        self.total = int(total or min(cfg.max_seq_len, 1024))
        if self.total > cfg.max_seq_len:
            raise ValueError(f"total={self.total} exceeds cfg.max_seq_len={cfg.max_seq_len}")
        if buckets is None:
            buckets, b = [], 32
            while b <= self.total // 2:
                buckets.append(b)
                b *= 2
            if not buckets:
                buckets = [max(self.total // 2, 1)]
        self.buckets = sorted(int(b) for b in buckets)
        # seq2seq buckets size the encoder side, independent of the decoder cache
        if not self._s2s and self.buckets[-1] >= self.total:
            raise ValueError(f"largest bucket {self.buckets[-1]} leaves no decode room in total={self.total}")
        self.n_slots = int(n_slots)
        self.chunk_steps = int(chunk_steps)
        self.eos_id = eos_id
        self.sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        _validate_sampling(temperature, top_k, top_p)
        self.default_max_new = int(default_max_new)
        # the bank of every adapter, index 0 the zero adapter (the base)
        self._bank = None
        self._adapter_idx: dict[str, int] = {}
        if adapters:
            names = list(adapters)
            self._bank = place_bank(model, stack_adapters([adapters[n] for n in names], lora_config or LoraConfig()))
            self._adapter_idx = {n: i + 1 for i, n in enumerate(names)}
        if speculative not in ("off", "none", "ngram"):
            raise ValueError(f"speculative must be off|ngram, got {speculative!r}")
        self.speculative = speculative == "ngram"
        self.draft_tokens = int(draft_tokens)
        self.draft_ngram = int(draft_ngram)
        self.spec_steps = int(spec_steps)
        self._pcache = _PrefixCache(int(prefix_cache_mb * (1 << 20))) if prefix_cache_mb > 0 else None
        self.min_cached_prompt = int(min_cached_prompt)
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
        self.kv_dtype = kv_dtype
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk and self._bucket(min(self.prefill_chunk, self.buckets[-1])) != self.prefill_chunk:
            raise ValueError(f"prefill_chunk must be one of the prompt buckets {self.buckets}, got {prefill_chunk}")
        self._mid = None  # the in-flight chunked prefill (one at a time)
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._chunk_idx = 0  # ordinal of the next decode chunk
        self._state = self._fresh_state()
        self._by_slot: dict[int, _Request] = {}
        self._free = deque(range(self.n_slots))
        self._pending: deque[_Request] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.stats = {
            "requests": 0, "completed": 0, "tokens": 0,
            "chunks": 0, "occupancy_sum": 0, "prefills": 0,
            "prefix_hits": 0, "prefix_tokens_reused": 0,
            "spec_chunks": 0, "drafted_accepted": 0,
            "prefill_pieces": 0,
        }
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- public API ----------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: Optional[int] = None,
               stream: Optional[Callable[[int], None]] = None, *, temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None, adapter: Optional[str] = None) -> Future:
        """Queue a prompt; the Future resolves to ``{"ids": [generated...],
        "n_prompt": int}`` (generated ids only, the first eos included when
        hit).  ``temperature`` / ``top_k`` / ``top_p`` override the engine's
        defaults for this request; ``adapter`` names one of the engine's
        adapters (None: the base model); ``stream`` receives each token as
        its chunk is harvested."""
        s = self.sampling
        temperature = s["temperature"] if temperature is None else temperature
        top_k = s["top_k"] if top_k is None else top_k
        top_p = s["top_p"] if top_p is None else top_p
        _validate_sampling(temperature, top_k, top_p)
        adapter_ix = 0
        if adapter is not None:
            if adapter not in self._adapter_idx:
                raise ValueError(f"unknown adapter {adapter!r}; available: "
                                 f"{sorted(self._adapter_idx) or '(none configured)'}")
            adapter_ix = self._adapter_idx[adapter]
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("empty prompt")
        if len(ids) > self.buckets[-1]:
            raise ValueError(f"prompt of {len(ids)} tokens exceeds the largest bucket ({self.buckets[-1]}); raise "
                             "total/buckets or chunk the prompt")
        max_new = int(self.default_max_new if max_new_tokens is None else max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        req = _Request(ids=ids, max_new=max_new, future=Future(), stream=stream, temperature=float(temperature),
                       top_k=int(top_k), top_p=float(top_p), adapter_ix=adapter_ix)
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is closed")
            self._pending.append(req)
            self.stats["requests"] += 1
        self._wake.set()
        return req.future

    def close(self) -> None:
        with self._lock:
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=30.0)
        with self._lock:
            failed = list(self._pending) + list(self._by_slot.values())
            if self._mid is not None:
                failed.append(self._mid["req"])
                self._mid = None
            self._pending.clear()
            self._by_slot.clear()
        for req in failed:
            if not req.future.done():
                req.future.set_exception(RuntimeError("engine closed"))

    # ---- scheduler loop --------------------------------------------------

    def _loop(self) -> None:
        # inference mode is per thread: enter it on the scheduler's own
        with torch.inference_mode():
            self._run()

    def _run(self) -> None:
        # one-chunk-deep pipeline: `prev` is the not-yet-read output of the
        # last dispatched chunk, read after the next one is dispatched
        prev = None
        while True:
            with self._lock:
                if self._stop:
                    return
                busy = bool(self._by_slot) or bool(self._pending) or self._mid is not None
            try:
                if not busy:
                    if prev is not None:
                        self._harvest(*prev)
                        prev = None
                        continue  # the harvest may have freed work to do
                    with tracing.span("engine.wait"):
                        self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                self._admit()
                cur = None
                if self._by_slot:
                    cur = (self._chunk_idx, self._dispatch_chunk())
                if prev is not None:
                    self._harvest(*prev)
                prev = cur
            except Exception as exc:  # noqa: BLE001 — fail the owners, keep serving
                prev = None
                with self._lock:
                    doomed = list(self._by_slot.values()) + list(self._pending)
                    if self._mid is not None:
                        doomed.append(self._mid["req"])
                        self._mid = None
                    self._by_slot.clear()
                    self._pending.clear()
                    self._free = deque(range(self.n_slots))
                for req in doomed:
                    if not req.future.done():
                        req.future.set_exception(exc)
                # a step that failed half way leaves the state inconsistent
                self._state = None
                self._state = self._fresh_state()

    def _fresh_state(self):
        if self._s2s:
            return de.make_decode_state_seq2seq(self.cfg, self.n_slots, self.total, self.buckets[-1],
                                                device=self.device, model=self.model)
        return de.make_decode_state(self.cfg, self.n_slots, self.total, kv_dtype=self.kv_dtype, device=self.device,
                                    model=self.model)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError("submit() validated the length")

    def _admit(self) -> None:
        with tracing.span("engine.admit") as sp:
            sp.set(admitted=self._admit_pending())

    def _admit_pending(self) -> int:
        """Give queued requests free slots and prefill them; returns how
        many were popped."""
        popped = 0
        while True:
            if self.prefill_chunk and self._mid is not None:
                # one piece of the in-flight chunked prefill, then a decode chunk
                self._advance_prefill()
                return popped
            with self._lock:
                if not self._pending or not self._free:
                    return popped
                req = self._pending.popleft()
                slot = self._free.popleft()
            req.t_pop = time.time_ns()
            tracing.record("engine.queue", req.t_submit, req.t_pop, rid=req.rid, prompt=len(req.ids))
            popped += 1
            samp = (req.temperature, req.top_k, req.top_p)
            if self._s2s:
                self._admit_s2s(req, slot, samp)
                continue
            if self.prefill_chunk and len(req.ids) > self.prefill_chunk:
                self._mid = {"req": req, "slot": slot, "samp": samp, "kv": None, "done": 0}
                continue  # its first piece runs in the branch above
            kv, first, n_prompt, ids, mask = self._run_prefill(req, samp)
            self._install(req, slot, kv, first, n_prompt, ids, mask, samp)

    def _admit_s2s(self, req: _Request, slot: int, samp) -> None:
        """Encode the prompt at its bucket and insert it with its BOS step
        (continuous.py:516-565)."""
        ids, mask = self._piece(req.ids, self._bucket(len(req.ids)))
        ckv, dec_kv, first = de.prefill_seq2seq(self.model, ids, mask, self._generator, *samp,
                                                sampled=req.temperature > 0, bos_id=self.bos_id)
        self.stats["prefills"] += 1
        req.pending_first = _Fetch(first)
        req.start_chunk = self._chunk_idx
        # BOS holds column 0; generated tokens fill 1..total-1
        req.remaining = min(req.max_new - 1, self.total - 1)
        de.insert_seq2seq(self._state, ckv, self._piece(req.ids, self.buckets[-1])[1], dec_kv, first, slot, *samp)
        with self._lock:
            self._by_slot[slot] = req
        self._installed(req, ids.shape[1])

    def _install(self, req, slot, kv, first, n_prompt, ids, mask, samp) -> None:
        """Insert a fully prefilled request into its reserved slot."""
        # the first token travels to the host while decoding goes on; the
        # request's first harvest reads it
        req.pending_first = _Fetch(first)
        req.start_chunk = self._chunk_idx
        # decode headroom: each emitted token takes one cache column
        req.remaining = min(req.max_new - 1, self.total - len(req.ids))
        de.insert(self._state, kv, ids, mask, first, n_prompt, slot, *samp, adapter=self._aix(req))
        with self._lock:
            self._by_slot[slot] = req
        self._installed(req, ids.shape[1])

    @staticmethod
    def _installed(req: _Request, bucket: int) -> None:
        """Close the request's ``engine.prefill`` span; its ``engine.first``
        starts here."""
        req.t_install = time.time_ns()
        tracing.record("engine.prefill", req.t_pop, req.t_install, rid=req.rid, bucket=bucket, reused=req.reused)

    def _aix(self, req: _Request):
        """The request's bank index for the decode functions (None without a bank)."""
        return None if self._bank is None else [req.adapter_ix]

    def _piece(self, ids: Sequence[int], width: int):
        """(1, width) right-padded ids and mask of ``ids``."""
        out = np.zeros((1, width), np.int32)
        out[0, : len(ids)] = ids
        return out, (np.arange(width) < len(ids))[None].astype(np.int32)

    def _advance_prefill(self) -> None:
        """One <= prefill_chunk-token piece of the in-flight chunked prefill
        (continuous.py:585): :func:`prefill` for the head, ``prefill_extend``
        at the running cursor after it.  Only the last piece's first token
        is kept: it comes from the whole prompt's final logits."""
        m = self._mid
        req = m["req"]
        n = len(req.ids)
        if m["kv"] is None and self._pcache is not None:
            hit = self._pcache.lookup(req.ids, req.adapter_ix)
            if hit is not None:
                ent, p = hit
                m["kv"] = de.crop_kv(ent["kv"], self._bucket(p))
                m["done"] = req.reused = p
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += p
        take = min(self.prefill_chunk, n - m["done"])
        piece_ids, piece_mask = self._piece(req.ids[m["done"]: m["done"] + take], self._bucket(take))
        sampled = req.temperature > 0
        if m["kv"] is None:
            kv, first, n_done = de.prefill(self.model, piece_ids, piece_mask, self._generator, *m["samp"],
                                           kv_dtype=self.kv_dtype, sampled=sampled, bank=self._bank,
                                           adapter=self._aix(req))
            self.stats["prefills"] += 1
        else:
            kv, first, n_done = de.prefill_extend(self.model, m["kv"], [m["done"]], piece_ids, piece_mask,
                                                  self._generator, *m["samp"], sampled=sampled, bank=self._bank,
                                                  adapter=self._aix(req))
        m["done"] += take
        self.stats["prefill_pieces"] += 1
        m["kv"] = de.crop_kv(kv, self._bucket(m["done"]))
        if m["done"] < n:
            return  # the next piece on the next scheduler turn
        ids, mask = self._piece(req.ids, self._bucket(n))
        self._store_kv(req, m["kv"])
        self._mid = None
        self._install(req, m["slot"], m["kv"], first, n_done, ids, mask, m["samp"])

    def _run_prefill(self, req: _Request, samp):
        """Prefill a request: through the prefix cache when a stored prompt
        KV is a strict prefix of this one, else cold (continuous.py:641).
        Returns ``(kv, first_tok, n_prompt, ids, mask)`` for insert; cold
        and extended results are stored back, at a bucket width."""
        n = len(req.ids)
        b = self._bucket(n)
        sampled = req.temperature > 0
        hit = self._pcache.lookup(req.ids, req.adapter_ix) if self._pcache is not None else None
        if hit is not None:
            ent, p = hit
            req.reused = p
            sfx_ids, sfx_mask = self._piece(req.ids[p:], self._bucket(n - p))
            kv, first, n_total = de.prefill_extend(self.model, ent["kv"], [p], sfx_ids, sfx_mask, self._generator,
                                                   *samp, sampled=sampled, bank=self._bank, adapter=self._aix(req))
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += p
            # back to the bucket grid: only bucket widths reach the slots
            kv = de.crop_kv(kv, b)
            ids, mask = self._piece(req.ids, b)
            self._store_kv(req, kv)
            return kv, first, n_total, ids, mask
        ids, mask = self._piece(req.ids, b)
        kv, first, n_prompt = de.prefill(self.model, ids, mask, self._generator, *samp, kv_dtype=self.kv_dtype,
                                         sampled=sampled, bank=self._bank, adapter=self._aix(req))
        self.stats["prefills"] += 1
        self._store_kv(req, kv)
        return kv, first, n_prompt, ids, mask

    def _store_kv(self, req: _Request, kv) -> None:
        """Keep a prompt's KV (at its bucket width) for later prompts."""
        if self._pcache is None or len(req.ids) < self.min_cached_prompt:
            return
        b = self._bucket(len(req.ids))
        if kv[0]["k"].shape[1] != b:
            kv = de.crop_kv(kv, b)
        self._pcache.store(req.ids, kv, req.adapter_ix)

    def _dispatch_chunk(self):
        """Enqueue one decode chunk and start its tokens' copy to the host.
        Speculative chunks run while every request is greedy; one sampled
        request sends the whole batch to plain chunks (continuous.py:707)."""
        self._chunk_idx += 1
        self.stats["chunks"] += 1
        self.stats["occupancy_sum"] += len(self._by_slot)
        sampled = any(r.temperature > 0.0 for r in self._by_slot.values())
        if self._s2s:
            toks = de.decode_chunk_seq2seq(self.model, self._state, self._generator, n_steps=self.chunk_steps,
                                           eos_id=self.eos_id, sampled=sampled)
            return "plain", _Fetch(toks)
        if self.speculative and not sampled:
            self.stats["spec_chunks"] += 1
            vals, counts = de.decode_chunk_spec(self.model, self._state, n_steps=self.spec_steps, eos_id=self.eos_id,
                                                gamma=self.draft_tokens, ngram=self.draft_ngram, bank=self._bank)
            return "spec", _Fetch(vals, counts)
        toks = de.decode_chunk(self.model, self._state, self._generator, n_steps=self.chunk_steps,
                               eos_id=self.eos_id, sampled=sampled, bank=self._bank)
        return "plain", _Fetch(toks)

    def _harvest(self, chunk_idx: int, payload) -> None:
        with tracing.span("engine.harvest") as sp:
            sp.set(tokens=self._route(chunk_idx, payload))

    def _route(self, chunk_idx: int, payload) -> int:
        """Read a dispatched chunk's tokens and route them to requests
        (continuous.py:749); returns how many were handed on.  A slot's row
        belongs to its current request only from ``start_chunk`` on; a
        request's first token is emitted before its first harvested row.
        Finished slots are freed on the host only: the next insert rewrites
        the row."""
        kind, fetch = payload
        with tracing.span("engine.fetch"):
            got = fetch.get()
        routed = 0
        if kind == "spec":
            vals, counts = got  # (S, steps, gamma+1), (S, steps)
            per_slot = {s: [int(t) for j in range(counts.shape[1]) for t in vals[s, j, : counts[s, j]]]
                        for s in self._by_slot}
            for s in self._by_slot:
                self.stats["drafted_accepted"] += int(np.maximum(counts[s] - 1, 0).sum())
        else:
            (toks_np,) = got  # (S, chunk_steps)
            per_slot = {s: [int(t) for t in toks_np[s]] for s in self._by_slot}
        finished: list[int] = []
        for slot, req in list(self._by_slot.items()):
            if req.start_chunk > chunk_idx:
                continue  # dispatched before this request was inserted
            if req.pending_first is not None:
                first = int(req.pending_first.get()[0][0])
                req.pending_first = None
                req.out.append(first)
                self.stats["tokens"] += 1
                routed += 1
                tracing.record("engine.first", req.t_install, time.time_ns(), rid=req.rid)
                self._emit(req, first)
                if (self.eos_id is not None and first == self.eos_id) or req.remaining <= 0:
                    finished.append(slot)
                    continue
            for tok in per_slot[slot]:
                req.out.append(tok)
                req.remaining -= 1
                self.stats["tokens"] += 1
                routed += 1
                self._emit(req, tok)
                if (self.eos_id is not None and tok == self.eos_id) or req.remaining <= 0:
                    finished.append(slot)
                    break
        for slot in finished:
            req = self._by_slot.pop(slot)
            self._finish(req)
            with self._lock:
                self._free.append(slot)
        return routed

    @staticmethod
    def _emit(req: _Request, tok: int) -> None:
        """Deliver one token to a request's stream callback.  A raising
        callback fails only its own consumer: it is disabled, and the
        scheduler goes on."""
        if req.stream is None:
            return
        try:
            req.stream(tok)
        except Exception:  # noqa: BLE001 — user callback, not our state
            req.stream = None

    def _finish(self, req: _Request) -> None:
        self.stats["completed"] += 1
        if not req.future.done():
            req.future.set_result({"ids": list(req.out), "n_prompt": len(req.ids)})

    # ---- conveniences ----------------------------------------------------

    @property
    def adapter_names(self) -> list[str]:
        """The adapters /generate may name."""
        return sorted(self._adapter_idx)

    def generate_ids(self, prompt_ids: Sequence[int], max_new_tokens: Optional[int] = None,
                     timeout: float = 300.0) -> list[int]:
        """Blocking single-request helper (tests / simple callers)."""
        return self.submit(prompt_ids, max_new_tokens).result(timeout=timeout)["ids"]

    def snapshot_stats(self) -> dict:
        with self._lock:
            s = dict(self.stats)
            s["active_slots"] = len(self._by_slot)
            s["pending"] = len(self._pending)
        if s["chunks"]:
            s["avg_occupancy"] = round(s["occupancy_sum"] / s["chunks"], 2)
        if self._pcache is not None:
            s["prefix_cache"] = {"entries": len(self._pcache), "mb": round(self._pcache.bytes / (1 << 20), 1)}
        return s
