"""Slot-based continuous-batching decode state: prefill, insert, decode.

Counterpart of ``vietnamese_qa_system_tpu/models/decode_engine.py``: a
decode state of ``n_slots`` independent sequences sharing one static-shape
KV cache, driven by the host scheduler in engine/continuous.py.

- :func:`prefill` runs a right-padded prompt at a bucket width and returns
  its KV prefix and first token; :func:`prefill_extend` runs only the
  suffix of a prompt whose prefix KV is known (the prefix cache, chunked
  prefill); :func:`crop_kv` normalizes a prefix to a bucket width.
- :func:`insert` installs a prefilled request into a free slot, and
  :func:`release` frees one.
- :func:`decode_chunk` advances every slot ``n_steps`` tokens;
  :func:`decode_chunk_spec` runs greedy prompt-lookup speculation per slot.

Multi-LoRA serving: with an adapter ``bank`` (models/lora.py
``stack_adapters``, or ``place_bank``'s layout of it) every function runs
each row under its own adapter, the state's ``adapter`` column (bank
index, 0 the base model) in the decode chunks.  A chunk gathers the
bank's per-row factors once, on the device, from that column: the host
reads nothing back for it.  On a tensor-parallel reader each split part
gathers its slice of the factors on its own device.

The JAX functions return a new state; these update the state's tensors in
place (one device) and return only their outputs.  Per-slot progress lives
in per-row cursors and a per-slot ``key_valid`` mask, so every step of a
chunk has the same shapes and no step reads a value back to the host.

Writes that JAX drops as out of bounds (a done row's cursor at ``total``,
a speculative window past the cache end) must never land in a column a
query attends.  The state's KV buffers are therefore ``total + 1`` columns
wide: the attention clamps per-row slots to the last one (the guard
column), and every mask covers only the first ``total``.  The (B, total)
``toks`` and ``key_valid`` updates select by column, so an out-of-bounds
column matches nothing.

Sampling draws from an explicit ``torch.Generator`` on the state's device:
the same distributions as the JAX package, other random numbers.

The seq2seq half (:622-835): :func:`make_decode_state_seq2seq` adds to
each slot the bf16 cross-attention K/V of its own encoder input, padded to
the largest encoder bucket, and its encoder mask (a tensor-parallel
reader's decoder cache and cross K/V are one dict a (layer, device),
each over the device's heads);
:func:`prefill_seq2seq` encodes a prompt at its bucket and runs the BOS
step; :func:`insert_seq2seq`, :func:`decode_chunk_seq2seq` and
:func:`release_seq2seq` follow the causal ones.  The decoder stream holds
no prompt (slot column 0 is BOS), so a slot's cursor is its position.  A
T5 decoder's relative bias of per-slot cursors is gathered on the device
(models/t5.py ``decoder_bias``) over the mask's ``total`` columns, so a
chunk reads nothing back either.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import tracing
from ..core.device import resolve_device
from .causal_lm import CausalLM, make_cache
from .generate import NEG_INF, _ngram_draft, _sample_logits
from .layers import row_adapters
from .lora import select_adapters

# per-request top_k is clamped to this (decode_engine.py:53)
TOPK_CAP = 64
TOPP_ITERS = 26  # bisection halvings of the nucleus threshold, as _top_p_mask


def _sample_dynamic(logits, generator, temp, top_k, top_p, sampled: bool):
    """Per-row temperature / top-k / nucleus sampling over (B, V)
    (decode_engine.py:56): ``temp`` (B,) f32, 0 = greedy; ``top_k`` (B,)
    int, 0 = off, clamped to :data:`TOPK_CAP`; ``top_p`` (B,) f32, 1 = off.

    ``sampled`` False says that no row samples and takes the argmax alone:
    the caller knows its rows' temperatures on the host, so ``temp`` is
    never read back.  The top-k and top-p stages apply when any row asks
    for them, as JAX's ``lax.cond`` does, selected on the device."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    b, v = logits.shape
    proc = logits / temp.clamp_min(1e-6)[:, None]
    kcap = min(TOPK_CAP, v)
    vals = torch.topk(proc, kcap, dim=-1).values
    kth = vals.gather(1, (top_k.clamp(1, kcap) - 1).long()[:, None])
    cut = torch.where((top_k[:, None] > 0) & (proc < kth), NEG_INF, proc)
    proc = torch.where((top_k > 0).any(), cut, proc)
    p = torch.softmax(proc, dim=-1)
    lo = torch.zeros((b, 1), dtype=p.dtype, device=p.device)
    hi = p.amax(dim=-1, keepdim=True)
    for _ in range(TOPP_ITERS):
        mid = 0.5 * (lo + hi)
        ok = torch.where(p >= mid, p, 0.0).sum(dim=-1, keepdim=True) >= top_p[:, None]
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    proc = torch.where((top_p < 1.0).any(), torch.where(p >= lo, proc, NEG_INF), proc)
    # temperature 1 on the processed logits: Gumbel-max, like jax.random.categorical
    drawn = _sample_logits(proc, generator, temperature=1.0, top_k=0, top_p=1.0)
    return torch.where(temp > 0.0, drawn, greedy)


def make_decode_state(cfg, n_slots: int, total: int, *, kv_dtype: str = "bf16", device="cuda", model=None) -> dict:
    """A fresh all-slots-free decode state (decode_engine.py:117): the
    fields of the JAX state with its shapes, on ``device``, except that
    each cache buffer has ``total + 1`` columns (the guard column, see the
    module docstring).  ``total`` must not exceed ``cfg.max_seq_len``.
    ``model`` makes the cache (a tensor-parallel reader's lives on its
    devices); without one it is the unsharded layout on ``device``."""
    if total > cfg.max_seq_len:
        raise ValueError(f"total={total} exceeds cfg.max_seq_len={cfg.max_seq_len}")

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "cache": (make_cache(cfg, n_slots, total + 1, device, kv_dtype) if model is None
                  else model.make_cache(n_slots, total + 1, kv_dtype)),
        "key_valid": zeros((n_slots, total), torch.bool),
        "last_tok": zeros((n_slots,), torch.int32),
        "pos": zeros((n_slots,), torch.int32),
        "cursor": zeros((n_slots,), torch.int32),
        "active": zeros((n_slots,), torch.bool),
        "done": torch.ones((n_slots,), dtype=torch.bool, device=device),
        "temp": zeros((n_slots,), torch.float32),
        "top_k": zeros((n_slots,), torch.int32),
        "top_p": torch.ones((n_slots,), dtype=torch.float32, device=device),
        # each slot's index into the LoRA bank (0 = the base model; read
        # only when a bank is passed)
        "adapter": zeros((n_slots,), torch.int32),
        # decided tokens by position; toks[s, cursor[s]] == last_tok[s]
        "toks": zeros((n_slots, total), torch.int32),
    }


def state_from_numpy(jstate: dict, device="cuda") -> dict:
    """A JAX decode state (numpy leaves; its cache a list of per-layer
    dicts or scan-stacked with a leading layer axis) -> the port's on
    ``device``, with the guard column appended to every cache buffer (the
    state counterpart of models/params.py ``causal_from_jax``)."""
    device = resolve_device(device)
    cache = jstate["cache"]
    if isinstance(cache, dict):
        cache = [{name: leaf[i] for name, leaf in cache.items()} for i in range(len(cache["k"]))]
    out = {name: torch.from_numpy(np.array(leaf)).to(device) for name, leaf in jstate.items() if name != "cache"}
    out["cache"] = []
    for layer in cache:
        bufs = {}
        for name, leaf in layer.items():
            leaf = np.asarray(leaf)
            if leaf.dtype.name == "bfloat16":  # numpy has no bf16: through f32, exactly
                leaf = torch.from_numpy(leaf.astype(np.float32)).to(torch.bfloat16)
            else:
                leaf = torch.from_numpy(np.array(leaf))
            guard = torch.zeros((leaf.shape[0], 1) + tuple(leaf.shape[2:]), dtype=leaf.dtype)
            bufs[name] = torch.cat([leaf, guard], dim=1).to(device)
        out["cache"].append(bufs)
    return out


def _on(device, x, dtype):
    """``x`` (a number, list, array or tensor) as a ``dtype`` tensor on
    ``device``, copied from the host without waiting for the device (a
    blocking copy would stall the scheduler behind the chunk in flight)."""
    return torch.as_tensor(x, dtype=dtype).to(device, non_blocking=True)


def _sampling(temp, top_k, top_p, device):
    return (_on(device, temp, torch.float32).reshape(-1), _on(device, top_k, torch.int32).reshape(-1),
            _on(device, top_p, torch.float32).reshape(-1))


def _adapters(model: CausalLM, bank, idx):
    """The context that runs ``model``'s rows under the bank's adapters at
    ``idx`` (a (B,) device tensor, or host values), or nothing without a
    bank."""
    if bank is None:
        return contextlib.nullcontext()
    if not isinstance(idx, torch.Tensor):
        idx = _on(model.device, idx, torch.long).reshape(-1)
    return row_adapters(select_adapters(model, bank, idx.long()))


def _last_logits(model: CausalLM, h, n_valid):
    """Logits at each row's last real position (n_valid - 1)."""
    idx = (n_valid.long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
    return model.head(h.gather(1, idx)[:, 0])


@torch.inference_mode()
def prefill(model: CausalLM, ids, attn_mask, generator, temp, top_k, top_p, *, sampled: bool,
            kv_dtype: str = "bf16", bank=None, adapter=None):
    """Run RIGHT-padded prompts (B, T) and sample their first tokens
    (decode_engine.py:162).  Right padding puts every token's cache slot
    at its position, which prefix reuse and the slot-space families
    (ALiBi, local windows) need.  Returns ``(kv, first_tok (B,),
    n_prompt (B,))``: ``kv`` the per-layer prompt KV of width T for
    :func:`insert`.  ``sampled`` as in :func:`_sample_dynamic`; ``bank``
    and ``adapter`` (B,) run each prompt under its bank adapter."""
    dev = model.device
    ids = _on(dev, ids, torch.long)
    attn_mask = _on(dev, attn_mask, torch.int32)
    b, t = ids.shape
    positions = (torch.cumsum(attn_mask, dim=1) - 1).clamp_min(0).long()
    cache = model.make_cache(b, t, kv_dtype)
    j = torch.arange(t, device=dev)
    mask = (j[None, None, :] <= j[None, :, None]) & attn_mask[:, None, :].bool()
    n_prompt = attn_mask.sum(dim=1).to(torch.int32)
    with _adapters(model, bank, adapter):
        h = model.hidden_states(ids, mask, positions=positions, cache=cache, cache_index=0)
        last = _last_logits(model, h, n_prompt)
    first = _sample_dynamic(last, generator, *_sampling(temp, top_k, top_p, dev), sampled=sampled)
    return cache, first, n_prompt


@torch.inference_mode()
def prefill_extend(model: CausalLM, prefix_kv, prefix_len, ids, attn_mask, generator, temp, top_k, top_p, *,
                   sampled: bool, bank=None, adapter=None):
    """Prefill only the SUFFIX (1, S) of a prompt whose first
    ``prefix_len`` (1,) tokens have KV in ``prefix_kv`` (width P, a bucket;
    decode_engine.py:221).  The suffix is written at the per-row cursor
    ``prefix_len``, so the result stays hole-free.  Returns ``(kv of width
    P + S, first_tok, n_total)``.  ``bank`` / ``adapter`` as in :func:`prefill`."""
    dev = model.device
    ids = _on(dev, ids, torch.long)
    attn_mask = _on(dev, attn_mask, torch.int32)
    p = _on(dev, prefix_len, torch.int32).reshape(-1)
    b, s = ids.shape
    cache = [{name: torch.cat([leaf, leaf.new_zeros((leaf.shape[0], s) + leaf.shape[2:])], dim=1)
              for name, leaf in layer.items()} for layer in prefix_kv]
    w = cache[0]["k"].shape[1]
    n_sfx = attn_mask.sum(dim=1).to(torch.int32)
    positions = (p[:, None] + (torch.cumsum(attn_mask, dim=1) - 1).clamp_min(0)).long()
    # causal across the boundary: suffix query q sees slots <= p + q
    mask = (torch.arange(w, device=dev)[None, None, :]
            <= (p[:, None, None] + torch.arange(s, device=dev)[None, :, None]))
    with _adapters(model, bank, adapter):
        h = model.hidden_states(ids, mask, positions=positions, cache=cache, cache_index=p)
        last = _last_logits(model, h, n_sfx)
    first = _sample_dynamic(last, generator, *_sampling(temp, top_k, top_p, dev), sampled=sampled)
    return cache, first, p + n_sfx


def crop_kv(kv, width: int):
    """Crop or zero-pad a prefill KV to ``width`` columns (decode_engine.py:291)."""
    out = []
    for layer in kv:
        fixed = {}
        for name, leaf in layer.items():
            have = leaf.shape[1]
            fixed[name] = leaf[:, :width] if have >= width else torch.cat(
                [leaf, leaf.new_zeros((leaf.shape[0], width - have) + leaf.shape[2:])], dim=1)
        out.append(fixed)
    return out


@torch.inference_mode()
def insert(state: dict, kv, ids, attn_mask, first_tok, n_prompt, slot: int, temp, top_k, top_p,
           adapter=None) -> None:
    """Install a prefilled B=1 request into slot ``slot``
    (decode_engine.py:322): its prompt KV at columns [0, T), its key mask,
    cursor and position at the true prompt length, its sampling knobs, and
    its prompt and pending first token in ``toks``.  Every field of the row
    is rewritten, so nothing of the previous occupant stays reachable.
    ``first_tok`` and ``n_prompt`` stay on the device; ``adapter`` (1,) is
    the request's bank index (the column keeps its value without one)."""
    dev = state["toks"].device
    ids = _on(dev, ids, torch.int32)
    attn_mask = _on(dev, attn_mask, torch.int32)
    t = attn_mask.shape[1]
    for layer, prefix in zip(state["cache"], kv):
        for name, leaf in layer.items():
            leaf[slot, :t] = prefix[name][0].to(leaf.dtype)
    state["key_valid"][slot] = False
    state["key_valid"][slot, :t] = attn_mask[0].bool()
    n = n_prompt.reshape(1).to(torch.int32)
    state["last_tok"][slot] = first_tok.reshape(())
    state["pos"][slot] = n.reshape(())
    state["cursor"][slot] = n.reshape(())
    state["active"][slot] = True
    state["done"][slot] = False
    for name, val in zip(("temp", "top_k", "top_p"), _sampling(temp, top_k, top_p, dev)):
        state[name][slot] = val.reshape(())
    if adapter is not None:
        state["adapter"][slot] = _on(dev, adapter, torch.int32).reshape(())
    row = state["toks"][slot]
    row.zero_()
    row[:t] = ids[0] * attn_mask[0].to(torch.int32)
    row.scatter_(0, n.long(), first_tok.reshape(1).to(torch.int32))


@torch.inference_mode()
def release(state: dict, slot: int) -> None:
    """Free slot ``slot``: nothing in it can be attended afterwards."""
    state["key_valid"][slot] = False
    state["active"][slot] = False
    state["done"][slot] = True


def _set_columns(buf, cols, vals, ok):
    """``buf[b, cols[b, j]] = vals[b, j]`` where ``ok[b, j]``, for (B, W)
    ``cols``; a column outside [0, buf.shape[1]) matches nothing (JAX drops
    such scatters).  The written columns of a row must be distinct."""
    hit = (torch.arange(buf.shape[1], device=buf.device)[None, None, :] == cols[:, :, None]) & ok[:, :, None]
    written = (hit * vals[:, :, None].to(buf.dtype)).sum(dim=1).to(buf.dtype)
    return torch.where(hit.any(dim=1), written, buf)


@torch.inference_mode()
def decode_chunk(model: CausalLM, state: dict, generator, *, sampled: bool, n_steps: int = 8,
                 eos_id: int | None = None, bank=None):
    """Advance every live slot ``n_steps`` tokens (decode_engine.py:405).
    Returns the (n_slots, n_steps) int32 tokens emitted, on the device;
    emissions after a slot's eos, and from free slots, are eos (0 when
    ``eos_id`` is None).  ``sampled`` as in :func:`_sample_dynamic`; with
    ``bank`` each slot decodes under the adapter of its ``adapter`` column.

    A row that must not advance (done, free, or at the cache end) still
    writes its token's K/V at ``cursor``: its ``key_valid`` bit stays down,
    or the write lands in the guard column."""
    st = state
    total = st["key_valid"].shape[1]
    fill = torch.full((), 0 if eos_id is None else eos_id, dtype=torch.int32, device=st["toks"].device)
    out = []
    with (tracing.span("engine.chunk", slots=st["cursor"].shape[0], steps=n_steps, spec=0),
          _adapters(model, bank, st["adapter"])):
        for _ in range(n_steps):
            out.append(_plain_step(model, st, generator, total, fill, eos_id, sampled))
    return torch.stack(out, dim=1)


def _plain_step(model, st, generator, total, fill, eos_id, sampled):
    """One step of :func:`decode_chunk`; returns the emitted (n_slots,) tokens."""
    write_ok = st["active"] & ~st["done"] & (st["cursor"] < total)
    st["key_valid"] = _set_columns(st["key_valid"], st["cursor"][:, None], write_ok[:, None], write_ok[:, None])
    h = model.hidden_states(st["last_tok"][:, None].long(), st["key_valid"][:, None, :],
                            positions=st["pos"][:, None].long(), cache=st["cache"], cache_index=st["cursor"])
    nxt = _sample_dynamic(model.head(h[:, 0]), generator, st["temp"], st["top_k"], st["top_p"], sampled)
    nxt = torch.where(write_ok, nxt, fill)
    done = st["done"] | ~st["active"] | (st["cursor"] + 1 >= total)
    if eos_id is not None:
        done = done | (nxt == eos_id)
    cursor = st["cursor"] + write_ok.to(torch.int32)
    st["toks"] = _set_columns(st["toks"], cursor[:, None], nxt[:, None], write_ok[:, None])
    st["last_tok"] = torch.where(write_ok, nxt, st["last_tok"])
    st["pos"] = st["pos"] + write_ok.to(torch.int32)
    st["cursor"] = cursor
    st["done"] = done
    return nxt


@torch.inference_mode()
def decode_chunk_spec(model: CausalLM, state: dict, *, n_steps: int = 4, eos_id: int | None = None,
                      gamma: int = 8, ngram: int = 3, bank=None):
    """Greedy speculative chunk (decode_engine.py:480): each of the
    ``n_steps`` iterations drafts ``gamma`` tokens per slot by n-gram
    lookup over the slot's own stream, verifies the window in one forward
    at the per-slot cursors, and accepts the longest holding prefix plus
    the model's bonus token.  Returns ``(vals (n_slots, n_steps,
    gamma + 1), counts (n_slots, n_steps))`` on the device: the host reads
    ``vals[s, j, :counts[s, j]]`` in order.  ``bank`` as in
    :func:`decode_chunk`."""
    st = state
    total = st["key_valid"].shape[1]
    dev = st["toks"].device
    jw = torch.arange(gamma + 1, device=dev)[None, :]
    jj = torch.arange(total, device=dev)[None, None, :]
    all_vals, all_counts = [], []
    with (tracing.span("engine.chunk", slots=st["cursor"].shape[0], steps=n_steps, spec=1),
          _adapters(model, bank, st["adapter"])):
        for _ in range(n_steps):
            vals, counts = _spec_step(model, st, total, jw, jj, gamma, ngram, eos_id)
            all_vals.append(vals)
            all_counts.append(counts)
    return torch.stack(all_vals, dim=1), torch.stack(all_counts, dim=1)


def _spec_step(model, st, total, jw, jj, gamma, ngram, eos_id):
    """One step of :func:`decode_chunk_spec`; returns its (n_slots, gamma + 1)
    values and (n_slots,) counts."""
    live = st["active"] & ~st["done"]
    cursor = st["cursor"]
    drafts = _ngram_draft(st["toks"], cursor + 1, torch.zeros_like(cursor), gamma, ngram)
    window = torch.cat([st["last_tok"][:, None], drafts.to(torch.int32)], dim=1)
    pos = (st["pos"][:, None] + jw).clamp_max(total - 1)
    win_ok = (jj >= cursor[:, None, None]) & (jj <= (cursor[:, None] + jw)[:, :, None])
    mask = st["key_valid"][:, None, :] | win_ok
    h = model.hidden_states(window.long(), mask, positions=pos.long(), cache=st["cache"], cache_index=cursor)
    y = torch.argmax(model.head(h), dim=-1).to(torch.int32)
    hold = torch.cumprod((y[:, :gamma] == window[:, 1:]).to(torch.int32), dim=1)
    a = hold.sum(dim=1)
    bonus = y.gather(1, a[:, None].long())[:, 0]
    drafts_pad = torch.cat([window[:, 1:], torch.zeros_like(window[:, :1])], dim=1)
    vals = torch.where(jw < a[:, None], drafts_pad, bonus[:, None])
    col = cursor[:, None] + 1 + jw
    # col == total may emit (as decode_chunk's last emission); its
    # toks / key_valid writes fall outside and done is forced below
    write_ok = (jw <= a[:, None]) & live[:, None] & (col <= total)
    if eos_id is not None:
        is_eos = (vals == eos_id).to(torch.int32)
        write_ok = write_ok & (torch.cumsum(is_eos, dim=1) - is_eos == 0)
    st["toks"] = _set_columns(st["toks"], col, vals, write_ok)
    # the pending token (window column 0) and the accepted drafts that
    # were produced have K/V now; the bonus is the next pending
    kv = _set_columns(st["key_valid"], cursor[:, None], live[:, None], (live & (cursor < total))[:, None])
    st["key_valid"] = _set_columns(kv, col, torch.ones_like(write_ok), write_ok & (jw < a[:, None]))
    n_written = write_ok.sum(dim=1).to(torch.int32)
    new_cursor = cursor + n_written
    last = vals.gather(1, (n_written - 1).clamp_min(0)[:, None].long())[:, 0]
    st["last_tok"] = torch.where(n_written > 0, last, st["last_tok"])
    # done once the cursor reaches the cache end, as decode_chunk's
    # rule reads after its increment.  JAX's `new_cursor + 1 >= total`
    # (decode_engine.py:585) stops one emission short of it, and its
    # engine then waits forever for a request budgeted to the end
    done = st["done"] | ~st["active"] | (new_cursor >= total)
    if eos_id is not None:
        done = done | (write_ok & (vals == eos_id)).any(dim=1)
    st["pos"] = st["pos"] + n_written
    st["cursor"] = new_cursor
    st["done"] = done
    return vals, torch.where(live, n_written, 0)


# --------------------------------------------------------------- seq2seq


def make_decode_state_seq2seq(cfg, n_slots: int, total: int, enc_width: int, *, device="cuda", model=None) -> dict:
    """A fresh all-slots-free seq2seq state (decode_engine.py:641):
    ``total`` decoder slots a row (BOS and up to total - 1 generated
    tokens; the cache is ``total + 1`` wide, the guard column), per-slot
    bf16 cross K/V ``enc_width`` wide (the largest encoder bucket) and
    the encoder mask.  ``model`` lays out the cache and the cross K/V (a
    tensor-parallel reader's live on its devices); without one they are
    the unsharded layout on ``device``."""
    if total > cfg.max_seq_len:
        raise ValueError(f"total={total} exceeds cfg.max_seq_len={cfg.max_seq_len}")

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if model is None:
        cache = make_cache(cfg, n_slots, total + 1, device, n_layers=cfg.decoder_layers)
        cross = make_cache(cfg, n_slots, enc_width, device, n_layers=cfg.decoder_layers)
    else:
        cache, cross = model.make_cache(n_slots, total + 1), model.make_cross_cache(n_slots, enc_width)
    return {
        "cache": cache,
        "cross_kv": cross,
        "enc_mask": zeros((n_slots, enc_width), torch.int32),
        "key_valid": zeros((n_slots, total), torch.bool),
        "last_tok": zeros((n_slots,), torch.int32),
        "cursor": zeros((n_slots,), torch.int32),
        "active": zeros((n_slots,), torch.bool),
        "done": torch.ones((n_slots,), dtype=torch.bool, device=device),
        "temp": zeros((n_slots,), torch.float32),
        "top_k": zeros((n_slots,), torch.int32),
        "top_p": torch.ones((n_slots,), dtype=torch.float32, device=device),
    }


@torch.inference_mode()
def prefill_seq2seq(model, enc_ids, enc_mask, generator, temp, top_k, top_p, *, sampled: bool, bos_id: int = 0):
    """Encode one RIGHT-padded prompt (1, T bucket), project its cross K/V
    (bf16, at the bucket's width), run the BOS decoder step and sample the
    first token (decode_engine.py:690).  Returns ``(cross_kv, dec_kv,
    first_tok)``, ``dec_kv`` the width-1 self-KV of the BOS step."""
    dev = model.device
    enc_ids = _on(dev, enc_ids, torch.long)
    enc_mask = _on(dev, enc_mask, torch.int32)
    cross_kv = [{name: t.to(torch.bfloat16) for name, t in layer.items()}
                for layer in model.precompute_cross_kv(model.encode(enc_ids, enc_mask))]
    cache = model.make_cache(1, 1)
    bos = torch.full((1, 1), bos_id, dtype=torch.long, device=dev)
    logits = model.decode(bos, None, enc_mask, torch.ones((1, 1, 1), dtype=torch.bool, device=dev),
                          positions=torch.zeros((1, 1), dtype=torch.long, device=dev), cache=cache, cache_index=0,
                          cross_kv=cross_kv)
    first = _sample_dynamic(logits[:, 0], generator, *_sampling(temp, top_k, top_p, dev), sampled=sampled)
    return cross_kv, cache, first


@torch.inference_mode()
def insert_seq2seq(state: dict, cross_kv, enc_mask, dec_kv, first_tok, slot: int, temp, top_k, top_p) -> None:
    """Install a prefilled seq2seq request into slot ``slot``
    (decode_engine.py:734): its cross K/V (zero past the bucket's width),
    its encoder mask (1, enc_width), the BOS column of its self-KV,
    cursor 1, sampling knobs.  Every field of the row the decode reads is
    rewritten."""
    dev = state["cursor"].device
    for layer, ckv in zip(state["cross_kv"], cross_kv):
        for name, leaf in layer.items():
            w = ckv[name].shape[1]
            leaf[slot, :w] = ckv[name][0]
            leaf[slot, w:] = 0
    for layer, prefix in zip(state["cache"], dec_kv):
        for name, leaf in layer.items():
            leaf[slot, :1] = prefix[name][0].to(leaf.dtype)
    state["enc_mask"][slot] = _on(dev, enc_mask, torch.int32)[0]
    state["key_valid"][slot] = False
    state["key_valid"][slot, 0] = True
    state["last_tok"][slot] = first_tok.reshape(())
    state["cursor"][slot] = 1
    state["active"][slot] = True
    state["done"][slot] = False
    for name, val in zip(("temp", "top_k", "top_p"), _sampling(temp, top_k, top_p, dev)):
        state[name][slot] = val.reshape(())


@torch.inference_mode()
def decode_chunk_seq2seq(model, state: dict, generator, *, sampled: bool, n_steps: int = 8,
                         eos_id: int | None = None):
    """Advance every live seq2seq slot ``n_steps`` decoder tokens
    (decode_engine.py:780): cross-attention reads each slot's own K/V
    under its encoder mask, self-attention writes at the per-slot cursors.
    Returns the (n_slots, n_steps) int32 tokens on the device, as
    :func:`decode_chunk` does."""
    st = state
    total = st["key_valid"].shape[1]
    fill = torch.full((), 0 if eos_id is None else eos_id, dtype=torch.int32, device=st["cursor"].device)
    out = []
    with tracing.span("engine.chunk", slots=st["cursor"].shape[0], steps=n_steps, spec=0):
        for _ in range(n_steps):
            write_ok = st["active"] & ~st["done"] & (st["cursor"] < total)
            st["key_valid"] = _set_columns(st["key_valid"], st["cursor"][:, None], write_ok[:, None],
                                           write_ok[:, None])
            logits = model.decode(st["last_tok"][:, None], None, st["enc_mask"], st["key_valid"][:, None, :],
                                  positions=st["cursor"][:, None], cache=st["cache"], cache_index=st["cursor"],
                                  cross_kv=st["cross_kv"])
            nxt = _sample_dynamic(logits[:, 0], generator, st["temp"], st["top_k"], st["top_p"], sampled)
            nxt = torch.where(write_ok, nxt, fill)
            done = st["done"] | ~st["active"] | (st["cursor"] + 1 >= total)
            if eos_id is not None:
                done = done | (nxt == eos_id)
            st["last_tok"] = torch.where(write_ok, nxt, st["last_tok"])
            st["cursor"] = st["cursor"] + write_ok.to(torch.int32)
            st["done"] = done
            out.append(nxt)
    return torch.stack(out, dim=1)


@torch.inference_mode()
def release_seq2seq(state: dict, slot: int) -> None:
    """Free seq2seq slot ``slot``."""
    state["key_valid"][slot] = False
    state["enc_mask"][slot] = 0
    state["active"][slot] = False
    state["done"][slot] = True
