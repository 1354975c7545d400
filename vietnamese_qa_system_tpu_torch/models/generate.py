"""Autoregressive generation with a static-shape KV cache.

Counterpart of ``vietnamese_qa_system_tpu/models/generate.py``:
``GenerationConfig``,
``generate_with_config``, ``generate`` and its logit processors,
prompt-lookup speculative decoding (``generate_speculative`` with its
drafter ``_ngram_draft``, which the continuous engine's speculative chunk
uses too), draft-model speculative decoding
(``generate_speculative_draft``) and ``beam_search``, and for the
encoder-decoders ``generate_seq2seq`` and ``beam_search_seq2seq``.  Causal
prompts are
LEFT-padded to a fixed length, the cache is one fixed (B, width, kv heads,
Dh) buffer per layer, bf16 or (``kv_dtype="int8"``, plain decode only)
int8 codes with scales, written in place.  Positions are logical (pads
excluded) via a cumsum of the mask.

``generate`` and ``beam_search`` are plain Python loops of
``max_new_tokens`` steps that read nothing back from the device; the
speculative loops read one flag a verify pass (their exit test, JAX's
``while_loop`` condition).  Sampling draws from an explicit
``torch.Generator`` on the model's device: the same distribution as the
JAX package, other random numbers.

A seq2seq reader encodes its (right-padded) input once, projects the
cross-attention K/V once, and decodes over a cache of ``max_new + 1``
decoder slots (BOS in slot 0); it returns the new tokens only, (B,
max_new).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core import tracing
from .causal_lm import CausalLM

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """The JAX package's GenerationConfig.  ``num_beams > 1`` is beam
    search; otherwise ``temperature == 0`` is greedy and ``> 0`` samples.
    ``speculative`` is "none", "ngram" (prompt lookup) or "draft" (a draft
    model passed as ``generate_with_config(draft=...)``)."""

    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    min_new_tokens: int = 0
    no_repeat_ngram_size: int = 0
    num_beams: int = 1
    length_penalty: float = 1.0
    seed: int = 0
    speculative: str = "none"
    draft_tokens: int = 8
    draft_ngram: int = 3
    kv_dtype: str = "bf16"
    forced_bos_token_id: int | None = None
    forced_eos_token_id: int | None = None


def generate_with_config(model: CausalLM, ids, attn_mask, gen: GenerationConfig, *, eos_id: int | None = None,
                         bos_id: int = 0, draft: CausalLM | None = None):
    """Dispatch a GenerationConfig to its decode loop, with the JAX
    package's guards (generate.py:66-200); returns (B, T + max_new) ids
    (prompt included) for a causal model, (B, max_new) for a seq2seq one
    (``bos_id`` its decoder start).  ``draft`` is the draft model that
    ``speculative="draft"`` needs."""
    cfg = model.cfg
    if gen.no_repeat_ngram_size > 0 and (gen.num_beams > 1 or cfg.arch == "seq2seq"):
        raise ValueError(
            "no_repeat_ngram_size is only supported on the causal sampled/greedy path (num_beams=1); got "
            f"num_beams={gen.num_beams}, arch={cfg.arch!r}")
    if gen.speculative not in ("none", "ngram", "draft"):
        raise ValueError(f"unknown speculative mode {gen.speculative!r} (none|ngram|draft)")
    if (gen.forced_bos_token_id is not None or gen.forced_eos_token_id is not None) and cfg.arch != "seq2seq":
        raise ValueError("forced_bos/eos_token_id are seq2seq conventions (mBART language forcing); "
                         "causal prompts carry their own start")
    if gen.kv_dtype != "bf16" and (cfg.arch == "seq2seq" or gen.num_beams > 1 or gen.speculative != "none"):
        raise ValueError("kv_dtype='int8' is supported on the causal greedy/sampled path only (num_beams=1, "
                         "speculative='none'); the continuous engine carries its own int8 speculative path")
    generator = torch.Generator(device=model.device).manual_seed(gen.seed)
    if gen.speculative != "none":
        # history-dependent logit processors would break the independence
        # of a verify window's positions; beams have no speculative decode
        unsupported = [name for name, on in (
            ("seq2seq arch", cfg.arch == "seq2seq"), ("num_beams > 1", gen.num_beams > 1),
            ("repetition_penalty", gen.repetition_penalty != 1.0),
            ("no_repeat_ngram_size", gen.no_repeat_ngram_size > 0), ("min_new_tokens", gen.min_new_tokens > 0),
        ) if on]
        if unsupported:
            raise ValueError("speculative decoding is causal greedy/sampled only; unsupported options set: "
                             + ", ".join(unsupported))
        sampling = dict(temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p, generator=generator)
        if gen.speculative == "draft":
            if draft is None:
                raise ValueError("speculative='draft' needs draft=<a draft CausalLM>")
            return generate_speculative_draft(model, draft, ids, attn_mask, max_new_tokens=gen.max_new_tokens,
                                              eos_id=eos_id, draft_tokens=gen.draft_tokens, **sampling)
        return generate_speculative(model, ids, attn_mask, max_new_tokens=gen.max_new_tokens, eos_id=eos_id,
                                    draft_tokens=gen.draft_tokens, draft_ngram=gen.draft_ngram, **sampling)
    if cfg.arch == "seq2seq":
        forced = dict(forced_bos_id=gen.forced_bos_token_id, forced_eos_id=gen.forced_eos_token_id)
        if gen.num_beams > 1:
            return beam_search_seq2seq(model, ids, attn_mask, max_new_tokens=gen.max_new_tokens,
                                       num_beams=gen.num_beams, eos_id=eos_id, bos_id=bos_id,
                                       length_penalty=gen.length_penalty, repetition_penalty=gen.repetition_penalty,
                                       min_new_tokens=gen.min_new_tokens, **forced)
        return generate_seq2seq(model, ids, attn_mask, max_new_tokens=gen.max_new_tokens,
                                temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
                                repetition_penalty=gen.repetition_penalty, min_new_tokens=gen.min_new_tokens,
                                eos_id=eos_id, bos_id=bos_id, generator=generator, **forced)
    if gen.num_beams > 1:
        return beam_search(model, ids, attn_mask, max_new_tokens=gen.max_new_tokens, num_beams=gen.num_beams,
                           eos_id=eos_id, length_penalty=gen.length_penalty,
                           repetition_penalty=gen.repetition_penalty, min_new_tokens=gen.min_new_tokens)
    return generate(
        model, ids, attn_mask, max_new_tokens=gen.max_new_tokens, temperature=gen.temperature, top_k=gen.top_k,
        top_p=gen.top_p, repetition_penalty=gen.repetition_penalty, min_new_tokens=gen.min_new_tokens,
        no_repeat_ngram_size=gen.no_repeat_ngram_size, eos_id=eos_id, generator=generator, kv_dtype=gen.kv_dtype,
    )


def _top_p_mask(logits, top_p: float, iters: int = 26):
    """Nucleus keep-mask by threshold bisection in f32 (no full-vocab sort):
    {p_i >= tau*} for tau* = sup{tau : mass(p >= tau) >= top_p}, pinned to
    p_max / 2^26 by 26 halvings; exact ties at the boundary are all kept."""
    p = torch.softmax(logits, dim=-1)
    lo = torch.zeros(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    hi = p.amax(dim=-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(p >= mid, p, 0.0).sum(dim=-1, keepdim=True)
        ok = mass >= top_p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return p >= lo


def _process_logits(logits, *, temperature, top_k, top_p):
    """Temperature / top-k / nucleus processing over (..., V): the softmax
    of the result is the sampling distribution."""
    # a true division (a 0-d tensor, filled on the device: no copy from the
    # host): CUDA multiplies by the reciprocal of a Python scalar, one ulp
    # off the JAX package
    logits = logits.float() / torch.full((), temperature, dtype=torch.float32, device=logits.device)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        logits = torch.where(_top_p_mask(logits, top_p), logits, NEG_INF)
    return logits


def _sample_logits(logits, generator, *, temperature, top_k, top_p):
    """Greedy (argmax, first index on ties like ``jnp.argmax``) or a draw
    from the processed distribution (Gumbel-max, like
    ``jax.random.categorical``) with ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return _categorical(_process_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p), generator)


def _categorical(logits, generator):
    """One draw from softmax(logits) over the last axis by Gumbel-max, as
    ``jax.random.categorical`` draws."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def _ngram_draft(seq_buf, cur_end, pad_start, gamma: int, ngram: int):
    """Prompt-lookup drafting (generate.py:475): the ``gamma`` tokens that
    followed the most recent earlier occurrence of the stream's last
    ``ngram`` tokens, read as a continuation of period ``dist`` (so a
    match near the end wraps instead of running past the decided stream);
    with no match, the last token repeated.

    seq_buf (B, L) int; cur_end (B,) exclusive end of the decided stream;
    pad_start (B,) first real token.  Returns (B, gamma) drafts (garbage
    without a match: the verifier rejects them)."""
    b, length = seq_buf.shape
    dev = seq_buf.device
    rows = torch.arange(b, device=dev)[:, None]
    tail_idx = (cur_end[:, None] - ngram + torch.arange(ngram, device=dev)[None, :]).clamp(0, length - 1)
    tail = seq_buf[rows, tail_idx]
    win = torch.stack([seq_buf[:, q: length - ngram + 1 + q] for q in range(ngram)], dim=-1)
    p_idx = torch.arange(length - ngram + 1, device=dev)[None, :]
    ok = ((win == tail[:, None, :]).all(dim=-1) & (p_idx >= pad_start[:, None])
          & (p_idx + ngram < cur_end[:, None]))
    best = torch.where(ok, p_idx, -1).amax(dim=1)
    dist = torch.where(best >= 0, cur_end - ngram - best, torch.ones_like(cur_end))
    d_idx = ((cur_end - dist)[:, None] + torch.arange(gamma, device=dev)[None, :] % dist[:, None]).clamp(0, length - 1)
    return seq_buf[rows, d_idx]


def _ngram_ban(seq_buf, cur_end: int, pad_start, n: int, vocab: int):
    """(B, V) mask of tokens that would complete an n-gram already present
    in the left-padded sequence ``seq_buf[:, :cur_end]`` (HF semantics);
    windows that touch padding or the not-yet-generated tail are excluded."""
    b, length = seq_buf.shape
    pos = torch.arange(length - n + 1, device=seq_buf.device)
    windows = torch.stack([seq_buf[:, i: length - n + 1 + i] for i in range(n - 1)], dim=-1)
    start = min(max(cur_end - (n - 1), 0), length - (n - 1))  # lax.dynamic_slice clamps
    cur_prefix = seq_buf[:, start: start + n - 1]
    match = (windows == cur_prefix[:, None, :]).all(dim=-1)
    match &= (pos[None, :] + n <= cur_end) & (pos[None, :] >= pad_start[:, None])
    banned = seq_buf[:, n - 1:].long()
    ban = torch.zeros((b, vocab), dtype=torch.int32, device=seq_buf.device)
    ban.scatter_reduce_(1, banned, match.to(torch.int32), reduce="amax")
    return ban > 0


def _prefill(model: CausalLM, ids, attn_mask, total: int, kv_dtype: str = "bf16"):
    """Prefill of LEFT-padded prompts (B, T) into a new cache ``total``
    slots wide: causal over the prompt, keys limited to its real slots.
    Returns (cache, logits of the last prompt slot (B, V), key_valid (B,
    total) bool, n_prompt (B,))."""
    b, t = ids.shape
    dev = ids.device
    positions = (torch.cumsum(attn_mask, dim=1) - 1).clamp_min(0).long()
    cache = model.make_cache(b, total, kv_dtype)
    j = torch.arange(total, device=dev)[None, None, :]
    key_valid = torch.cat([attn_mask.bool(), torch.zeros((b, total - t), dtype=torch.bool, device=dev)], dim=1)
    prefill_mask = (j <= torch.arange(t, device=dev)[None, :, None]) & key_valid[:, None, :]
    h = model.hidden_states(ids.long(), prefill_mask, positions=positions, cache=cache, cache_index=0)
    return cache, model.head(h[:, -1]), key_valid, attn_mask.sum(dim=1)


def _seen_table(ids, attn_mask, vocab: int):
    """(B, V) bool: the tokens of each prompt (pads excluded), the
    repetition penalty's table."""
    seen = torch.zeros((ids.shape[0], vocab), dtype=torch.int32, device=ids.device)
    seen.scatter_reduce_(1, ids.long(), attn_mask, reduce="amax")
    return seen > 0


def _synced(timings: dict | None, dev) -> float:
    """time.perf_counter(), after the device's queue has drained when
    ``timings`` asks for times."""
    if timings is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _record(timings: dict | None, t0: float, t1: float, t2: float) -> None:
    """``prefill_s`` (t0 to t1) and ``decode_s`` (t1 to t2) into ``timings``."""
    if timings is not None:
        timings["prefill_s"], timings["decode_s"] = t1 - t0, t2 - t1


def _inputs(model: CausalLM, ids, attn_mask):
    """ids and mask as int32 tensors on the model's device."""
    dev = model.device
    return torch.as_tensor(ids, device=dev).to(torch.int32), torch.as_tensor(attn_mask, device=dev).to(torch.int32)


@torch.inference_mode()
def generate(model: CausalLM, ids, attn_mask, *, max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, repetition_penalty: float = 1.0, min_new_tokens: int = 0,
             no_repeat_ngram_size: int = 0, eos_id: int | None = None, generator: torch.Generator | None = None,
             timings: dict | None = None, kv_dtype: str = "bf16"):
    """Greedy (temperature 0) or sampled decode of LEFT-padded prompts.

    ids / attn_mask (B, T) on the model's device.  Returns (B, T + max_new)
    int32 ids; finished rows are padded with eos after their first eos.
    ``repetition_penalty`` / ``min_new_tokens`` / ``no_repeat_ngram_size``
    follow HF semantics.  ``kv_dtype="int8"`` quantizes the KV cache
    (layers.kv_quantize); the continuous engine's int8 streams are held
    to it.  ``timings`` (a dict) receives ``prefill_s`` and ``decode_s``,
    each ended by a device synchronisation."""
    dev = model.device
    ids, attn_mask = _inputs(model, ids, attn_mask)
    b, t = ids.shape
    total = t + max_new_tokens
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    cache, last_logits, key_valid, n_prompt = _prefill(model, ids, attn_mask, total, kv_dtype)
    j = torch.arange(total, device=dev)[None, None, :]
    t1 = _synced(timings, dev)

    needs_seen = repetition_penalty != 1.0 or no_repeat_ngram_size == 1
    needs_buf = no_repeat_ngram_size >= 2
    vocab = last_logits.shape[-1]
    if needs_seen:
        seen = _seen_table(ids, attn_mask, vocab)
    if needs_buf:
        seq_buf = torch.cat([ids, torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)], dim=1)
    pad_start = t - n_prompt
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    vocab_ids = torch.arange(vocab, device=dev)[None, :]
    toks = []
    with tracing.span("generate.decode"):
        for step_idx in range(max_new_tokens):
            logits = last_logits.float()
            if no_repeat_ngram_size == 1:
                logits = torch.where(seen, NEG_INF, logits)
            elif no_repeat_ngram_size > 0:
                logits = torch.where(_ngram_ban(seq_buf, t + step_idx, pad_start, no_repeat_ngram_size, vocab),
                                     NEG_INF, logits)
            if repetition_penalty != 1.0:
                rp = torch.full((), repetition_penalty, dtype=torch.float32, device=dev)
                logits = torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
            if eos_id is not None and step_idx < min_new_tokens:
                logits = torch.where(vocab_ids == eos_id, NEG_INF, logits)
            tok = _sample_logits(logits, generator, temperature=temperature, top_k=top_k, top_p=top_p)
            if eos_id is not None:
                tok = torch.where(done, torch.full((), eos_id, dtype=torch.int32, device=dev), tok)
                done = done | (tok == eos_id)
            if needs_seen:
                seen[torch.arange(b, device=dev), tok.long()] = True
            if needs_buf:
                seq_buf[:, t + step_idx] = tok
            toks.append(tok)
            # decode position: logical position = n_prompt + step_idx
            slot = t + step_idx
            step_mask = key_valid[:, None, :] | ((j >= t) & (j <= slot))
            h = model.hidden_states(tok[:, None].long(), step_mask, positions=(n_prompt + step_idx)[:, None].long(),
                                    cache=cache, cache_index=slot)
            last_logits = model.head(h[:, 0])
    _record(timings, t0, t1, _synced(timings, dev))
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1) if toks else ids


def _cached_pass(model: CausalLM, toks, start, t: int, n_prompt, key_valid, cache):
    """Logits (B, w, V) of ``toks`` (B, w) written into ``cache`` at the
    per-row cursors ``start`` (B,) (slots ``start + s``, logical positions
    ``n_prompt + start - t + s``): each sees the prompt's real slots and
    the generated slots up to its own."""
    w = toks.shape[1]
    dev = toks.device
    s = torch.arange(w, device=dev)
    jj = torch.arange(key_valid.shape[1], device=dev)[None, None, :]
    gen_ok = (jj >= t) & (jj <= (start[:, None] + s)[:, :, None])
    pos = (n_prompt + start - t)[:, None] + s
    h = model.hidden_states(toks.long(), key_valid[:, None, :] | gen_ok, positions=pos.long(), cache=cache,
                            cache_index=start)
    return model.head(h)


class _Stream:
    """The decided stream of a speculative decode (generate.py:627-641):
    produced token i at ``buf[:, t + i]``, one dump column at the end that
    absorbs masked writes, ``n_dec`` (B,) the index of each row's pending
    token, ``done`` (B,)."""

    def __init__(self, ids, first, max_new: int, eos_id):
        b, t = ids.shape
        dev = ids.device
        self.t, self.max_new, self.eos_id = t, max_new, eos_id
        fill = eos_id if eos_id is not None else 0
        self.buf = torch.cat([ids, torch.full((b, max_new + 1), fill, dtype=torch.int32, device=dev)], dim=1)
        self.buf[:, t] = first
        self.n_dec = torch.zeros((b,), dtype=torch.long, device=dev)
        self.done = (first == eos_id) if eos_id is not None else torch.zeros((b,), dtype=torch.bool, device=dev)
        self.accepted = torch.zeros((), dtype=torch.long, device=dev)
        self.passes = 0

    def running(self) -> bool:
        """The loop's exit test: the one host read of a verify pass."""
        return bool((~self.done & (self.n_dec < self.max_new - 1)).any())

    def pending(self):
        """(B, 1) each row's pending token (decided, not yet in the cache)."""
        return self.buf.gather(1, (self.t + self.n_dec)[:, None])

    def advance(self, window, a, bonus) -> None:
        """Write the ``a`` (B,) accepted drafts of ``window`` (B, gamma + 1)
        and the bonus token after them (generate.py:700-734): nothing past
        ``max_new``, nothing on a done row, nothing after an eos accepted
        in the same window."""
        jw = torch.arange(window.shape[1], device=window.device)[None, :]
        drafts = torch.cat([window[:, 1:], torch.zeros_like(window[:, :1])], dim=1)
        vals = torch.where(jw < a[:, None], drafts, bonus[:, None])
        idx = self.n_dec[:, None] + 1 + jw
        write_ok = (jw <= a[:, None]) & ~self.done[:, None] & (idx < self.max_new)
        if self.eos_id is not None:
            is_eos = (vals == self.eos_id).to(torch.int32)
            write_ok &= torch.cumsum(is_eos, dim=1) - is_eos == 0
        slots = torch.where(write_ok, self.t + idx, self.t + self.max_new)
        self.buf.scatter_(1, slots, torch.where(write_ok, vals, self.buf.gather(1, slots)))
        n_written = write_ok.sum(dim=1)
        # drafts that became output (all that was written but the bonus)
        self.accepted += torch.where(self.done, 0, (n_written - 1).clamp_min(0)).sum()
        if self.eos_id is not None:
            self.done = self.done | (write_ok & (vals == self.eos_id)).any(dim=1)
        self.n_dec = self.n_dec + n_written
        self.passes += 1

    def result(self, ids, return_stats: bool):
        """(B, T + max_new) ids, every token after the first eos an eos, as
        ``generate`` returns them; with the stats dict."""
        toks = self.buf[:, self.t: self.t + self.max_new]
        if self.eos_id is not None:
            seen = torch.cumsum((toks == self.eos_id).to(torch.int32), dim=1)
            toks = torch.where(seen > 1, self.eos_id, toks)
        out = torch.cat([ids, toks], dim=1)
        if return_stats:
            return out, {"iterations": self.passes, "drafted_accepted": int(self.accepted)}
        return out


def _greedy_accept(logits, window):
    """The longest run of drafts equal to the target's argmax after the
    column before each, and the argmax after the last accepted one:
    (a (B,), bonus (B,))."""
    gamma = window.shape[1] - 1
    y = torch.argmax(logits, dim=-1).to(torch.int32)
    a = torch.cumprod((y[:, :gamma] == window[:, 1:]).to(torch.int32), dim=1).sum(dim=1)
    return a, y.gather(1, a[:, None].long())[:, 0]


@torch.inference_mode()
def generate_speculative(model: CausalLM, ids, attn_mask, *, max_new_tokens: int = 32, eos_id: int | None = None,
                         draft_tokens: int = 8, draft_ngram: int = 3, temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 1.0, generator: torch.Generator | None = None, return_stats: bool = False,
                         timings: dict | None = None):
    """Prompt-lookup speculative decoding (generate.py:534-752): each pass
    drafts ``draft_tokens`` tokens by :func:`_ngram_draft` over the decided
    stream, verifies the pending token and the drafts in one forward at
    the per-row cursors, and keeps the accepted drafts and one
    correction / bonus token.

    Greedy (temperature 0) keeps the longest run of drafts equal to the
    argmax: the tokens of ``generate`` (a verify window and a one-token
    step sum their products in other orders, so an argmax whose top-2
    margin is ~float epsilon can flip).  Sampled decoding is rejection
    sampling against the point-mass drafter: a draft d is accepted when
    ``u < p(d)``, a rejected one replaced by a draw from p with d banned,
    and the bonus after a fully accepted window drawn from p, so every
    token is distributed as ``generate`` draws it.

    The cache is ``T + max_new + draft_tokens`` wide, so that no window
    reaches its last column (per-row writes past it would clamp there).
    Returns (B, T + max_new) ids; with ``return_stats`` also
    {"iterations": verify passes, "drafted_accepted": drafts kept}.
    ``timings`` receives ``prefill_s`` and ``decode_s`` as ``generate``'s."""
    gamma, ngram = draft_tokens, draft_ngram
    if gamma < 1:
        raise ValueError(f"draft_tokens must be >= 1, got {gamma}")
    if ngram < 1:
        raise ValueError(f"draft_ngram must be >= 1, got {ngram}")
    dev = model.device
    ids, attn_mask = _inputs(model, ids, attn_mask)
    b, t = ids.shape
    generator = generator or torch.Generator(device=dev).manual_seed(0)
    sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    t0 = time.perf_counter()
    cache, last, key_valid, n_prompt = _prefill(model, ids, attn_mask, t + max_new_tokens + gamma)
    stream = _Stream(ids, _sample_logits(last, generator, **sampling), max_new_tokens, eos_id)
    pad_start = t - n_prompt
    t1 = _synced(timings, dev)
    with tracing.span("generate.speculative"):
        while stream.running():
            drafts = _ngram_draft(stream.buf, t + stream.n_dec + 1, pad_start, gamma, ngram)
            window = torch.cat([stream.pending(), drafts], dim=1)
            logits = _cached_pass(model, window, t + stream.n_dec, t, n_prompt, key_valid, cache)
            if temperature == 0.0:
                a, bonus = _greedy_accept(logits, window)
            else:
                proc = _process_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
                p_draft = torch.log_softmax(proc[:, :gamma], dim=-1).gather(-1, window[:, 1:, None].long())[..., 0]
                u = torch.rand((b, gamma), generator=generator, device=dev)
                a = torch.cumprod((u < p_draft.exp()).to(torch.int32), dim=1).sum(dim=1)
                # position s < gamma replaces its rejected draft (banned);
                # position gamma draws the bonus from the unmodified target
                banned = torch.zeros_like(proc, dtype=torch.bool)
                banned[:, :gamma].scatter_(-1, window[:, 1:, None].long(), True)
                res = _categorical(torch.where(banned, NEG_INF, proc), generator)
                bonus = res.gather(1, a[:, None].long())[:, 0]
            stream.advance(window, a, bonus)
    _record(timings, t0, t1, _synced(timings, dev))
    return stream.result(ids, return_stats)


@torch.inference_mode()
def generate_speculative_draft(model: CausalLM, draft: CausalLM, ids, attn_mask, *, max_new_tokens: int = 32,
                               eos_id: int | None = None, draft_tokens: int = 6, temperature: float = 0.0,
                               top_k: int = 0, top_p: float = 1.0, generator: torch.Generator | None = None,
                               return_stats: bool = False, timings: dict | None = None):
    """Draft-model speculative decoding (generate.py:762-995): ``draft``, a
    small causal LM of the same vocabulary, proposes ``draft_tokens``
    tokens a pass with as many cheap sequential steps, and the target
    verifies them in one forward.  Greedy accepts drafts while they equal
    the target's argmax (the tokens of ``generate`` whatever the draft);
    sampled drafts come from the draft's distribution q and are accepted
    when ``u q(d) < p(d)``, the first rejected position redrawn from
    ``max(p - q, 0)`` and the bonus of a fully accepted window from p, so
    the tokens are distributed as the target's.

    Both models keep a cache of the same width at the same per-row
    cursors.  A pass's first draft step is a two-token forward of the last
    accepted token and the pending one at cursor ``T + n_dec - 1``: it
    writes the slot of the previous pass's last draft, which a fully
    accepted pass leaves unwritten otherwise (the JAX function's draft
    steps never feed that draft, so its next pass attends an empty slot,
    and a perfect drafter takes more passes there; ROADMAP Queue 3).
    Returns (B, T + max_new) ids; with ``return_stats`` and ``timings`` as
    :func:`generate_speculative`."""
    if model.cfg.vocab_size != draft.cfg.vocab_size:
        raise ValueError(f"target and draft must share a vocabulary: {model.cfg.vocab_size} != "
                         f"{draft.cfg.vocab_size}")
    gamma = draft_tokens
    if gamma < 1:
        raise ValueError(f"draft_tokens must be >= 1, got {gamma}")
    dev = model.device
    ids, attn_mask = _inputs(model, ids, attn_mask)
    b, t = ids.shape
    generator = generator or torch.Generator(device=dev).manual_seed(0)
    sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    total = t + max_new_tokens + gamma
    t0 = time.perf_counter()
    cache, last, key_valid, n_prompt = _prefill(model, ids, attn_mask, total)
    d_cache = _prefill(draft, ids, attn_mask, total)[0]
    stream = _Stream(ids, _sample_logits(last, generator, **sampling), max_new_tokens, eos_id)
    two = torch.arange(2, device=dev)[None, :]
    t1 = _synced(timings, dev)
    with tracing.span("generate.speculative"):
        while stream.running():
            prev = t + stream.n_dec - 1
            lg = _cached_pass(draft, stream.buf.gather(1, prev[:, None] + two), prev, t, n_prompt, key_valid,
                              d_cache)[:, -1]
            drafts, q = [], []
            for s in range(gamma):
                if s:
                    lg = _cached_pass(draft, drafts[-1][:, None], t + stream.n_dec + s, t, n_prompt, key_valid,
                                      d_cache)[:, 0]
                if temperature == 0.0:
                    drafts.append(torch.argmax(lg, dim=-1).to(torch.int32))
                else:
                    proc = _process_logits(lg, **sampling)
                    drafts.append(_categorical(proc, generator))
                    q.append(torch.softmax(proc, dim=-1))
            window = torch.cat([stream.pending(), torch.stack(drafts, dim=1)], dim=1)
            logits = _cached_pass(model, window, t + stream.n_dec, t, n_prompt, key_valid, cache)
            if temperature == 0.0:
                a, bonus = _greedy_accept(logits, window)
            else:
                p = torch.softmax(_process_logits(logits, **sampling), dim=-1)
                q = torch.stack(q, dim=1)
                d = window[:, 1:, None].long()
                p_d, q_d = p[:, :gamma].gather(-1, d)[..., 0], q.gather(-1, d)[..., 0]
                u = torch.rand((b, gamma), generator=generator, device=dev)
                a = torch.cumprod((u * q_d < p_d).to(torch.int32), dim=1).sum(dim=1)
                resid = (p[:, :gamma] - q).clamp_min(0.0)
                res = _categorical(torch.where(resid > 0, torch.log(resid), NEG_INF), generator)
                full = _categorical(torch.log(p[:, gamma].clamp_min(1e-30)), generator)
                bonus = torch.cat([res, full[:, None]], dim=1).gather(1, a[:, None].long())[:, 0]
            stream.advance(window, a, bonus)
    _record(timings, t0, t1, _synced(timings, dev))
    return stream.result(ids, return_stats)


def _forced(logits, step: int, last: int, forced_bos_id, forced_eos_id, vocab_ids):
    """mBART's forcing (HF forced_bos_token_id / forced_eos_token_id): step
    0 can only produce ``forced_bos_id``, the last step only
    ``forced_eos_id``."""
    if forced_bos_id is not None and step == 0:
        logits = torch.where(vocab_ids != forced_bos_id, NEG_INF, logits)
    if forced_eos_id is not None and step == last:
        logits = torch.where(vocab_ids != forced_eos_id, NEG_INF, logits)
    return logits


@torch.inference_mode()
def generate_seq2seq(model, enc_ids, enc_mask, *, max_new_tokens: int = 32, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0, repetition_penalty: float = 1.0, min_new_tokens: int = 0,
                     eos_id: int | None = None, bos_id: int = 0, forced_bos_id: int | None = None,
                     forced_eos_id: int | None = None, generator: torch.Generator | None = None,
                     timings: dict | None = None):
    """Encoder-decoder decode (generate.py:1006-1130) of RIGHT-padded inputs
    (B, T): encode once, the cross-attention K/V once, then
    ``max_new_tokens`` decoder steps over a cache of ``max_new_tokens +
    1`` slots, BOS (``bos_id``) in slot 0.  ``forced_bos_id`` /
    ``forced_eos_id`` force the first / last token (mBART); the
    repetition penalty reads the decoder stream only (BOS and the
    generated tokens); ``min_new_tokens`` holds eos back.  Returns (B,
    max_new) int32 tokens, every token after a row's first eos an eos.
    The steps read nothing back from the device.  ``timings`` receives
    ``prefill_s`` (encode and cross K/V) and ``decode_s``."""
    dev = model.device
    enc_ids, enc_mask = _inputs(model, enc_ids, enc_mask)
    b = enc_ids.shape[0]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    enc_out = model.encode(enc_ids, enc_mask)
    cross_kv = model.precompute_cross_kv(enc_out)
    total = max_new_tokens + 1
    cache = model.make_cache(b, total)
    jj = torch.arange(total, device=dev)[None, None, :]
    t1 = _synced(timings, dev)
    vocab = model.cfg.vocab_size
    vocab_ids = torch.arange(vocab, device=dev)[None, :]
    tok = torch.full((b,), bos_id, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    seen = (vocab_ids == bos_id).expand(b, vocab).clone() if repetition_penalty != 1.0 else None
    rows = torch.arange(b, device=dev)
    toks = []
    with tracing.span("generate.seq2seq"):
        for idx in range(max_new_tokens):
            logits = model.decode(tok[:, None], None, enc_mask, (jj <= idx).expand(b, 1, total),
                                  positions=torch.full((b, 1), idx, device=dev), cache=cache, cache_index=idx,
                                  cross_kv=cross_kv)
            lg = _forced(logits[:, 0].float(), idx, max_new_tokens - 1, forced_bos_id, forced_eos_id, vocab_ids)
            if seen is not None:
                rp = torch.full((), repetition_penalty, dtype=torch.float32, device=dev)
                lg = torch.where(seen, torch.where(lg > 0, lg / rp, lg * rp), lg)
            if eos_id is not None and idx < min_new_tokens:
                lg = torch.where(vocab_ids == eos_id, NEG_INF, lg)
            tok = _sample_logits(lg, generator, temperature=temperature, top_k=top_k, top_p=top_p)
            if eos_id is not None:
                tok = torch.where(done, torch.full((), eos_id, dtype=torch.int32, device=dev), tok)
                done = done | (tok == eos_id)
            if seen is not None:
                seen[rows, tok.long()] = True
            toks.append(tok)
    _record(timings, t0, t1, _synced(timings, dev))
    return torch.stack(toks, dim=1)


def _reorder_cache(cache: list[dict], idx, cols: slice | None = None) -> None:
    """Gather every layer's buffers by ``idx`` along the batch / beam axis
    (generate.py:293), in place on the list and one layer at a time, so the
    peak holds one layer's extra copy, not a second cache.  With ``cols``
    only those cache slots move (in place): beam search reorders the
    generated slots alone, because every beam of a row holds the same
    prompt slots and the same unwritten ones."""
    for layer in cache:
        for name, buf in layer.items():
            at = idx.to(buf.device)  # a tensor-parallel cache's buffers live on their devices
            if cols is None:
                layer[name] = buf.index_select(0, at)
            else:
                buf[:, cols] = buf[at, cols]


@torch.inference_mode()
def beam_search(model: CausalLM, ids, attn_mask, *, max_new_tokens: int = 32, num_beams: int = 4,
                eos_id: int | None = None, length_penalty: float = 1.0, repetition_penalty: float = 1.0,
                min_new_tokens: int = 0, timings: dict | None = None):
    """Batched beam search over a KV cache (generate.py:1290-1448): the
    prompt is prefilled once at batch B and repeated to B x W rows; beams
    1..W-1 start at -1e30 so that the first step expands beam 0; a
    finished beam continues with eos at no cost; the W best of a row's W x
    V candidates (ranked as ``lax.top_k``: descending, ties to the lowest
    flat index) become its beams, and the cache, tokens, done flags and
    repetition table follow their parents.  Returns (B, T + max_new): each
    row's beam of the highest score / length ** length_penalty (HF's
    normalisation; a beam's length counts up to its first eos), with every
    token after its first eos an eos.  The steps read nothing back from
    the device; the last one runs no forward (its logits are never
    read).  ``timings`` receives ``prefill_s`` (the prefill and the
    expansion to B x W rows) and ``decode_s`` as ``generate``'s."""
    dev = model.device
    ids, attn_mask = _inputs(model, ids, attn_mask)
    b, t = ids.shape
    w = num_beams
    total = t + max_new_tokens
    t0 = time.perf_counter()
    cache, last, key_valid, n_prompt = _prefill(model, ids, attn_mask, total)
    expand = torch.arange(b, device=dev).repeat_interleave(w)  # row i -> beams i*w .. i*w+w-1
    _reorder_cache(cache, expand)
    key_valid, n_prompt = key_valid[expand], n_prompt[expand]
    last_logits = last.float()[expand]
    v = last_logits.shape[-1]
    scores = torch.full((b, w), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    toks = torch.zeros((b, w, max_new_tokens), dtype=torch.int32, device=dev)
    done = torch.zeros((b, w), dtype=torch.bool, device=dev)
    seen = _seen_table(ids, attn_mask, v)[expand] if repetition_penalty != 1.0 else None
    vocab_ids = torch.arange(v, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    jj = torch.arange(total, device=dev)[None, None, :]
    t1 = _synced(timings, dev)
    with tracing.span("beam.decode"):
        for step_idx in range(max_new_tokens):
            ll = last_logits
            if seen is not None:
                rp = torch.full((), repetition_penalty, dtype=torch.float32, device=dev)
                ll = torch.where(seen, torch.where(ll > 0, ll / rp, ll * rp), ll)
            if eos_id is not None and step_idx < min_new_tokens:
                ll = torch.where(vocab_ids == eos_id, NEG_INF, ll)
            logp = torch.log_softmax(ll, dim=-1).reshape(b, w, v)
            if eos_id is not None:
                finished = torch.where(vocab_ids == eos_id, 0.0, NEG_INF)
                logp = torch.where(done[:, :, None], finished, logp)
            flat = (scores[:, :, None] + logp).reshape(b, w * v)
            top_s, top_i = torch.sort(flat, dim=1, descending=True, stable=True)
            scores, top_i = top_s[:, :w], top_i[:, :w]
            parent = top_i // v
            token = (top_i % v).to(torch.int32)
            toks = toks[rows, parent]
            toks[:, :, step_idx] = token
            done = done[rows, parent]
            if eos_id is not None:
                done = done | (token == eos_id)
            flat_parent = (rows * w + parent).reshape(b * w)
            if seen is not None:
                seen = seen[flat_parent]
                seen[torch.arange(b * w, device=dev), token.reshape(-1).long()] = True
            if step_idx == max_new_tokens - 1:
                break
            slot = t + step_idx
            if step_idx:
                _reorder_cache(cache, flat_parent, slice(t, slot))
            h = model.hidden_states(token.reshape(b * w, 1).long(), key_valid[:, None, :] | ((jj >= t) & (jj <= slot)),
                                    positions=(n_prompt + step_idx)[:, None].long(), cache=cache, cache_index=slot)
            last_logits = model.head(h[:, 0]).float()
    _record(timings, t0, t1, _synced(timings, dev))
    if eos_id is not None:
        first_eos = torch.argmax((toks == eos_id).to(torch.int32), dim=-1) + 1
        lengths = torch.where(done, first_eos, max_new_tokens).float()
    else:
        lengths = torch.full((b, w), float(max_new_tokens), device=dev)
    norm = scores / lengths.clamp_min(1.0) ** length_penalty
    best = toks[torch.arange(b, device=dev), torch.argmax(norm, dim=1)]
    if eos_id is not None:
        seen_eos = torch.cumsum((best == eos_id).to(torch.int32), dim=1)
        best = torch.where(seen_eos > 1, eos_id, best)
    return torch.cat([ids, best], dim=1)


@torch.inference_mode()
def beam_search_seq2seq(model, enc_ids, enc_mask, *, max_new_tokens: int = 32, num_beams: int = 4,
                        eos_id: int | None = None, bos_id: int = 0, length_penalty: float = 1.0,
                        repetition_penalty: float = 1.0, min_new_tokens: int = 0, forced_bos_id: int | None = None,
                        forced_eos_id: int | None = None, timings: dict | None = None):
    """Encoder-decoder beam search (generate.py:1132-1288): encode once, B x
    W decoder rows, beams ranked and finished as :func:`beam_search` ranks
    them, with :func:`generate_seq2seq`'s forcing.  The beams of a row
    share its encoder input, so the cross K/V are computed once a row and
    never reordered; the self-attention cache follows the parents each
    step, all of its written slots but slot 0 (the BOS step, the same in
    every beam of a row).  Returns (B, max_new): each row's best beam by
    score / length ** length_penalty, every token after its first eos an
    eos.  ``timings`` as :func:`generate_seq2seq`'s."""
    dev = model.device
    enc_ids, enc_mask = _inputs(model, enc_ids, enc_mask)
    b = enc_ids.shape[0]
    w = num_beams
    t0 = time.perf_counter()
    expand = torch.arange(b, device=dev).repeat_interleave(w)
    enc_mask_w = enc_mask[expand]
    cross_kv = [{name: t[expand.to(t.device)] for name, t in layer.items()}
                for layer in model.precompute_cross_kv(model.encode(enc_ids, enc_mask))]
    total = max_new_tokens + 1
    cache = model.make_cache(b * w, total)
    jj = torch.arange(total, device=dev)[None, None, :]

    def decode_step(tok, idx: int):
        logits = model.decode(tok[:, None], None, enc_mask_w, (jj <= idx).expand(b * w, 1, total),
                              positions=torch.full((b * w, 1), idx, device=dev), cache=cache, cache_index=idx,
                              cross_kv=cross_kv)
        return logits[:, 0].float()

    last_logits = decode_step(torch.full((b * w,), bos_id, dtype=torch.int32, device=dev), 0)
    v = last_logits.shape[-1]
    scores = torch.full((b, w), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    toks = torch.zeros((b, w, max_new_tokens), dtype=torch.int32, device=dev)
    done = torch.zeros((b, w), dtype=torch.bool, device=dev)
    vocab_ids = torch.arange(v, device=dev)
    seen = (vocab_ids == bos_id).expand(b * w, v).clone() if repetition_penalty != 1.0 else None
    rows = torch.arange(b, device=dev)[:, None]
    t1 = _synced(timings, dev)
    with tracing.span("beam.decode"):
        for step_idx in range(max_new_tokens):
            ll = _forced(last_logits, step_idx, max_new_tokens - 1, forced_bos_id, forced_eos_id, vocab_ids)
            if seen is not None:
                rp = torch.full((), repetition_penalty, dtype=torch.float32, device=dev)
                ll = torch.where(seen, torch.where(ll > 0, ll / rp, ll * rp), ll)
            if eos_id is not None and step_idx < min_new_tokens:
                ll = torch.where(vocab_ids == eos_id, NEG_INF, ll)
            logp = torch.log_softmax(ll, dim=-1).reshape(b, w, v)
            if eos_id is not None:
                finished = torch.where(vocab_ids == eos_id, 0.0, NEG_INF)
                logp = torch.where(done[:, :, None], finished, logp)
            flat = (scores[:, :, None] + logp).reshape(b, w * v)
            top_s, top_i = torch.sort(flat, dim=1, descending=True, stable=True)
            scores, top_i = top_s[:, :w], top_i[:, :w]
            parent = top_i // v
            token = (top_i % v).to(torch.int32)
            toks = toks[rows, parent]
            toks[:, :, step_idx] = token
            done = done[rows, parent]
            if eos_id is not None:
                done = done | (token == eos_id)
            flat_parent = (rows * w + parent).reshape(b * w)
            if seen is not None:
                seen = seen[flat_parent]
                seen[torch.arange(b * w, device=dev), token.reshape(-1).long()] = True
            if step_idx == max_new_tokens - 1:
                break
            if step_idx:
                _reorder_cache(cache, flat_parent, slice(1, step_idx + 1))
            last_logits = decode_step(token.reshape(b * w), step_idx + 1)
    _record(timings, t0, t1, _synced(timings, dev))
    if eos_id is not None:
        first_eos = torch.argmax((toks == eos_id).to(torch.int32), dim=-1) + 1
        lengths = torch.where(done, first_eos, max_new_tokens).float()
    else:
        lengths = torch.full((b, w), float(max_new_tokens), device=dev)
    norm = scores / lengths.clamp_min(1.0) ** length_penalty
    best = toks[torch.arange(b, device=dev), torch.argmax(norm, dim=1)]
    if eos_id is not None:
        seen_eos = torch.cumsum((best == eos_id).to(torch.int32), dim=1)
        best = torch.where(seen_eos > 1, eos_id, best)
    return best
