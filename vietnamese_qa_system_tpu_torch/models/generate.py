"""Autoregressive generation with a static-shape KV cache.

Counterpart of the causal greedy/sampled path of
``vietnamese_qa_system_tpu/models/generate.py``: ``GenerationConfig``,
``generate_with_config``, ``generate`` and its logit processors, and the
prompt-lookup drafter ``_ngram_draft`` that the continuous engine's
speculative chunk uses.  Prompts are LEFT-padded to a fixed length, the
cache is one fixed (B, prompt + max_new, kv heads, Dh) buffer per layer,
bf16 or (``kv_dtype="int8"``) int8 codes with scales, written in place; the
decode loop is a plain Python loop of ``max_new_tokens`` steps that runs
exactly the steps of the JAX ``lax.scan`` (the last step's forward
included).  Positions are logical (pads excluded) via a cumsum of the mask.
Sampling draws from an explicit ``torch.Generator`` on the model's device:
the same distribution as the JAX package, other random numbers.

Beam search, speculative decoding in ``generate`` and seq2seq readers
are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .causal_lm import CausalLM, make_cache

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """The JAX package's GenerationConfig.  ``temperature == 0`` is greedy
    and ``> 0`` samples; ``num_beams > 1`` would be beam search."""

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
                         bos_id: int = 0, draft=None):
    """Dispatch a GenerationConfig; returns (B, T + max_new) ids (prompt
    included), as the JAX causal path does."""
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
    if cfg.arch == "seq2seq":
        raise NotImplementedError("seq2seq generation is not ported yet")
    if gen.speculative != "none":
        raise NotImplementedError(f"speculative decoding (speculative={gen.speculative!r}) is not ported yet")
    if gen.num_beams > 1:
        raise NotImplementedError("beam search (num_beams > 1) is not ported yet")
    generator = torch.Generator(device=model.device).manual_seed(gen.seed)
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
    # a true division (a 0-d tensor): CUDA multiplies by the reciprocal of
    # a Python scalar, one ulp off the JAX package
    logits = logits.float() / torch.tensor(temperature, dtype=torch.float32, device=logits.device)
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
    logits = _process_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
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
    cfg = model.cfg
    dev = model.device
    ids = torch.as_tensor(ids, device=dev).to(torch.int32)
    attn_mask = torch.as_tensor(attn_mask, device=dev).to(torch.int32)
    b, t = ids.shape
    total = t + max_new_tokens
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def sync():
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    positions = (torch.cumsum(attn_mask, dim=1) - 1).clamp_min(0).long()
    n_prompt = attn_mask.sum(dim=1)
    cache = make_cache(cfg, b, total, dev, kv_dtype)
    # prefill: causal over the prompt, keys limited to the prompt's slots
    j = torch.arange(total, device=dev)[None, None, :]
    key_valid = torch.cat([attn_mask.bool(), torch.zeros((b, max_new_tokens), dtype=torch.bool, device=dev)], dim=1)
    prefill_mask = (j <= torch.arange(t, device=dev)[None, :, None]) & key_valid[:, None, :]
    h = model.hidden_states(ids.long(), prefill_mask, positions=positions, cache=cache, cache_index=0)
    last_logits = model.head(h[:, -1])  # the last prompt slot (left-padded)
    sync()
    t1 = time.perf_counter()

    needs_seen = repetition_penalty != 1.0 or no_repeat_ngram_size == 1
    needs_buf = no_repeat_ngram_size >= 2
    vocab = last_logits.shape[-1]
    if needs_seen:
        # token-seen table (prompt tokens count)
        seen = torch.zeros((b, vocab), dtype=torch.int32, device=dev)
        seen.scatter_reduce_(1, ids.long(), attn_mask, reduce="amax")
        seen = seen > 0
    if needs_buf:
        seq_buf = torch.cat([ids, torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)], dim=1)
    pad_start = t - n_prompt
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    vocab_ids = torch.arange(vocab, device=dev)[None, :]
    toks = []
    # a named span for torch.profiler traces of the decode loop
    with torch.profiler.record_function("generate.decode"):
        for step_idx in range(max_new_tokens):
            logits = last_logits.float()
            if no_repeat_ngram_size == 1:
                logits = torch.where(seen, NEG_INF, logits)
            elif no_repeat_ngram_size > 0:
                logits = torch.where(_ngram_ban(seq_buf, t + step_idx, pad_start, no_repeat_ngram_size, vocab),
                                     NEG_INF, logits)
            if repetition_penalty != 1.0:
                rp = torch.tensor(repetition_penalty, dtype=torch.float32, device=dev)
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
    sync()
    if timings is not None:
        timings["prefill_s"] = t1 - t0
        timings["decode_s"] = time.perf_counter() - t1
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1) if toks else ids
