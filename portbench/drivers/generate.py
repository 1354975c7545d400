"""Generation: ``ContinuousEngine.submit`` over an int8c causal reader, as
``serve --continuous-slots`` builds it, in a closed loop (``clients``
requests in flight, each completion sending the next) or an open loop
(Poisson arrivals at the mix's ``rate``).

Set-up draws the reader's float weights on the card layer by layer from
the seed and quantizes each as the deployment does (the port's
``quantize_weight``), then warms every prompt bucket the traffic uses and
the decode chunks, plain, sampled and speculative.

The window reports, by the host's clock: in a closed loop the tokens
emitted per second up to the last harvest in the window
(``gen_tokens_s``); in an open loop the 90th percentile of the time from
each request's due time to its first token, over every request due in the
window (``ttft_p90_ms``): a window holds some 120 of them, so ten or more
lie beyond it.  After an open window the engine finishes the
first tokens of every request due, waiting up to a minute.

A traced run profiles the device alone, over the whole window: the
profiler starts before the first request and stops once the engine's
thread has ended.  Started or stopped while that thread launched kernels,
it crashed the process (two runs in seven, NVIDIA H100, PyTorch 2.11).

The check takes the greedy requests that finished (a ``sample`` of them
drawn from the seed, the longest always among them) and judges
``logit_gap``: the widest gap by which a served token's logit lies below
the reference's best logit at its position, the reference being the full
float32 forward pass of prompt and served tokens with the same int8c
weights, worked out again from the seed's float weights.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import inputs, roofline, stats, traffic
from portbench.reference import mpt as ref_mpt


def model_config(c: dict):
    from vietnamese_qa_system_tpu_torch.models.config import ModelConfig

    return ModelConfig(
        arch="causal", vocab_size=c["vocab_size"], d_model=c["d_model"], n_heads=c["n_heads"],
        n_layers=c["n_layers"], d_ff=c["d_model"] * c["expansion_ratio"], max_seq_len=c["max_seq_len"],
        positional="alibi", alibi_mode="mpt", alibi_bias_max=c["attn_config"]["alibi_bias_max"],
        attention_bias=False, norm_eps=c["layer_norm_eps"], tie_embeddings=True, activation="gelu",
        use_flash_attention=c["deployment"]["use_flash_attention"], scan_layers=True)


def build_reader(ctx):
    """The reader over the seed's weights, each layer quantized as soon as
    it is drawn, so one float layer at a time is held."""
    from vietnamese_qa_system_tpu_torch.models import causal_from_state_dict
    from vietnamese_qa_system_tpu_torch.models.quantize import quantize_weight

    c, mode = ctx.config, ctx.config["deployment"]["quantize"]
    state = {}
    for name, t in inputs.mpt_outer(c, ctx.seed, ctx.device).items():
        state[name] = t
    for i in range(c["n_layers"]):
        for name, t in inputs.mpt_layer(c, ctx.seed, i, ctx.device).items():
            if name.endswith(".w"):
                for key, leaf in quantize_weight(t, mode).items():
                    state[f"blocks.{i}.{name[:-1]}{key}"] = leaf
            else:
                state[f"blocks.{i}.{name}"] = t
    return causal_from_state_dict(state, model_config(c))


class _Req:
    """One request's record: its spec, due and submit times, the time of
    every token, its outcome."""

    __slots__ = ("spec", "due", "sent", "times", "ids", "error", "done_t")

    def __init__(self, spec: dict, due: float):
        self.spec, self.due, self.sent = spec, due, None
        self.times: list[float] = []
        self.ids = self.error = self.done_t = None

    def on_token(self, _tok) -> None:
        self.times.append(time.perf_counter())


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dep = ctx.config["deployment"]
        self.mix = ctx.traffic

    def setup(self):
        ctx = self.ctx
        with ctx.part("import"):
            from vietnamese_qa_system_tpu_torch.engine.continuous import ContinuousEngine  # noqa: F401
        if not ctx.dry:
            with ctx.part("kernels"):
                from vietnamese_qa_system_tpu_torch.ops import cuda_kernels

                cuda_kernels.library()
        with ctx.part("weights"):
            self.model = build_reader(ctx)
        with ctx.part("traffic"):
            self.specs = traffic.requests(self.mix, ctx.seed, ctx.config["vocab_size"])
            if self.mix["loop"] == "open":
                self.gaps = traffic.gaps(self.mix, ctx.seed, self.mix["rate"])
        with ctx.part("engine"):
            self.engine = self.new_engine()
        with ctx.part("warmup"):
            self.warm()

    def new_engine(self):
        from vietnamese_qa_system_tpu_torch.engine.continuous import ContinuousEngine

        d = self.dep
        return ContinuousEngine(self.model, self.model.cfg, n_slots=d["n_slots"], total=d["total"],
                                chunk_steps=d["chunk_steps"], eos_id=d["eos_id"], speculative=d["speculative"],
                                kv_dtype=d["kv_dtype"], prefix_cache_mb=d["prefix_cache_mb"],
                                prefill_chunk=d["prefill_chunk"], seed=self.ctx.seed, device=self.ctx.device)

    def warm(self):
        """Every prompt bucket the traffic reaches, greedy alone (speculative
        chunks) and beside a sampled request (plain sampled chunks)."""
        eng = self.engine
        buckets = sorted({min(b for b in eng.buckets if b >= len(s["ids"])) for s in self.specs})
        greedy = next(s for s in self.specs if s["greedy"])
        sampled = next(s for s in self.specs if not s["greedy"])
        for b in buckets:
            ids = (greedy["ids"] * (b // len(greedy["ids"]) + 1))[:b]
            eng.submit(ids, 2, temperature=0.0).result()
        futs = [eng.submit(greedy["ids"], 2, temperature=0.0),
                eng.submit(sampled["ids"], 2, temperature=sampled["temperature"], top_p=sampled["top_p"])]
        for f in futs:
            f.result()

    # ---------------------------------------------------------------- window

    def _submit(self, r: _Req) -> None:
        s = r.spec
        r.sent = time.perf_counter()
        try:
            fut = self.engine.submit(s["ids"], s["max_new"], stream=r.on_token, temperature=s["temperature"],
                                     top_p=s["top_p"])
        except Exception as exc:  # noqa: BLE001 -- a refused request is a failed one
            r.error, r.done_t = exc, time.perf_counter()
            return
        fut.add_done_callback(lambda f, r=r: self._finished(r, f))

    def _finished(self, r: _Req, fut) -> None:
        exc = fut.exception()
        if exc is None:
            r.ids = fut.result()["ids"]
        else:
            r.error = exc
        r.done_t = time.perf_counter()
        if self.mix["loop"] == "closed":
            with self.lock:
                if self.open:
                    self._next_closed()

    def _next_closed(self) -> None:
        r = _Req(self.specs[len(self.reqs) % len(self.specs)], time.perf_counter())
        self.reqs.append(r)
        self._submit(r)

    def window(self, seconds: float, drain_s: float = 60.0) -> dict:
        ctx, mix = self.ctx, self.mix
        self.reqs: list[_Req] = []
        self.lock = threading.Lock()
        self.open = True
        st0 = self.engine.snapshot_stats()
        # profiling starts and stops only while the engine's thread launches nothing
        ctx.tracer.start("the whole window, started before the first request and stopped once the engine had "
                         "closed", lean=True)
        t0 = time.perf_counter()
        end = t0 + seconds
        due, i = t0, 0
        self.queue = []  # (s into the window, requests waiting, slots busy), twice a second
        next_q = t0

        def sample_queue():
            nonlocal next_q
            now = time.perf_counter()
            if now >= next_q:
                st = self.engine.snapshot_stats()
                self.queue.append((now - t0, st["pending"], st["active_slots"]))
                next_q += 0.5

        # this thread sleeps until its next sample, arrival or the window's end: each of its wake-ups takes the
        # interpreter's lock from the engine's thread, which launches every kernel
        if mix["loop"] == "closed":
            with self.lock:
                for _ in range(mix["clients"]):
                    self._next_closed()
            while (now := time.perf_counter()) < end:
                sample_queue()
                time.sleep(max(min(next_q, end) - now, 0.0))
        else:
            while due < end:
                sample_queue()
                now = time.perf_counter()
                if now < due:
                    time.sleep(max(min(due, next_q) - now, 0.0))
                    continue
                r = _Req(self.specs[i % len(self.specs)], due)
                self.reqs.append(r)
                self._submit(r)
                due += float(self.gaps[i % len(self.gaps)])
                i += 1
        with self.lock:
            self.open = False
        st1 = self.engine.snapshot_stats()
        if mix["loop"] == "open":
            # every request due in the window gets its first token, or a minute
            limit = time.perf_counter() + drain_s
            while any(not r.times and r.done_t is None for r in self.reqs) and time.perf_counter() < limit:
                time.sleep(0.1)
        t_close = time.perf_counter()
        self.engine.close()
        ctx.tracer.stop()
        self.traced_chunks = self.engine.snapshot_stats()["chunks"] - st0["chunks"]
        return self._summary(t0, t_close, seconds, st0, st1)

    def _summary(self, t0, t_close, seconds, st0, st1) -> dict:
        ctx, c = self.ctx, self.ctx.config
        end = t0 + seconds
        closed = self.mix["loop"] == "closed"
        in_window = [t for r in self.reqs for t in r.times if t <= end]
        last = max(in_window) if in_window else end
        span = last - t0
        # a request that the engine's close cut at the window's end is not a failed one
        failed = sum(1 for r in self.reqs if r.error is not None and r.done_t < t_close)
        counted = self.reqs if closed else [r for r in self.reqs if r.due <= end]
        ttft = [(r.times[0] - r.due) * 1e3 for r in counted if r.times]
        if not closed:
            failed += sum(1 for r in counted if not r.times and r.error is None)
        # operations of the window: prefills whose first token came in it, then every decoded token
        n_tok, ctx_sum = 0, 0
        for r in self.reqs:
            n = len(r.spec["ids"])
            ts = [t for t in r.times if t <= last]
            if ts and r.times[0] >= t0:
                n_tok += n
                ctx_sum += n * (n + 1) // 2
            n_tok += max(len(ts) - 1, 0)
            ctx_sum += sum(n + j for j in range(1, len(ts)))
        chunks = st1["chunks"] - st0["chunks"]
        occ = (st1["occupancy_sum"] - st0["occupancy_sum"]) / chunks if chunks else None
        late = [r.sent - r.due for r in self.reqs if r.sent is not None]
        spec = st1["spec_chunks"] - st0["spec_chunks"]
        ctx.log(f"generate: {len(self.reqs)} requests, {len(counted)} due in the window, {len(in_window)} tokens by "
                f"the last harvest {span:.3f} s in, {chunks} chunks ({spec} speculative), generator late by at most "
                f"{max(late) * 1e3 if late else 0:.1f} ms, closed {t_close - t0:.1f} s in")
        metrics = {}
        if closed:
            metrics["gen_tokens_s"] = len(in_window) / span
        elif ttft:
            metrics["ttft_p90_ms"] = stats.percentile(ttft, 90)
        rec = {"elapsed_s": span, "flops": roofline.decoder_flops(c, n_tok, ctx_sum), "occupancy": occ,
               "ttft_ms": ttft, "requests": len(counted), "queue": self.queue,
               "traced_chunks": self.traced_chunks if ctx.tracer.done else None}
        return {"metrics": metrics, "attempted": len(counted), "failed": failed, "record": rec}

    def release(self):
        self.engine = None
        self.model = None

    # ----------------------------------------------------------------- check

    def sample(self) -> list[_Req]:
        done = [r for r in self.reqs if r.spec["greedy"] and r.ids is not None]
        if not done:
            return []
        rng = np.random.default_rng([self.ctx.seed, 13])
        longest = max(range(len(done)), key=lambda j: (len(done[j].ids), -j))
        rest = [j for j in range(len(done)) if j != longest]
        pick = [longest] + list(rng.permutation(rest)[: self.ctx.workload["check"]["sample"] - 1])
        return [done[j] for j in sorted(pick)]

    def check(self, mode: str | None = None) -> list:
        """``logit_gap`` of the served greedy tokens; with ``mode="int4c"``
        the control instead: the reference with int4 column-scaled weights
        in the program's place, at the same positions, its own best token."""
        ctx, c = self.ctx, self.ctx.config
        lim = ctx.workload["check"]["limits"]
        picked = self.sample()
        if not picked:
            ctx.log("generate check: no greedy request finished in the window")
            return [("logit_gap", float("inf"), lim["logit_gap"])]
        seqs = [r.spec["ids"] + r.ids[:-1] for r in picked]
        outer = inputs.mpt_outer(c, ctx.seed, ctx.device)
        modes = ("int8c",) if mode is None else ("int8c", mode)
        hidden = ref_mpt.final_hidden(c, outer, lambda i: inputs.mpt_layer(c, ctx.seed, i, ctx.device), seqs, modes)
        gap, n = 0.0, 0
        for k, r in enumerate(picked):
            p = len(r.spec["ids"])
            at = slice(p - 1, p - 1 + len(r.ids))
            ref = ref_mpt.logits(outer, hidden["int8c"][k][at])
            served = torch.as_tensor(r.ids, device=ref.device)
            if mode is not None:
                served = ref_mpt.logits(outer, hidden[mode][k][at]).argmax(dim=-1)
            g = ref.max(dim=-1).values - ref.gather(1, served[:, None])[:, 0]
            gap = max(gap, g.max().item())
            n += len(r.ids)
        ctx.log(f"generate check: {len(picked)} greedy requests, {n} served tokens")
        return [("logit_gap", gap, lim["logit_gap"])]
