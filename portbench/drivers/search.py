"""Bulk search: a closed loop of ``Retriever.search(queries, k,
fetch_docs=False)`` calls over a flat ``VectorStore``.

Set-up draws the encoder's weights and the corpus on the card from the
seed, fills the store, and warms the encoder at the query batch and the
top-k scan once.  The window sends one call of ``batch`` queries after
another and reports the queries answered per second over all its calls.

The check takes, from every call of the window, the same ``sample``
query rows (drawn from the seed) and judges:

- ``enc_gap``: the widest distance between the unit query vector that the
  timed path encoded and the reference encoder's vector of the same
  text;
- ``topk_gap``: the widest shortfall of a returned id's score below the
  10th best score, all scores of the timed path's own query vector
  (rounded to bf16, as the store scans it) against the bf16 corpus, in
  float32, over every row.

The rank-count recall of the same ids is printed beside them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, roofline, traffic
from portbench.reference import encoder as ref_encoder
from portbench.reference import text as ref_text
from portbench.reference.rank import TopkJudge


def model_config(c: dict):
    """The port's ModelConfig of the mpnet configuration file."""
    from vietnamese_qa_system_tpu_torch.models.config import ModelConfig

    dep = c["deployment"]
    return ModelConfig(
        arch="encoder", vocab_size=c["vocab_size"], d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_layers=c["num_hidden_layers"], d_ff=c["intermediate_size"], max_seq_len=c["max_position_embeddings"],
        positional="learned", norm_eps=c["layer_norm_eps"], norm_position="post", embed_layernorm=True,
        position_offset=c["pad_token_id"] + 1, relative_attention_buckets=c["relative_attention_num_buckets"],
        use_flash_attention=dep["use_flash_attention"], activations_bf16=dep["activations_bf16"])


def build_encoder(ctx):
    from vietnamese_qa_system_tpu_torch.models.encoder import SentenceEncoder

    cfg = model_config(ctx.config)
    enc = SentenceEncoder(cfg, device="meta")
    enc.load_state_dict(inputs.encoder_weights(ctx.config, ctx.seed, ctx.device), strict=True, assign=True)
    return enc.eval().requires_grad_(False)


def fill_store(ctx, rows: int):
    from vietnamese_qa_system_tpu_torch.engine.store import VectorStore

    c, dep = ctx.config, ctx.config["deployment"]
    store = VectorStore(dep["capacity"], c["hidden_size"], dtype=dep["store_dtype"], device=ctx.device)
    for _, block in inputs.corpus_blocks(c["corpus"], c["hidden_size"], rows, ctx.seed, ctx.device):
        store.add(block)
    return store


def judge_topk(ctx, q: torch.Tensor, ids: torch.Tensor, rows: int, k: int) -> TopkJudge:
    """Both passes of a :class:`TopkJudge` over the corpus (drawn again),
    queries and rows rounded to bf16 as the store keeps and scans them."""
    c = ctx.config
    judge = TopkJudge(q.to(torch.bfloat16).float(), ids, k)
    for step in (judge.first, judge.second):
        for start, block in inputs.corpus_blocks(c["corpus"], c["hidden_size"], rows, ctx.seed, ctx.device):
            step(start, block.to(torch.bfloat16).float())
    return judge


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dep = ctx.config["deployment"]
        self.k = self.dep["k"]

    def setup(self):
        ctx = self.ctx
        with ctx.part("import"):
            from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
            from vietnamese_qa_system_tpu_torch.engine.query import Retriever
        if not ctx.dry:
            with ctx.part("kernels"):
                from vietnamese_qa_system_tpu_torch.ops import cuda_kernels

                cuda_kernels.library()
        with ctx.part("weights"):
            self.encoder = build_encoder(ctx)
        with ctx.part("corpus"):
            self.rows = ctx.config["corpus"]["rows"]
            self.store = fill_store(ctx, self.rows)
        with ctx.part("traffic"):
            self.batches = traffic.queries(ctx.traffic, ctx.seed)
            rng = np.random.default_rng([ctx.seed, 11])
            self.sample = np.sort(rng.choice(len(self.batches[0]), ctx.workload["check"]["sample"], replace=False))
        self.retriever = Retriever(self.encoder, ByteTokenizer(), self.store, None,
                                   max_len=self.dep["query_max_len"], query_batch=self.dep["batch_size"],
                                   mode=self.dep["mode"])
        self.encode_s = 0.0
        self.last_vecs = None
        inner = self.retriever.embed_queries

        def embed_queries(texts):
            t = time.perf_counter()
            with torch.profiler.record_function("pb.embed_queries"):
                v = inner(texts)
            self.encode_s += time.perf_counter() - t
            self.last_vecs = v
            return v

        self.retriever.embed_queries = embed_queries
        with ctx.part("warmup"):
            for _ in range(2):
                self.retriever.search(self.batches[0][: self.dep["batch_size"]], k=self.k, fetch_docs=False)

    def window(self, seconds: float) -> dict:
        ctx = self.ctx
        trace_at, trace_n = ctx.workload["trace"]["from_call"], ctx.workload["trace"]["calls"]
        lens = [[min(len(q.encode()), self.dep["query_max_len"]) for q in b] for b in self.batches]
        self.encode_s = 0.0
        calls, answered = 0, 0
        self.sampled = []  # (vectors, ids, texts) of the sample rows, call by call
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end or (ctx.tracer.enabled and not ctx.tracer.done):
            if calls == trace_at:
                ctx.tracer.start(f"search calls {trace_at}..{trace_at + trace_n - 1} of the window")
            qs = self.batches[calls % len(self.batches)]
            with torch.profiler.record_function("pb.search"):
                res = self.retriever.search(qs, k=self.k, fetch_docs=False)
            if calls == trace_at + trace_n - 1:
                ctx.tracer.stop()
            calls += 1
            answered += sum(1 for r in res if len(r) == self.k)
            self.sampled.append((self.last_vecs[self.sample].copy(),
                                 np.array([[x.id for x in res[i]] for i in self.sample], np.int64),
                                 [qs[i] for i in self.sample]))
        # the profiler's start and stop are not the program's time
        elapsed = time.perf_counter() - t0 - ctx.tracer.overhead_s
        c = ctx.config
        valid = [n for b in range(calls) for n in lens[b % len(lens)]]
        flops = roofline.encoder_flops(c, valid) + roofline.scan_flops(answered, self.rows, c["hidden_size"])
        n_q = len(self.batches[0]) * calls
        return {"metrics": {"search_qps": answered / elapsed},
                "attempted": n_q, "failed": n_q - answered,
                "record": {"elapsed_s": elapsed, "encode_s": self.encode_s, "flops": flops}}

    def release(self):
        self.retriever = self.store = self.encoder = None

    def check(self, mode: str | None = None) -> list:
        """The numbers compared; ``mode="fp8"`` is the control: the reference
        in the program's place, its encoder's products and the scan in fp8."""
        ctx, c = self.ctx, self.ctx.config
        lim = ctx.workload["check"]["limits"]
        vecs = torch.as_tensor(np.concatenate([v for v, _, _ in self.sampled]), device=ctx.device)
        ids = torch.as_tensor(np.concatenate([i for _, i, _ in self.sampled]), device=ctx.device)
        texts = [t for _, _, ts in self.sampled for t in ts]
        w = inputs.encoder_weights(c, ctx.seed, ctx.device)
        tid, tmask = (torch.as_tensor(x, device=ctx.device) for x in ref_text.byte_ids(texts, self.dep["query_max_len"]))
        want = ref_encoder.encode(w, c, tid, tmask)
        if mode == "fp8":
            vecs = ref_encoder.encode(w, c, tid, tmask, mode="fp8")
            ids = self.control_topk(vecs)
        del w
        enc_gap = (vecs.float() - want).norm(dim=1).max().item()
        judge = judge_topk(ctx, vecs, ids, self.rows, self.k)
        ctx.log(f"search check: {len(texts)} queries from {len(self.sampled)} calls; rank-count recall@{self.k} "
                f"{judge.recall():.6f}")
        return [("enc_gap", enc_gap, lim["enc_gap"]), ("topk_gap", judge.shortfall(), lim["topk_gap"])]

    def control_topk(self, vecs: torch.Tensor) -> torch.Tensor:
        """The control's own top-k: fp8 queries against the fp8 corpus."""
        ctx, c = self.ctx, self.ctx.config
        best_s = torch.full((vecs.shape[0], self.k), float("-inf"), device=ctx.device)
        best_i = torch.zeros((vecs.shape[0], self.k), dtype=torch.long, device=ctx.device)
        q = ref_encoder.fake_fp8(vecs.float(), -1)
        for start, block in inputs.corpus_blocks(c["corpus"], c["hidden_size"], self.rows, ctx.seed, ctx.device):
            s = q @ ref_encoder.fake_fp8(block, -1).T
            cand_s = torch.cat([best_s, s], dim=1)
            cand_i = torch.cat([best_i, torch.arange(start, start + block.shape[0], device=ctx.device)
                                .expand(vecs.shape[0], -1)], dim=1)
            best_s, pos = torch.topk(cand_s, self.k, dim=1)
            best_i = torch.gather(cand_i, 1, pos)
        return best_i
