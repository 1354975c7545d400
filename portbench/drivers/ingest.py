"""Index build: a closed loop of ``IngestPipeline.add_documents`` calls into
a flat ``VectorStore`` that set-up pre-fills, with a sqlite docstore under
``TMPDIR``.

Every call chunks ``chunks_per_call`` paragraphs (one chunk each at the
deployment's chunk size and overlap), embeds the chunks at the ingest
``max_len`` and writes vectors and texts.  The window reports passages
indexed per second over all its calls; a store that fills up fails the run
loudly.

The check judges every call of the window:

- ``chunk_mismatch``: chunks whose stored text differs from the reference
  chunker's chunk of the same documents, or a call that indexed another
  number of chunks;
- ``id_mismatch``: ids that are not the next free ids in order;
- ``vec_gap``: for ``sample`` chunks a call (drawn from the seed), the
  widest distance between the vector the store holds and the reference
  encoder's unit vector of the reference chunk.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import inputs, roofline, traffic
from portbench.drivers.search import build_encoder, fill_store
from portbench.reference import encoder as ref_encoder
from portbench.reference import text as ref_text


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dep = ctx.config["deployment"]

    def setup(self):
        ctx = self.ctx
        with ctx.part("import"):
            from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer
            from vietnamese_qa_system_tpu_torch.engine.docstore import DocStore
            from vietnamese_qa_system_tpu_torch.engine.ingest import IngestPipeline
        if not ctx.dry:
            with ctx.part("kernels"):
                from vietnamese_qa_system_tpu_torch.ops import cuda_kernels

                cuda_kernels.library()
        with ctx.part("weights"):
            self.encoder = build_encoder(ctx)
        with ctx.part("corpus"):
            self.prefill = ctx.workload["prefill_rows"]
            self.store = fill_store(ctx, self.prefill)
        with ctx.part("traffic"):
            mix = ctx.traffic
            self.calls_docs = [traffic.documents(mix, ctx.seed, i) for i in range(mix["pool_calls"])]
            warm = traffic.documents(mix, ctx.seed, mix["pool_calls"])
        self.tmp = tempfile.mkdtemp(prefix="portbench-ingest-")
        self.docstore = DocStore(os.path.join(self.tmp, "docs.sqlite"))
        self.pipe = IngestPipeline(self.encoder, ByteTokenizer(), self.store, self.docstore,
                                   batch_size=self.dep["batch_size"], max_len=self.dep["ingest_max_len"])
        self.embed_s = 0.0
        embed, index = self.pipe.embed_texts, self.pipe.index_vectors

        def embed_texts(texts):
            t = time.perf_counter()
            with torch.profiler.record_function("pb.embed_texts"):
                v = embed(texts)
            self.embed_s += time.perf_counter() - t
            return v

        def index_vectors(vecs, texts, sources=None):
            with torch.profiler.record_function("pb.index_vectors"):
                return index(vecs, texts, sources)

        self.pipe.embed_texts, self.pipe.index_vectors = embed_texts, index_vectors
        with ctx.part("warmup"):
            # the encoder at the ingest batch and max_len, then back to the pre-filled size
            self.pipe.embed_texts(ref_text.chunks(warm[0], self.dep["chunk_size"], self.dep["overlap"])
                                  [: self.dep["batch_size"]])

    def window(self, seconds: float) -> dict:
        ctx, dep = self.ctx, self.dep
        trace_at, trace_n = ctx.workload["trace"]["from_call"], ctx.workload["trace"]["calls"]
        self.embed_s = 0.0
        self.returned = []  # ids of each call
        calls, indexed = 0, 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end or (ctx.tracer.enabled and not ctx.tracer.done):
            if calls == trace_at:
                ctx.tracer.start(f"ingest calls {trace_at}..{trace_at + trace_n - 1} of the window")
            docs = self.calls_docs[calls % len(self.calls_docs)]
            with torch.profiler.record_function("pb.add_documents"):
                ids = self.pipe.add_documents(docs, chunk_size=dep["chunk_size"], overlap=dep["overlap"])
            if calls == trace_at + trace_n - 1:
                ctx.tracer.stop()
            calls += 1
            indexed += len(ids)
            self.returned.append(np.asarray(ids))
        elapsed = time.perf_counter() - t0 - ctx.tracer.overhead_s
        self.calls = calls
        # the timed path's vectors of the sampled chunks, read back from the store
        rng = np.random.default_rng([ctx.seed, 12])
        per = ctx.workload["check"]["sample"]
        self.sample = [np.sort(rng.choice(len(r), min(per, len(r)), replace=False)) for r in self.returned]
        self.stored = [self.store.get_vectors(r[s]) if len(r) else np.zeros((0, self.store.dim), np.float32)
                       for r, s in zip(self.returned, self.sample)]
        self.stored_text = [self.docstore.get(r) for r in self.returned]
        lens, k4 = [], []
        for i in range(calls):
            chunks = self.expected(i)
            ln = [min(len(t.encode()), dep["ingest_max_len"]) for t in chunks]
            lens += ln
            if trace_at <= i < trace_at + trace_n:
                k4 += [ln[j: j + dep["batch_size"]] for j in range(0, len(ln), dep["batch_size"])]
        flops = roofline.encoder_flops(ctx.config, lens)
        n = ctx.traffic["chunks_per_call"] * calls
        return {"metrics": {"ingest_passages_s": indexed / elapsed},
                "attempted": n, "failed": n - indexed,
                "record": {"elapsed_s": elapsed, "embed_s": self.embed_s, "flops": flops, "traced_block_lens": k4}}

    def expected(self, i: int) -> list[str]:
        docs = self.calls_docs[i % len(self.calls_docs)]
        return [c for d in docs for c in ref_text.chunks(d, self.dep["chunk_size"], self.dep["overlap"])]

    def release(self):
        self.pipe = self.store = self.encoder = None
        self.docstore.close()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self, mode: str | None = None) -> list:
        """The numbers compared; ``mode="fp8"`` is the control: the reference
        encoder in the program's place with its products in fp8."""
        ctx, c, dep = self.ctx, self.ctx.config, self.dep
        lim = ctx.workload["check"]["limits"]
        chunk_bad = id_bad = 0
        at = self.prefill
        texts, got = [], []
        for i in range(self.calls):
            want = self.expected(i)
            ids, stored = self.returned[i], self.stored_text[i]
            if len(ids) != len(want):
                chunk_bad += abs(len(want) - len(ids)) + 1
            chunk_bad += sum(1 for a, b in zip(stored, want) if a != b)
            id_bad += int((ids != np.arange(at, at + len(ids))).sum())
            at += len(want)
            keep = [n for n, j in enumerate(self.sample[i]) if j < len(want)]
            texts += [want[self.sample[i][n]] for n in keep]
            got.append(self.stored[i][keep])
        tid, tmask = (torch.as_tensor(x, device=ctx.device) for x in ref_text.byte_ids(texts, dep["ingest_max_len"]))
        w = inputs.encoder_weights(c, ctx.seed, ctx.device)
        want_v = ref_encoder.encode(w, c, tid, tmask, block=32)
        if mode == "fp8":
            v = ref_encoder.encode(w, c, tid, tmask, mode="fp8", block=32).to(torch.bfloat16).float()
        else:
            v = torch.as_tensor(np.concatenate(got), device=ctx.device)
        gap = (v - want_v).norm(dim=1).max().item() if len(texts) else float("inf")
        ctx.log(f"ingest check: {self.calls} calls, {len(texts)} sampled chunks")
        return [("chunk_mismatch", float(chunk_bad), lim["chunk_mismatch"]),
                ("id_mismatch", float(id_bad), lim["id_mismatch"]), ("vec_gap", gap, lim["vec_gap"])]
