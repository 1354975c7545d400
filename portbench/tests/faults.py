"""A dry run with the timed path broken underneath, for the tests:

    python3 -m portbench.tests.faults <fault> <workload> <seed>

applies one fault to the port, then runs the harness as ``run.py --dry``
does.  The faults a cell can have:

- ``answer_altered``: a search returns one altered id;
- ``half_batch``: the encoder leaves half of each query batch out (zero
  vectors, as a mean over the other half would stand for them);
- ``state_unchanged``: the vector store's add returns ids and writes
  nothing;
- ``chunk_altered``: the docstore stores one chunk's text altered;
- ``token_altered``: a decode chunk emits one token that the model did not
  choose.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def answer_altered():
    from vietnamese_qa_system_tpu_torch.engine.store import VectorStore

    orig = VectorStore.topk

    def topk(self, *a, **kw):
        s, i = orig(self, *a, **kw)
        i = i.clone()
        i[:, 0] = (i[:, 0] + 1) % self.size
        return s, i

    VectorStore.topk = topk


def half_batch():
    from vietnamese_qa_system_tpu_torch.engine import query

    orig = query.embed_batches

    def embed(encoder, tok, texts, batch_size, max_len):
        v = orig(encoder, tok, texts, batch_size, max_len)
        v[len(v) // 2:] = 0.0
        return v

    query.embed_batches = embed


def state_unchanged():
    from vietnamese_qa_system_tpu_torch.engine.ingest import IngestPipeline

    orig = IngestPipeline.index_vectors

    def index_vectors(self, vecs, texts, sources=None):
        store = self.store

        def add(vectors):  # the next ids, and nothing written
            ids = np.arange(store.size, store.size + len(vectors), dtype=np.int64)
            store.size += len(vectors)
            return ids

        store.add = add
        try:
            return orig(self, vecs, texts, sources)
        finally:
            del store.add

    IngestPipeline.index_vectors = index_vectors


def chunk_altered():
    from vietnamese_qa_system_tpu_torch.engine.docstore import DocStore

    orig = DocStore.insert

    def insert(self, ids, docs, sources=None):
        docs = list(docs)
        docs[0] = docs[0] + " x"
        return orig(self, ids, docs, sources)

    DocStore.insert = insert


def token_altered():
    from vietnamese_qa_system_tpu_torch.engine import continuous
    from vietnamese_qa_system_tpu_torch.models import decode_engine as de

    orig = de.decode_chunk

    def decode_chunk(model, state, *a, **kw):
        toks = orig(model, state, *a, **kw).clone()
        toks[:, 1] = (toks[:, 1] + 1) % model.cfg.vocab_size
        return toks

    continuous.de.decode_chunk = decode_chunk
    orig_spec = de.decode_chunk_spec

    def decode_chunk_spec(model, state, **kw):
        vals, counts = orig_spec(model, state, **kw)
        vals = vals.clone()
        vals[:, 0, 0] = (vals[:, 0, 0] + 1) % model.cfg.vocab_size
        return vals, counts

    continuous.de.decode_chunk_spec = decode_chunk_spec


FAULTS = {f.__name__: f for f in (answer_altered, half_batch, state_unchanged, chunk_altered, token_altered)}

if __name__ == "__main__":
    fault, workload, seed = sys.argv[1:4]
    FAULTS[fault]()
    from portbench import harness

    sys.exit(harness.main(["--workload", workload, "--seed", seed, "--seconds", "2", "--trace", "0", "--dry"],
                          time.perf_counter()))
