"""Command-line interface of the port: ``ingest`` and ``serve``.

Counterpart of ``vietnamese_qa_system_tpu/cli/main.py:535-931``::

    python -m vietnamese_qa_system_tpu_torch.cli ingest --inputs docs.jsonl \\
        --index idx --db docs.sqlite --encoder mpnet --dtype int8_global
    python -m vietnamese_qa_system_tpu_torch.cli serve --index idx \\
        --db docs.sqlite --encoder mpnet --port 8080

Both take ``--device`` (default ``cuda``; a missing GPU raises).  Hybrid
BM25 retrieval, IVF indexes, HF weight directories and the reader LM are
not ported yet and raise where the JAX CLI would use them.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from typing import Optional

# presets of the retrieval encoders (cli/main.py:547-551)
ENCODERS = ("tiny", "minilm", "mpnet")


def _encoder(spec: str, seed: int, device):
    from ..core.device import make_generator
    from ..models import init_encoder, minilm_class, mpnet_class, tiny_test

    if os.path.isdir(spec):
        raise NotImplementedError(
            f"loading HF encoder weights ({spec}) is not ported yet; use a preset: {', '.join(ENCODERS)}"
        )
    presets = {"tiny": lambda: tiny_test("encoder"), "minilm": minilm_class, "mpnet": mpnet_class}
    if spec not in presets:
        raise SystemExit(f"unknown encoder {spec!r}: use one of {', '.join(ENCODERS)}")
    return init_encoder(presets[spec](), make_generator(seed), device=device)


def _tokenizer(spec: str):
    from ..data import ByteTokenizer, HFTokenizer

    return ByteTokenizer() if spec == "byte" else HFTokenizer(spec)


def _load_rows(path: str) -> list:
    """A JSON array or JSON-lines file (a copy of etl/parser.py
    load_json_or_jsonl, whose package imports jax)."""
    with open(path, encoding="utf-8") as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


def cmd_ingest(args) -> int:
    from ..core.device import resolve_device
    from ..engine import DocStore, IngestPipeline, VectorStore

    if args.hybrid:
        raise NotImplementedError("hybrid BM25 retrieval (--hybrid) is not ported yet")
    if args.shards != 1:
        raise NotImplementedError("a sharded store (--shards > 1) is not ported yet")
    device = resolve_device(args.device)
    encoder = _encoder(args.encoder, args.seed, device)
    tok = _tokenizer(args.tokenizer)
    if os.path.exists(os.path.join(args.index, "meta.json")):
        store = VectorStore.load(args.index, device=device)
    else:
        store = VectorStore(args.capacity, encoder.cfg.d_model, dtype=args.dtype, device=device)
    docstore = DocStore(args.db)
    pipe = IngestPipeline(encoder, tok, store, docstore, batch_size=args.batch_size, max_len=args.max_len)
    for path in args.inputs:
        rows = _load_rows(path)
        docs = [r[args.text_field] if isinstance(r, dict) else str(r) for r in rows]
        ids = pipe.add_documents(docs, [path] * len(docs), chunk_size=args.chunk_size)
        print(f"{path}: ingested {len(ids)} chunks (store size {store.size})")
    store.save(args.index)
    print(f"index saved -> {args.index}; docs in {args.db}")
    return 0


def _check_ported_index(args) -> None:
    """Refuse, loudly, what the JAX CLI would turn on but the port lacks."""
    if getattr(args, "ivf_index", None) is not None:
        raise NotImplementedError("IVF indexes (--ivf-index) are not ported yet")
    with open(os.path.join(args.index, "meta.json")) as f:
        if json.load(f).get("type") == "ivf":
            raise NotImplementedError(f"{args.index} is an IVF index; IVF is not ported yet")
    if args.hybrid_weight < 1.0 and os.path.exists(os.path.join(args.index, "bm25.json")):
        raise NotImplementedError(
            f"{args.index} has a bm25.json and --hybrid-weight {args.hybrid_weight} < 1 would turn on "
            "hybrid retrieval, which is not ported yet; pass --hybrid-weight 1.0 for dense-only search"
        )


def cmd_serve(args) -> int:
    from ..core.device import resolve_device
    from ..engine import DocStore, IngestPipeline, Retriever, ServingApp, VectorStore, make_server

    _check_ported_index(args)
    device = resolve_device(args.device)
    encoder = _encoder(args.encoder, args.seed, device)
    tok = _tokenizer(args.tokenizer)
    # shrink-to-fit by default: a query scans the stored corpus, not the
    # build-time headroom; --capacity N leaves room for POST /ingest
    store = VectorStore.load(args.index, capacity=args.capacity, device=device)
    docstore = DocStore(args.db)
    # in HTTP mode every dispatch pads to query_batch: size it to the
    # micro-batch cap
    qbatch = args.max_batch if args.port is not None else 256
    retriever = Retriever(encoder, tok, store, docstore, max_len=args.max_len, mode=args.search_mode,
                          query_batch=qbatch)
    if args.port is None:
        print(f"index: {store.size} vectors; type a query (empty line quits)")
        while True:
            try:
                query = input("query> ").strip()
            except EOFError:
                break
            if not query:
                break
            for rank, r in enumerate(retriever.search([query], k=args.k)[0]):
                doc = (r.doc or "")[:160].replace("\n", " ")
                print(f"  {rank + 1}. [{r.id}] score={r.score:.3f} {doc}")
        return 0

    ingest = IngestPipeline(encoder, tok, store, docstore, batch_size=args.max_batch, max_len=args.max_len)
    app = ServingApp(retriever, ingest=ingest, k=args.k, max_k=args.max_k, max_batch=args.max_batch,
                     max_wait_s=args.batch_wait_ms / 1000.0)
    httpd = make_server(app, host=args.host, port=args.port)
    print(
        f"serving {store.size} vectors on http://{httpd.server_address[0]}:{httpd.server_address[1]} "
        f"(max_batch={args.max_batch}, wait={args.batch_wait_ms}ms; endpoints: /healthz /search /ingest)",
        flush=True,
    )

    def _term(*_):
        # unwinds into the same except/finally as ^C, so /ingest writes persist
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        app.close()
        if app.dirty:
            store.save(args.index)
            print(f"index persisted -> {args.index} ({store.size} vectors)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vietnamese_qa_system_tpu_torch",
                                description="Vietnamese QA retrieval on PyTorch / CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("ingest", help="build the retrieval index")
    pi.add_argument("--inputs", nargs="+", required=True)
    pi.add_argument("--text-field", default="doc")
    pi.add_argument("--index", required=True)
    pi.add_argument("--db", required=True)
    pi.add_argument("--encoder", default="tiny", help="preset: tiny | minilm | mpnet")
    pi.add_argument("--tokenizer", default="byte")
    pi.add_argument("--capacity", type=int, default=1 << 20)
    pi.add_argument("--dtype", default="bf16", choices=["bf16", "int8", "int8_global", "int8_res"],
                    help="index compression: int8 halves memory; int8_res keeps bf16-equal memory but "
                         "scans half the bytes, a two-stage re-rank restores recall")
    pi.add_argument("--shards", type=int, default=1)
    pi.add_argument("--chunk-size", type=int, default=512)
    pi.add_argument("--batch-size", type=int, default=256)
    pi.add_argument("--max-len", type=int, default=128)
    pi.add_argument("--hybrid", action="store_true", help="BM25 term index (not ported yet)")
    pi.add_argument("--seed", type=int, default=42)
    pi.add_argument("--device", default="cuda")
    pi.set_defaults(fn=cmd_ingest)

    ps = sub.add_parser("serve", help="retrieval REPL, or the HTTP API with --port")
    ps.add_argument("--index", required=True)
    ps.add_argument("--ivf-index", default=None, help="IVF directory (not ported yet)")
    ps.add_argument("--db", required=True)
    ps.add_argument("--capacity", type=int, default=0,
                    help="index capacity at serve time: 0 = shrink to the stored corpus; larger leaves "
                         "headroom for POST /ingest")
    ps.add_argument("--encoder", default="tiny", help="preset: tiny | minilm | mpnet")
    ps.add_argument("--tokenizer", default="byte")
    ps.add_argument("--k", type=int, default=5)
    ps.add_argument("--max-len", type=int, default=128)
    ps.add_argument("--seed", type=int, default=42)
    ps.add_argument("--port", type=int, default=None,
                    help="serve the HTTP JSON API on this port instead of the REPL (0 = ephemeral)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--max-batch", type=int, default=32, help="max requests fused into one dispatch")
    ps.add_argument("--max-k", type=int, default=None, help="largest per-request k the API accepts")
    ps.add_argument("--batch-wait-ms", type=float, default=5.0,
                    help="how long a batch waits for co-riders after its first request")
    ps.add_argument("--hybrid-weight", type=float, default=0.5,
                    help="dense weight in hybrid fusion; hybrid is not ported yet, so an index with a "
                         "bm25.json needs 1.0")
    ps.add_argument("--search-mode", default="fast", choices=["fast", "turbo"],
                    help="kept for parity with the JAX CLI: every mode of the port is exact")
    ps.add_argument("--device", default="cuda")
    ps.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
