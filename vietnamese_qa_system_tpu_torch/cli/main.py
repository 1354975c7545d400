"""Command-line interface of the port: ``ingest``, ``build-ivf``, ``serve``
and ``chat``.

Counterpart of ``vietnamese_qa_system_tpu/cli/main.py:535-1044``::

    python -m vietnamese_qa_system_tpu_torch.cli ingest --inputs docs.jsonl \\
        --index idx --db docs.sqlite --encoder mpnet --dtype int8_global
    python -m vietnamese_qa_system_tpu_torch.cli build-ivf --index idx --out ivf
    python -m vietnamese_qa_system_tpu_torch.cli serve --index idx \\
        --ivf-index ivf --db docs.sqlite --encoder mpnet --port 8080 \\
        --reader-size phogpt4b --reader-quantize int8c
    python -m vietnamese_qa_system_tpu_torch.cli chat --model-size phogpt4b \\
        --quantize int8c

Each takes ``--device`` (default ``cuda``; a missing GPU raises).  The
reader answers with random weights drawn from ``--seed`` on the device,
layer by layer (quantized as each layer is made).  Hybrid BM25 retrieval,
sharded indexes, HF weight directories, reader checkpoints, nf4 weights,
speculative decoding and draft models, sharded readers and the continuous
engine behind ``/generate`` are not ported yet and raise where the JAX CLI
would use them; seq2seq readers and beam search have no flag yet.
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
# presets of the causal readers (cli/main.py:171-182, :710-720)
READERS = ("tiny", "gpt125m", "gptneo125m", "pythia410m", "llama1b", "qwen2-05b", "bloom560m", "phogpt4b")


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


def _reader(size: str, tok, seed: int, device, quantize: Optional[str]):
    """A causal reader with random weights drawn on ``device`` from
    ``seed``, quantized layer by layer as it is made."""
    import dataclasses

    from ..core.device import make_generator
    from ..models import config as mcfg
    from ..models import init_causal_lm

    presets = {
        "tiny": lambda: mcfg.tiny_test("causal"), "gpt125m": mcfg.gpt_125m_class, "gptneo125m": mcfg.gpt_neo_125m,
        "pythia410m": mcfg.pythia_410m_class, "llama1b": mcfg.llama_1b_class, "qwen2-05b": mcfg.qwen2_05b_class,
        "bloom560m": mcfg.bloom_560m_class, "phogpt4b": mcfg.phogpt_4b_class,
    }
    cfg = presets[size]()
    if tok.vocab_size > cfg.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size)
    print("(no reader checkpoint: answering with RANDOM weights)", flush=True)
    model = init_causal_lm(cfg, make_generator(seed, device), quantize=quantize)
    if quantize:
        print(f"reader decodes over a {quantize} base", flush=True)
    return model


def _refuse(args, flags: dict) -> None:
    """Raise for a JAX CLI option the port has no counterpart for yet."""
    for flag, (attr, idle) in flags.items():
        if getattr(args, attr) != idle:
            raise NotImplementedError(f"{flag} is not ported yet")


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


def cmd_build_ivf(args) -> int:
    """Cluster a flat index into an IVF index (``serve`` loads either
    directory by its meta.json type)."""
    from ..core.device import resolve_device
    from ..engine import IVFIndex, VectorStore

    if args.shards != 1:
        raise NotImplementedError("a sharded IVF index (--shards > 1) is not ported yet")
    store = VectorStore.load(args.index, capacity=0, device=resolve_device(args.device))
    ivf = IVFIndex.build(store, n_clusters=args.clusters, nprobe=args.nprobe, cap_mult=args.cap_mult,
                         kmeans_iters=args.kmeans_iters, seed=args.seed)
    ivf.save(args.out)
    print(f"IVF index saved -> {args.out}: {ivf.size} vectors, {ivf.n_clusters} clusters x cap {ivf.cap}, "
          f"{ivf.spill_count} spilled ({100.0 * ivf.spill_count / max(ivf.size, 1):.2f}%), "
          f"default nprobe {ivf.nprobe}")
    return 0


def _serving_index(args, device, query_batch: int):
    """The index ``serve`` answers from: ``--index`` as saved (flat or IVF),
    or with ``--ivf-index`` the flat store or the IVF index, by
    ``--index-select`` (``auto``: the card's measured crossover)."""
    from ..engine import IVF_KAPPA, IVFIndex, VectorStore, ivf_crossover_batch, load_index, select_serving_index

    store = load_index(args.index, capacity=args.capacity, device=device)
    if args.ivf_index is not None:
        ivf = load_index(args.ivf_index, device=device)
        if not isinstance(ivf, IVFIndex):
            raise SystemExit(f"--ivf-index {args.ivf_index} is not an IVF directory (build-ivf output)")
        if not isinstance(store, VectorStore):
            raise SystemExit("--index must be the FLAT store when --ivf-index is given")
        if args.index_select == "auto":
            chosen, cross = select_serving_index(store, ivf, query_batch)
        else:
            chosen, cross = (store if args.index_select == "flat" else ivf), None
        kind = "ivf" if chosen is ivf else "flat"
        print(f"index-select: {kind} (query batch {query_batch}"
              + (f", crossover ~{cross}" if cross is not None else ", forced") + ")", flush=True)
        return chosen
    if isinstance(store, IVFIndex):
        cross = ivf_crossover_batch(store)
        if query_batch > cross:
            print(f"WARNING: IVF index with query batch {query_batch} > crossover ~{cross} (= {store.size} rows / "
                  f"(nprobe {store.nprobe} * cap {store.cap} * {IVF_KAPPA})); the flat scan answers such batches "
                  "faster. Lower --max-batch, rebuild with a smaller build-ivf --nprobe, or pass the flat dir as "
                  "--index with --ivf-index for automatic selection.", flush=True)
    return store


def _check_ported_index(args) -> None:
    """Refuse, loudly, what the JAX CLI would turn on but the port lacks."""
    if args.hybrid_weight < 1.0 and os.path.exists(os.path.join(args.index, "bm25.json")):
        raise NotImplementedError(
            f"{args.index} has a bm25.json and --hybrid-weight {args.hybrid_weight} < 1 would turn on "
            "hybrid retrieval, which is not ported yet; pass --hybrid-weight 1.0 for dense-only search"
        )


def cmd_serve(args) -> int:
    from ..core.device import resolve_device
    from ..engine import DocStore, IngestPipeline, QAPipeline, Retriever, ServingApp, VectorStore, make_server

    _check_ported_index(args)
    _refuse(args, {
        "--reader-params": ("reader_params", None), "--reader-strategy": ("reader_strategy", None),
        "--continuous-slots": ("continuous_slots", 0), "--reader-draft-size": ("reader_draft_size", None),
        "--reader-draft-params": ("reader_draft_params", None), f"--speculative {args.speculative}": ("speculative", "none"),
    })
    device = resolve_device(args.device)
    encoder = _encoder(args.encoder, args.seed, device)
    tok = _tokenizer(args.tokenizer)
    # in HTTP mode every dispatch pads to query_batch: size it to the
    # micro-batch cap
    qbatch = args.max_batch if args.port is not None else 256
    # shrink-to-fit by default: a query scans the stored corpus, not the
    # build-time headroom; --capacity N leaves room for POST /ingest
    store = _serving_index(args, device, qbatch)
    docstore = DocStore(args.db)
    retriever = Retriever(encoder, tok, store, docstore, max_len=args.max_len, mode=args.search_mode,
                          query_batch=qbatch)
    qa = None
    if args.reader_size:
        reader = _reader(args.reader_size, tok, args.seed + 1, device, args.reader_quantize)
        qa = QAPipeline(retriever, reader, tok, k=args.k, min_score=args.min_score,
                        max_new_tokens=args.max_new_tokens)
    if args.port is None:
        print(f"index: {store.size} vectors; type a query (empty line quits)")
        while True:
            try:
                query = input("query> ").strip()
            except EOFError:
                break
            if not query:
                break
            if qa is not None:
                ans = qa.answer([query])[0]
                print(f"answer{'(refused)' if ans.refused else ''}> {ans.answer}")
                for rank, (doc, score) in enumerate(zip(ans.contexts, ans.scores)):
                    print(f"  ctx {rank + 1}. score={score:.3f} {doc[:120]}")
                continue
            for rank, r in enumerate(retriever.search([query], k=args.k)[0]):
                doc = (r.doc or "")[:160].replace("\n", " ")
                print(f"  {rank + 1}. [{r.id}] score={r.score:.3f} {doc}")
        return 0

    ingest = IngestPipeline(encoder, tok, store, docstore, batch_size=args.max_batch, max_len=args.max_len)
    app = ServingApp(retriever, qa, ingest=ingest, k=args.k, max_k=args.max_k, max_batch=args.max_batch,
                     max_wait_s=args.batch_wait_ms / 1000.0)
    httpd = make_server(app, host=args.host, port=args.port)
    print(
        f"serving {store.size} vectors on http://{httpd.server_address[0]}:{httpd.server_address[1]} "
        f"(max_batch={args.max_batch}, wait={args.batch_wait_ms}ms; endpoints: /healthz /search /ingest"
        f"{' /qa' if qa else ''})",
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
        # only a flat store takes /ingest (an IVF index refuses it), so
        # --index is only ever rewritten with a flat store
        if app.dirty and isinstance(store, VectorStore):
            store.save(args.index)
            print(f"index persisted -> {args.index} ({store.size} vectors)")
    return 0


def cmd_chat(args) -> int:
    """Interactive generation REPL over a causal reader."""
    import torch

    from ..core.device import resolve_device
    from ..data import QUESTION_PREFIX, RESPONSE_PREFIX, batch_encode
    from ..models import GenerationConfig, generate_with_config

    _refuse(args, {
        "--init-params": ("init_params", None), "--draft-size": ("draft_size", None),
        "--draft-params": ("draft_params", None),
    })
    device = resolve_device(args.device)
    tok = _tokenizer(args.tokenizer)
    model = _reader(args.model_size, tok, args.seed, device, args.quantize)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens, temperature=args.temperature)
    print("chat REPL — empty line quits", flush=True)
    while True:
        try:
            text = input("user> ").strip()
        except EOFError:
            break
        if not text:
            break
        prompt = f"{QUESTION_PREFIX}\n{text}\n\n{RESPONSE_PREFIX}\n"
        ids, mask = batch_encode(tok, [prompt], args.max_len, pad_side="left")
        out = generate_with_config(model, torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device),
                                   gen, eos_id=tok.eos_id)
        new_tokens = out[0, ids.shape[1]:].tolist()
        print(f"model> {tok.decode([t for t in new_tokens if t not in (tok.pad_id, tok.eos_id)])}", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vietnamese_qa_system_tpu_torch",
                                description="Vietnamese QA (retrieval and reader) on PyTorch / CUDA")
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

    pf = sub.add_parser("build-ivf", help="cluster a flat index into an IVF index")
    pf.add_argument("--index", required=True, help="flat index dir (ingest)")
    pf.add_argument("--out", required=True, help="output IVF index dir")
    pf.add_argument("--clusters", type=int, default=None, help="cluster count (default ~4*sqrt(N))")
    pf.add_argument("--nprobe", type=int, default=8)
    pf.add_argument("--cap-mult", type=float, default=1.6)
    pf.add_argument("--kmeans-iters", type=int, default=10)
    pf.add_argument("--shards", type=int, default=1, help="only 1 is ported")
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--device", default="cuda")
    pf.set_defaults(fn=cmd_build_ivf)

    ps = sub.add_parser("serve", help="retrieval (or QA with --reader-size) REPL, or the HTTP API with --port")
    ps.add_argument("--index", required=True)
    ps.add_argument("--ivf-index", default=None,
                    help="IVF directory (build-ivf) over the same corpus as --index (the flat store); serve then "
                         "picks per query batch: IVF up to the measured crossover, flat past it")
    ps.add_argument("--index-select", default="auto", choices=["auto", "flat", "ivf"],
                    help="override the automatic IVF/flat choice when --ivf-index is given")
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
    ps.add_argument("--reader-size", default=None, choices=READERS,
                    help="enable full QA (/qa): retrieve + generate with a causal reader LM (random weights "
                         "from --seed)")
    ps.add_argument("--reader-quantize", choices=["int8", "int8c", "nf4", "nf4-dq"], default=None,
                    help="quantize the reader's dense weights for decode; int8c (one scale per output channel) "
                         "decodes through the w8 GEMM kernel (K6); nf4 is not ported yet")
    ps.add_argument("--min-score", type=float, default=0.2,
                    help="retrieval score below which /qa refuses instead of answering")
    ps.add_argument("--max-new-tokens", type=int, default=128, help="completion budget of each /qa answer")
    ps.add_argument("--speculative", choices=["none", "ngram", "draft"], default="none",
                    help="speculative decoding for the reader (only none is ported)")
    ps.add_argument("--reader-params", default=None, help="reader checkpoint (not ported yet)")
    ps.add_argument("--reader-strategy", choices=["tp", "fsdp_tp"], default=None,
                    help="shard the reader over several GPUs (not ported yet)")
    ps.add_argument("--reader-draft-size", default=None, help="draft model preset (not ported yet)")
    ps.add_argument("--reader-draft-params", default=None, help="draft model checkpoint (not ported yet)")
    ps.add_argument("--continuous-slots", type=int, default=0,
                    help="POST /generate via continuous batching (not ported yet)")
    ps.add_argument("--device", default="cuda")
    ps.set_defaults(fn=cmd_serve)

    pc = sub.add_parser("chat", help="interactive generation REPL")
    pc.add_argument("--model-size", default="tiny", choices=READERS)
    pc.add_argument("--tokenizer", default="byte")
    pc.add_argument("--max-len", type=int, default=256)
    pc.add_argument("--max-new-tokens", type=int, default=128)
    pc.add_argument("--temperature", type=float, default=0.0)
    pc.add_argument("--quantize", choices=["int8", "int8c", "nf4", "nf4-dq"], default=None,
                    help="quantize dense weights for decode; int8c decodes through the w8 GEMM kernel (K6)")
    pc.add_argument("--init-params", default=None, help="model checkpoint (not ported yet)")
    pc.add_argument("--draft-size", default=None, help="draft model preset (not ported yet)")
    pc.add_argument("--draft-params", default=None, help="draft model checkpoint (not ported yet)")
    pc.add_argument("--seed", type=int, default=42)
    pc.add_argument("--device", default="cuda")
    pc.set_defaults(fn=cmd_chat)
    return p


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
