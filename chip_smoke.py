"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``vietnamese_qa_system_tpu_torch/
csrc``, holds each kernel against its plain PyTorch version at the shapes of
the serving path, then drives that path once at the full width of the
``mpnet_class`` encoder (random weights from a seed): four 1M-row vector
stores, ingest of 2,048 synthetic Vietnamese passages at max_len 512 (the
flash kernel), an HTTP server answering /search and /ingest, and top-k on
the three int8 stores held against the plain path.  Each kernel's launch
counter must move during that run.

Output: the GPU's name and power limit, one line per check, a JSON line
with each kernel's launches, error and times, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero; it also exits non-zero, printing no result, when no GPU is
visible.  Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

SEED = 0
B, D, N, K, K_RERANK = 256, 768, 1 << 20, 10, 40
FLASH_B, FLASH_H, FLASH_T, FLASH_D = 16, 12, 512, 64
N_PASSAGES = 2048
FLASH_O_TOL = 2e-2   # bf16 output: a few ulps at |o| < 2
FLASH_LSE_TOL = 1e-2  # f32 log-sum-exp after bf16 probabilities
ENCODER_COS_TOL = 0.9999
RERANK_SCORE_TOL = 1e-5  # f32 re-score sums in another order on the host


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")
    print(f"ok: {what}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rank_recall(q, corpus, ids, k: int) -> float:
    """bench.py's rank-count rule: an id is a true top-k member iff fewer
    than k corpus rows score strictly higher (plain f32 scores)."""
    import torch

    scores = q.float() @ corpus.float().T
    picked = torch.gather(scores, 1, ids.long())
    counts = torch.stack([(scores > picked[:, j: j + 1]).sum(1) for j in range(k)], 1)
    return (counts < k).float().mean().item()


def phase_topk(torch, T, quant, gen, report):
    """K1-K3 against their plain versions at the serving shape."""
    q = torch.randn(B, D, generator=gen, device="cuda").to(torch.bfloat16)
    corpus = torch.randn(N, D, generator=gen, device="cuda").to(torch.bfloat16)
    s, i = T.topk_bf16(q, corpus, N, K)
    ps, _ = T.topk_bf16_plain(q, corpus, N, K)
    torch.cuda.synchronize()
    rec = rank_recall(q, corpus, i, K)
    print(f"bf16 top-{K} recall by rank count: {rec:.3f}")
    check(rec == 1.0, f"K1 bf16 B={B} N={N} k={K}: recall 1.000 by the rank-count rule")
    err = (s - ps).abs().max().item()
    valid = N - 12345
    _, iv = T.topk_bf16(q[:64], corpus, valid, K)
    torch.cuda.synchronize()
    check(int(iv.max()) < valid and rank_recall(q[:64], corpus[:valid], iv, K) == 1.0,
          f"K1 bf16 valid_n={valid} < N: ids below valid_n, recall 1.000")
    report["matmul_topk_bf16"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: T.topk_bf16(q, corpus, N, K), 10),
        "plain_ms": cuda_ms(lambda: T.topk_bf16_plain(q, corpus, N, K), 3),
    }
    del corpus

    base = torch.randn(N, D, generator=gen, device="cuda")
    codes, scales = quant.quantize_int8_reference(base)
    gcodes, _ = quant.quantize_int8_global(base)
    del base
    q_i8, _ = T.quantize_queries(torch.randn(B, D, generator=gen, device="cuda"))
    for name, kern, plain in (
        ("matmul_topk_int8", lambda n, k: T.topk_int8(q_i8, codes, scales, n, k),
         lambda n, k: T.topk_int8_plain(q_i8, codes, scales, n, k)),
        ("matmul_topk_int8_global", lambda n, k: T.topk_int8_global(q_i8, gcodes, n, k),
         lambda n, k: T.topk_int8_global_plain(q_i8, gcodes, n, k)),
    ):
        worst = 0.0
        for n, k in ((N, K), (N, K_RERANK), (N - 777, K)):
            (s, i), (ps, pi) = kern(n, k), plain(n, k)
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and torch.equal(s, ps),
                  f"{name} valid_n={n} k={k}: ids and scores equal the plain version exactly")
            worst = max(worst, (s - ps).abs().max().item())
        report[name] = {
            "max_abs_err": worst,
            "ms": cuda_ms(lambda: kern(N, K), 10),
            "plain_ms": cuda_ms(lambda: plain(N, K), 3),
        }


def phase_flash(torch, A, gen, report, rel_bias_of):
    """K4 against its plain version at the encoder's shape."""
    b, h, t, d = FLASH_B, FLASH_H, FLASH_T, FLASH_D
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda") for _ in range(3))
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda").to(torch.int32)
    lens[0], lens[1], lens[-1] = 0, 1, t
    bias = rel_bias_of(t)[0].contiguous()  # (H, T, T) MPNet relative bias

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).to(torch.bfloat16).contiguous()

    qb, kb, vb = to_bh(q * d ** -0.5), to_bh(k), to_bh(v)
    lens_bh = lens.repeat_interleave(h).contiguous()
    o, lse = A.flash_fwd(qb, kb, vb, lens_bh, bias, h)
    po, plse = A.flash_fwd_plain(qb, kb, vb, lens_bh, bias, h)
    torch.cuda.synchronize()
    diff = (o.float() - po.float()).abs()
    lse_diff = (lse - plse).abs()
    print(f"flash o: max abs err {diff.max().item():.6f}, mean {diff.mean().item():.3e}; "
          f"lse: max abs err {lse_diff.max().item():.6f}, mean {lse_diff.mean().item():.3e}")
    check(bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(lse).all()),
          "K4 flash: o and lse finite, kv_lens == 0 rows included")
    check(diff.max().item() <= FLASH_O_TOL, f"K4 flash B={b} H={h} T={t} D={d}: o max abs err <= {FLASH_O_TOL}")
    check(lse_diff.max().item() <= FLASH_LSE_TOL, f"K4 flash: lse max abs err <= {FLASH_LSE_TOL}")
    report["flash_attention_fwd"] = {
        "max_abs_err": diff.max().item(),
        "ms": cuda_ms(lambda: A.flash_fwd(qb, kb, vb, lens_bh, bias, h), 20),
        "plain_ms": cuda_ms(lambda: A.flash_fwd_plain(qb, kb, vb, lens_bh, bias, h), 5),
    }


def passages(n: int, seed: int) -> list[str]:
    """Synthetic Vietnamese passages, each unique by its opening words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ("học sinh trường đại học nghiên cứu khoa học Việt Nam thành phố Hà Nội Hồ Chí Minh "
             "kinh tế văn hóa lịch sử sông Hồng đồng bằng miền núi nông nghiệp công nghiệp giáo dục "
             "sức khỏe bệnh viện người dân chính phủ luật pháp môi trường khí hậu mùa mưa").split()
    out = []
    for i in range(n):
        n_words = int(rng.integers(6, 90))
        body = " ".join(words[j] for j in rng.integers(0, len(words), n_words))
        # at most 500 characters: one passage is one 512-character chunk
        out.append(f"Tài liệu {i}: {body}"[:499].rsplit(" ", 1)[0] + ".")
    return out


def on_cpu(store):
    """A host twin of a store: its top-k runs the plain versions."""
    import torch

    twin = copy.copy(store)
    twin.device = torch.device("cpu")
    for name in ("vectors", "scales", "res_vectors", "res_scales"):
        t = getattr(store, name)
        setattr(twin, name, None if t is None else t.cpu())
    return twin


def post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def phase_slice(torch, pkg, gen):
    """The serving path once, end to end, with the launch counters reset."""
    from vietnamese_qa_system_tpu_torch.core import make_generator
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer, batch_encode
    from vietnamese_qa_system_tpu_torch.engine import (DocStore, IngestPipeline, Retriever, ServingApp,
                                                       VectorStore, make_server)
    from vietnamese_qa_system_tpu_torch.models import init_encoder, mpnet_class
    from vietnamese_qa_system_tpu_torch.ops.cuda_kernels import FLASH_FWD

    cfg = mpnet_class()
    encoder = init_encoder(cfg, make_generator(SEED), device="cuda")
    tok = ByteTokenizer()
    texts = passages(N_PASSAGES, SEED)

    # the flash path (T = 512) on the card against the plain path on the
    # host, same weights, on a few passages
    with torch.inference_mode():
        ids, mask = batch_encode(tok, texts[:4] + [""], 512)
        gpu = encoder.sentence_embed(torch.from_numpy(ids).cuda().long(), torch.from_numpy(mask).cuda().long())
        host = copy.deepcopy(encoder).cpu().sentence_embed(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    cos = (gpu.cpu()[:4] * host[:4]).sum(1)
    print(f"encoder T=512 card vs host plain path: min cos {cos.min().item():.6f}")
    check(bool(torch.isfinite(gpu).all()) and gpu.shape == (5, cfg.d_model),
          "mpnet_class sentence_embed: finite (5, 768) output")
    check(cos.min().item() >= ENCODER_COS_TOL, f"encoder on the card agrees with the plain path: cos >= {ENCODER_COS_TOL}")

    for kern in pkg.KERNELS:
        kern.launches = 0

    room = 4096  # capacity left for the ingested passages and /ingest
    stores = {dt: VectorStore(N, cfg.d_model, dtype=dt, device="cuda") for dt in ("bf16", "int8", "int8_global", "int8_res")}
    filled = stores["bf16"].capacity - room
    for start in range(0, filled, 1 << 17):
        rows = min(1 << 17, filled - start)
        v = torch.randn(rows, cfg.d_model, generator=gen, device="cuda")
        v = v / v.norm(dim=1, keepdim=True)
        for st in stores.values():
            st.add(v)
    check(all(st.size == filled for st in stores.values()), f"four 1M-capacity stores filled with {filled} unit vectors")

    docstore = DocStore()
    t0 = time.perf_counter()
    ingest = IngestPipeline(encoder, tok, stores["bf16"], docstore, batch_size=256, max_len=512)
    doc_ids = ingest.add_documents(texts, ["synthetic"] * len(texts))
    torch.cuda.synchronize()
    print(f"ingest: {len(doc_ids)} chunks at max_len 512 in {time.perf_counter() - t0:.2f} s")
    check(len(doc_ids) == N_PASSAGES and FLASH_FWD.launches > 0,
          f"ingest of {N_PASSAGES} passages ran the flash kernel ({FLASH_FWD.launches} launches)")

    retriever = Retriever(encoder, tok, stores["bf16"], docstore, max_len=128, query_batch=32)
    app = ServingApp(retriever, ingest=IngestPipeline(encoder, tok, stores["bf16"], docstore, batch_size=32,
                                                      max_len=128), k=5, max_batch=32)
    httpd = make_server(app, host="127.0.0.1", port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        # queries: passages whose tokens fit max_len 128, so the query and
        # the ingested passage see the same tokens
        short = [i for i, t in enumerate(texts) if len(tok.encode(t)) <= 128][:12]
        check(len(short) >= 8, f"{len(short)} passages fit the 128-token query length")
        answers = [None] * len(short)

        def ask(j, i):
            answers[j] = post(f"{url}/search", {"query": texts[i], "k": 5})

        threads = [threading.Thread(target=ask, args=(j, i)) for j, i in enumerate(short)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        hits = 0
        for i, ans in zip(short, answers):
            found = [r for r in (ans or {}).get("results", []) if r["id"] == int(doc_ids[i])]
            hits += bool(found) and found[0]["doc"] == texts[i]
        check(hits == len(short), f"{hits}/{len(short)} HTTP /search answers return their passage's id and doc in the top-5")
        new = post(f"{url}/ingest", {"texts": ["Bài viết mới về giáo dục ở Việt Nam."], "sources": ["http"]})
        check(new["ids"] == [filled + N_PASSAGES] and new["index_size"] == filled + N_PASSAGES + 1,
              "HTTP /ingest appended one document")
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["ok"] and health["stats"]["search"]["requests"] == len(short), "HTTP /healthz counts the searches")
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        server.join(timeout=30)

    # the three int8 stores against the plain path (a host twin of each)
    qv = stores["bf16"].get_vectors(list(range(32)))
    queries = torch.from_numpy(qv).cuda() + 0.01 * torch.randn(32, cfg.d_model, generator=gen, device="cuda")
    for dt in ("int8", "int8_global", "int8_res"):
        s, i = stores[dt].topk(queries, K)
        ps, pi = on_cpu(stores[dt]).topk(queries.cpu(), K)
        same_ids = torch.equal(i.cpu(), pi)
        if dt == "int8_res":
            # the re-rank sums in f32 in another order on the host
            ok = same_ids and (s.cpu() - ps).abs().max().item() <= RERANK_SCORE_TOL
        else:
            ok = same_ids and torch.equal(s.cpu(), ps)
        check(ok and bool((i[:, 0].cpu() == torch.arange(32)).all()),
              f"{dt} store top-{K} equals the plain path; each query finds its source vector first")
    return {k.name: k.launches for k in pkg.KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vietnamese_qa_system_tpu_torch.ops as pkg
    from vietnamese_qa_system_tpu_torch.ops import attention as A
    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels, quant
    from vietnamese_qa_system_tpu_torch.ops import topk as T
    from vietnamese_qa_system_tpu_torch.models import mpnet_class, relative_attention_bias

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(gpu_name_and_power(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_kernels.library()
    print(f"kernels built from csrc/ in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report: dict = {}
    phase_topk(torch, T, quant, gen, report)
    table = torch.randn(32, FLASH_H, generator=gen, device="cuda") * 0.02
    phase_flash(torch, A, gen, report, lambda t: relative_attention_bias(table, t, mpnet_class()))
    launches = phase_slice(torch, pkg, gen)
    print("launches in the serving run: " + json.dumps(launches))
    for kern in pkg.KERNELS:
        check(launches[kern.name] > 0, f"{kern.name} launched on the serving path")
    kernels = [
        {"name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], **report[k.name]}
        for k in pkg.KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
