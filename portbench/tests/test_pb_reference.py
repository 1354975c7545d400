"""The frozen references held to the port on the CPU at a tiny size."""

import types

import numpy as np
import pytest
import torch

from portbench import inputs, spec, traffic
from portbench.drivers import generate, search
from portbench.reference import encoder as ref_encoder
from portbench.reference import mpt as ref_mpt
from portbench.reference import text as ref_text
from portbench.reference.rank import TopkJudge


def ctx_of(config: str, seed: int = 3):
    return types.SimpleNamespace(config=spec.merged(spec.load_json(spec.path_of("configs", config)), dry=True),
                                 seed=seed, device="cpu", dry=True)


@pytest.mark.parametrize("max_len", [128, 512])
def test_encoder_vectors(max_len):
    from vietnamese_qa_system_tpu_torch.data.tokenizer import ByteTokenizer, batch_encode

    ctx = ctx_of("mpnet_base_1m_bf16")
    enc = search.build_encoder(ctx)
    texts = traffic.queries({"batches": 1, "batch": 6, "len": {"family": "uniform", "min": 20, "max": 300}}, 1)[0]
    ids, mask = batch_encode(ByteTokenizer(), texts, max_len)
    with torch.inference_mode():
        got = enc.sentence_embed(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    rid, rmask = ref_text.byte_ids(texts, max_len)
    assert (rid == ids).all() and (rmask == mask).all()
    w = inputs.encoder_weights(ctx.config, ctx.seed, "cpu")
    want = ref_encoder.encode(w, ctx.config, torch.from_numpy(rid), torch.from_numpy(rmask))
    gap = (got - want).norm(dim=1).max().item()
    fp8 = ref_encoder.encode(w, ctx.config, torch.from_numpy(rid), torch.from_numpy(rmask), mode="fp8")
    assert gap < 0.02
    assert (fp8 - want).norm(dim=1).max().item() > 3 * gap


def test_mpt_teacher_forced_against_prefill_and_cached_decode():
    ctx = ctx_of("phogpt_4b_int8c")
    c = ctx.config
    model = generate.build_reader(ctx)
    rng = np.random.default_rng(0)
    seq = rng.integers(4, c["vocab_size"], 24).tolist()
    p, total = 16, 24
    ids = torch.tensor([seq])
    cache = model.make_cache(1, total)
    cols = torch.arange(total)
    with torch.inference_mode():
        mask = (cols[None, None, :] <= torch.arange(p)[None, :, None])
        h = [model.hidden_states(ids[:, :p], mask, positions=torch.arange(p)[None], cache=cache, cache_index=0)]
        for t in range(p, total):
            m = (cols <= t)[None, None, :]
            h.append(model.hidden_states(ids[:, t: t + 1], m, positions=torch.tensor([[t]]), cache=cache,
                                         cache_index=t))
        got = model.head(torch.cat(h, dim=1))[0]
        flat = model(ids)[0]
    outer = inputs.mpt_outer(c, ctx.seed, "cpu")
    hid = ref_mpt.final_hidden(c, outer, lambda i: inputs.mpt_layer(c, ctx.seed, i, "cpu"), [seq], ("int8c", "int4c"))
    want = ref_mpt.logits(outer, hid["int8c"][0])
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() < 0.03 * scale
    assert (flat - want).abs().max().item() < 0.03 * scale
    int4 = ref_mpt.logits(outer, hid["int4c"][0])
    assert (int4 - want).abs().max().item() > 3 * (got - want).abs().max().item()


def test_int8c_rule_matches_the_port_s_codes():
    from vietnamese_qa_system_tpu_torch.models.quantize import quantize_weight

    w = torch.randn(96, 40) * 0.1
    q = quantize_weight(w, "int8c")
    port = q["w_q"].float() * q["w_s"]
    assert torch.allclose(ref_mpt.per_column(w, "int8c"), port, rtol=0, atol=1e-7)


def test_rank_count_recall_of_the_port_s_exact_topk():
    from vietnamese_qa_system_tpu_torch.ops.topk import matmul_topk

    corpus = {"centres": 16, "sigma": 0.35}
    rows = torch.cat([b for _, b in inputs.corpus_blocks(corpus, 64, 3000, 9, "cpu", block=1024)])
    assert torch.allclose(rows.norm(dim=1), torch.ones(3000), atol=1e-5)
    q = torch.randn(20, 64)
    q = q / q.norm(dim=1, keepdim=True)
    _, ids = matmul_topk(q, rows.to(torch.bfloat16), 10)
    judge = TopkJudge(q.to(torch.bfloat16).float(), ids, 10)
    for step in (judge.first, judge.second):
        for start, block in inputs.corpus_blocks(corpus, 64, 3000, 9, "cpu", block=1024):
            step(start, block.to(torch.bfloat16).float())
    assert judge.recall() == 1.0
    assert judge.shortfall() == 0.0
    bad = ids.clone()
    bad[:, 0] = (bad[:, 0] + 1) % 3000
    j2 = TopkJudge(q.to(torch.bfloat16).float(), bad, 10)
    for start, block in inputs.corpus_blocks(corpus, 64, 3000, 9, "cpu", block=1024):
        j2.first(start, block.to(torch.bfloat16).float())
    assert j2.shortfall() > 0.0


def test_chunker_matches_the_port_s():
    from vietnamese_qa_system_tpu_torch.engine.chunking import chunk_text

    m = spec.merged(spec.load_json(spec.path_of("traffic", "docs_bulk")), dry=True)
    docs = traffic.documents(m, 4, 0) + ["short", "x" * 2000, "a. b. " * 300]
    for d in docs:
        assert ref_text.chunks(d, 512, 0.1) == chunk_text(d, 512, 0.1)
