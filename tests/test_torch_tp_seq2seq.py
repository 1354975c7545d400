"""The port's tensor-parallel encoder-decoders (``TPEncoderDecoder``: T5
with a gated FFN, an untied head and relative biases; mBART with a tied
head, a logits bias and learned positions; the native stack) against the
unsharded port and the JAX package's tp-sharded params:

- ``param_sharding`` specs leaf for leaf against JAX's, under tp and
  fsdp_tp, at meshes of 4, 3 and 2 (the T5 config has mt5-small's 6
  heads: at 4 devices its attention stays whole, the documented
  difference from JAX's column split of the inner width; mBART's
  vocabulary of 130 splits over 2 only, as mbart-large-50's 250,054 does);
- greedy ``generate_seq2seq`` and the seq2seq slot engine at ``{"model":
  n}`` against the unsharded port and JAX's tp-sharded ``generate_seq2seq``
  on its virtual CPU mesh, by the margin rule of test_torch_seq2seq.py (a
  step whose top-2 margin on the JAX stream is below 2e-2 may differ, and
  everything after it): row-parallel sums add the same f32 products in
  another order;
- ``beam_search_seq2seq`` over the split cache against the unsharded run;
- T5 at T 256 with ``use_flash_attention``: the encoder's flash route runs
  per part with that part's heads of the relative bias (the kernels'
  plain version on the CPU);
- split parts own their storage; ``serve --reader-size tiny-s2s
  --reader-strategy tp`` answers, and its /generate engine refuses an
  adapter bank as the JAX engine does.

The port's meshes repeat the CPU device; the JAX side runs on the
conftest's 8 virtual devices."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seq2seq import assert_margin_rule, enc_batch, jax_params, port_model
from test_torch_tp import _jax_specs
from vietnamese_qa_system_tpu.core.mesh import create_mesh as jcreate_mesh
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.models.config import ModelConfig as JConfig
from vietnamese_qa_system_tpu.parallel import sharding as jsharding
from vietnamese_qa_system_tpu_torch.core.mesh import create_mesh
from vietnamese_qa_system_tpu_torch.engine import ContinuousEngine
from vietnamese_qa_system_tpu_torch.models import generate as tg
from vietnamese_qa_system_tpu_torch.models import layers as tlayers
from vietnamese_qa_system_tpu_torch.models.families import TPEncoderDecoder
from vietnamese_qa_system_tpu_torch.parallel import sharding as tsharding

torch.set_num_threads(2)
TIMEOUT = 180
V = 128
FAMILIES = {
    # mt5-small's head count (6 heads x d_kv 8: whole at 4 devices), gated FFN, untied head, relative biases
    "t5": JConfig(arch="seq2seq", seq2seq_family="t5", vocab_size=V, d_model=64, n_heads=6, d_kv=8, n_layers=2,
                  n_decoder_layers=2, d_ff=96, max_seq_len=512, mlp_gated=True, tie_embeddings=False,
                  relative_attention_buckets=8, relative_attention_max_distance=32, attention_bias=False),
    # tied head plus a logits bias, learned positions; a vocabulary of 130 splits over 2 devices, not 4
    "bart": JConfig(arch="seq2seq", seq2seq_family="bart", vocab_size=130, d_model=64, n_heads=4, n_layers=2,
                    n_decoder_layers=2, d_ff=128, max_seq_len=64, positional="learned", scale_embedding=True,
                    norm_eps=1e-5),
    "native": JConfig(arch="seq2seq", vocab_size=V, d_model=64, n_heads=4, n_layers=2, n_decoder_layers=2, d_ff=128,
                      max_seq_len=64),
}


def _mesh(n):
    return create_mesh({"model": n}, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def models():
    """family -> (JAX params, JAX config, port model)."""
    cache = {}

    def get(family):
        if family not in cache:
            cfg = FAMILIES[family]
            params = jax_params(cfg, seed=3)
            if family == "bart":
                rng = np.random.default_rng(4)
                params = dict(params, logits_bias=jnp.asarray(rng.standard_normal(cfg.vocab_size) * 0.5,
                                                                jnp.float32))
            cache[family] = params, cfg, port_model(params, cfg)
        return cache[family]

    return get


def _jax_tp(params, n):
    mesh = jcreate_mesh({"model": n})
    return jsharding.shard_params(params, jsharding.param_sharding(params, mesh, strategy="tp"))


@pytest.mark.parametrize("n", [4, 3, 2])
@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_sharding_matches_jax(models, family, strategy, n):
    """Every leaf's spec equals JAX's for the same path (cross-attention
    splits like self-attention; mBART's fc1 / fc2 and T5's relative-bias
    tables match no rule and stay whole), and the split decisions the TP
    reader takes follow them."""
    params, cfg, port = models(family)
    want = _jax_specs(params, jcreate_mesh({"model": n}), strategy)
    specs = tsharding.param_sharding(port, _mesh(n), strategy)
    assert {tsharding.param_path(k): v for k, v in specs.items()} == want
    assert specs["dec_blocks.0.cross_attn.wq.w"] == specs["dec_blocks.0.attn.wq.w"]
    tp = tsharding.shard_params(port, _mesh(n), strategy)
    assert isinstance(tp, TPEncoderDecoder) and isinstance(tp, type(port))
    heads_split = specs["enc_blocks.0.attn.wq.w"][1] == "model" and cfg.n_heads % n == 0
    assert (tp.groups is not None) == heads_split
    for blk in (tp.enc_blocks[0], tp.dec_blocks[0]):
        assert isinstance(blk.attn, tlayers.TPAttention) == heads_split
    assert isinstance(tp.dec_blocks[0].cross_attn, tlayers.TPAttention) == heads_split
    mlp_split = family != "bart" and specs["enc_blocks.0.mlp.wi.w"][1] == "model"
    assert isinstance(tp.enc_blocks[0].mlp, tlayers.TPMLP) == mlp_split
    assert (tp.embed_parts is not None) == (specs["tok_embed"][0] == "model")
    if family == "t5":
        assert specs["enc_rel_bias"] == (None, None) and (tp.head_parts is not None) == (n != 3)
    if family == "bart":
        assert all(v == (None,) * len(v) for k, v in specs.items() if ".mlp." in k)
        assert (tp.embed_parts is not None) == (n == 2)


def _generate_both(models, family, n, **kw):
    params, cfg, port = models(family)
    tp = tsharding.shard_params(port, _mesh(n), "tp")
    enc, mask = enc_batch(5, b=3, t=12)
    want = np.asarray(jg.generate_seq2seq(_jax_tp(params, n), cfg, jnp.asarray(enc), jnp.asarray(mask),
                                          max_new_tokens=10, **kw))
    got_tp = tg.generate_seq2seq(tp, torch.from_numpy(enc), torch.from_numpy(mask), max_new_tokens=10, **kw).numpy()
    got = tg.generate_seq2seq(port, torch.from_numpy(enc), torch.from_numpy(mask), max_new_tokens=10, **kw).numpy()
    assert_margin_rule(got_tp, want, params, cfg, enc, mask)
    assert_margin_rule(got, want, params, cfg, enc, mask)
    return port, tp, enc, mask


@pytest.mark.parametrize("family,n", [("t5", 2), ("t5", 4), ("bart", 4), ("bart", 2), ("native", 4)])
def test_tp_generate_matches_unsharded_and_jax(models, family, n):
    """Greedy generate_seq2seq over the TP reader against the unsharded port
    and JAX's tp-sharded run; the teacher-forced logits within 1e-4 of the
    unsharded port's."""
    kw = dict(forced_bos_id=7) if family == "bart" else {}
    port, tp, enc, mask = _generate_both(models, family, n, **kw)
    batch = {"input_ids": torch.from_numpy(enc), "attention_mask": torch.from_numpy(mask),
             "decoder_input_ids": torch.from_numpy(enc[:, :6])}
    with torch.no_grad():
        np.testing.assert_allclose(tp(batch).numpy(), port(batch).numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_beams_over_the_split_cache(models, family):
    """W 3 beams over the TP reader (the generated slots reordered on every
    device, the cross K/V expanded on theirs) give the unsharded beams."""
    _, _, port = models(family)
    tp = tsharding.shard_params(port, _mesh(2), "tp")
    enc, mask = (torch.from_numpy(a) for a in enc_batch(9, b=2, t=10))
    kw = dict(max_new_tokens=6, num_beams=3, eos_id=2)
    assert torch.equal(tg.beam_search_seq2seq(tp, enc, mask, **kw), tg.beam_search_seq2seq(port, enc, mask, **kw))


def _engine_prompt(rng, n):
    return [int(x) for x in rng.integers(4, V - 8, (n,))]


def _padded(prompt, width):
    ids = np.zeros((1, width), np.int32)
    mask = np.zeros((1, width), np.int32)
    ids[0, : len(prompt)] = prompt
    mask[0, : len(prompt)] = 1
    return ids, mask


@pytest.mark.parametrize("family,n", [("t5", 2), ("bart", 4), ("native", 2)])
def test_tp_engine_matches_unsharded_and_jax(models, family, n):
    """The seq2seq slot engine over the TP reader (the decoder cache and
    each slot's cross K/V one dict a (layer, device)): interleaved
    requests reusing slots equal the unsharded engine's streams and JAX's
    tp-sharded generate_seq2seq at the bucket width by the margin rule."""
    params, cfg, port = models(family)
    tp = tsharding.shard_params(port, _mesh(n), "tp")
    jtp = _jax_tp(params, n)
    rng = np.random.default_rng(61)
    prompts = [_engine_prompt(rng, k) for k in (6, 13, 9, 15)]
    kw = dict(n_slots=2, total=32, buckets=(16,), chunk_steps=4, device="cpu")
    engines = [ContinuousEngine(tp, tp.cfg, **kw), ContinuousEngine(port, port.cfg, **kw)]
    try:
        if tp.groups is not None:
            assert len(engines[0]._state["cross_kv"]) == cfg.decoder_layers * n
        got = [[f.result(timeout=TIMEOUT)["ids"] for f in [eng.submit(p, 12) for p in prompts]] for eng in engines]
    finally:
        for eng in engines:
            eng.close()
    for p, g_tp, g in zip(prompts, *got):
        ids, mask = _padded(p, 16)
        want = np.asarray(jg.generate_seq2seq(jtp, cfg, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=12))
        assert_margin_rule(np.asarray([g_tp]), want, params, cfg, ids, mask)
        assert_margin_rule(np.asarray([g]), want, params, cfg, ids, mask)


def test_t5_flash_route_per_part(models, monkeypatch):
    """T5 at T 256 with use_flash_attention: every encoder layer's
    self-attention takes the flash route once a part, over that part's 3
    heads and its (3, T, T) slice of the relative bias; the outputs and the
    greedy tokens equal the unsharded flash run's."""
    params, cfg, _ = models("t5")
    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    port = port_model(params, fcfg)
    tp = tsharding.shard_params(port, _mesh(2), "tp")
    calls = []
    flash = tlayers.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((q.shape[2], None if kw.get("bias") is None else tuple(kw["bias"].shape)))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(tlayers, "flash_attention", recorded)
    enc, mask = (torch.from_numpy(a) for a in enc_batch(13, b=2, t=256))
    with torch.no_grad():
        h_tp = tp.encode(enc, mask)
        assert calls == [(3, (3, 256, 256))] * (2 * cfg.n_layers)
        h = port.encode(enc, mask)
    valid = mask.bool()[:, :, None]
    assert ((h_tp - h).abs() * valid).max() < 1e-4
    calls.clear()
    out_tp = tg.generate_seq2seq(tp, enc, mask, max_new_tokens=6)
    assert len(calls) == 2 * cfg.n_layers  # the decoder's steps attend through the cache
    out = tg.generate_seq2seq(port, enc, mask, max_new_tokens=6)
    assert torch.equal(out_tp, out)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_split_parts_own_their_storage(models, family):
    """Every split part (heads of both attentions, the FFN hidden,
    vocabulary rows, head columns) is a copy with storage of its own."""
    _, _, port = models(family)
    tp = tsharding.shard_params(port, _mesh(2), "tp")
    source = {p.untyped_storage().data_ptr() for p in port.parameters()}
    parts = [p for blocks in (tp.enc_blocks, tp.dec_blocks) for blk in blocks
             for mod in blk.children() if hasattr(mod, "parts") for p in mod.parts.parameters()]
    for split in (tp.embed_parts, tp.head_parts):
        parts += [] if split is None else list(split.parameters())
    assert parts and not any(p.untyped_storage().data_ptr() in source for p in parts)


def test_serve_tiny_s2s_reader_strategy_cli(tmp_path, monkeypatch, capsys):
    """``serve --reader-size tiny-s2s --reader-strategy tp --device cpu``
    (4 repeats of the host) answers /qa-style in the REPL; its /generate
    engine serves the TP reader, and refuses an adapter bank, as the JAX
    engine does for a seq2seq reader."""
    import json

    from vietnamese_qa_system_tpu_torch.cli import main as cli
    from vietnamese_qa_system_tpu_torch.cli.main import _reader, _sharded_reader, build_parser, continuous_engine
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.models import LoraConfig, init_lora
    from vietnamese_qa_system_tpu_torch.train.checkpoint import save_pytree

    docs = tmp_path / "docs.jsonl"
    docs.write_text("\n".join(json.dumps({"doc": f"tài liệu số {i} về Huế"}, ensure_ascii=False) for i in range(4)),
                    encoding="utf-8")
    idx, db = str(tmp_path / "idx"), str(tmp_path / "db.sqlite")
    assert cli(["ingest", "--inputs", str(docs), "--index", idx, "--db", db, "--device", "cpu", "--batch-size", "4",
                "--max-len", "48"]) == 0
    serve = ["serve", "--index", idx, "--db", db, "--device", "cpu", "--max-len", "48", "--reader-size", "tiny-s2s",
             "--max-new-tokens", "3", "--reader-strategy", "tp"]
    queries = iter(["Huế", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(queries))
    assert cli(serve) == 0
    out = capsys.readouterr().out
    assert "reader sharded: strategy=tp over 4 devices" in out and "answer" in out
    tok = ByteTokenizer()
    args = build_parser().parse_args(serve + ["--continuous-slots", "2", "--gen-total", "64"])
    reader = _sharded_reader(args, _reader("tiny-s2s", tok, 1, torch.device("cpu"), None), torch.device("cpu"))
    assert isinstance(reader, TPEncoderDecoder) and reader.groups is not None
    engine = continuous_engine(args, reader, tok, "cpu")
    try:
        assert len(engine.submit(tok.encode("xin chào"), 3).result(timeout=TIMEOUT)["ids"]) <= 3
    finally:
        engine.close()
    save_pytree(str(tmp_path / "adapter.npz"), init_lora(torch.Generator().manual_seed(0), reader, LoraConfig()))
    args = build_parser().parse_args(serve + ["--continuous-slots", "2", "--adapter", f"vi={tmp_path / 'adapter.npz'}"])
    with pytest.raises(ValueError, match="adapters"):
        continuous_engine(args, reader, tok, "cpu")
