"""The port's encoder-decoders (T5, mBART, the native stack) against the
JAX package on the same weights (each family's ``init_*`` pytree carried
across by ``seq2seq_from_jax``), at 2 + 2 layers and d_model 64:

- forward logits: max abs <= 2e-2, mean abs <= 1e-3 (test_torch_causal.py's
  bound: every product rounds its inputs to bf16, so an f32 ulp upstream
  can cross a rounding boundary);
- cached decode (scalar cursors and a (B,) cursor tensor) against the
  port's own full decode: max abs <= 1e-4 (the same products, summed over
  other key counts);
- greedy and beam generation token for token, by the margin rule of
  test_torch_generate.py (a step whose top-2 margin on the JAX stream is
  below 2e-2 may differ, and everything after it);
- sampled decoding: the first token's marginal over 40,000 rows against
  the JAX model's softmax, total variation < 0.05 (sampling noise alone
  gives ~0.023 at V 128);
- loss within 1e-4 relative, and each LoRA adapter gradient leaf against
  jitted JAX within 5e-2 of its largest entry (test_torch_qlora.py's
  bounds: the merged weights round to bf16, and an f32 ulp of the merge
  can cross a rounding boundary);
- ``QAPipeline`` over a seq2seq reader: right padding, new tokens only,
  the same answers as the JAX pipeline; the models import without jax.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.models import bart as jbart
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu.models import lora as jlora
from vietnamese_qa_system_tpu.models import seq2seq as jnative
from vietnamese_qa_system_tpu.models import t5 as jt5
from vietnamese_qa_system_tpu.models.config import ModelConfig as JConfig
from vietnamese_qa_system_tpu_torch.models import (LoraConfig, ModelConfig, adapter_from_jax, clear_lora, families,
                                                   merge_lora, seq2seq_from_jax)
from vietnamese_qa_system_tpu_torch.models import generate as tg

torch.set_num_threads(2)
MAX_TOL, MEAN_TOL = 2e-2, 1e-3
CACHE_TOL = 1e-4
MARGIN_TOL = 2e-2
GRAD_TOL = 5e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 128

CONFIGS = {
    "t5": JConfig(arch="seq2seq", seq2seq_family="t5", vocab_size=V, d_model=64, n_heads=4, d_kv=16, n_layers=2,
                  n_decoder_layers=2, d_ff=128, max_seq_len=512, mlp_gated=True, tie_embeddings=False,
                  relative_attention_buckets=8, relative_attention_max_distance=32, attention_bias=False),
    "t5-v1": JConfig(arch="seq2seq", seq2seq_family="t5", vocab_size=V, d_model=64, n_heads=4, d_kv=8, n_layers=2,
                     n_decoder_layers=2, d_ff=128, max_seq_len=512, mlp_gated=False, tie_embeddings=True,
                     relative_attention_buckets=8, relative_attention_max_distance=32, attention_bias=False),
    "bart": JConfig(arch="seq2seq", seq2seq_family="bart", vocab_size=V, d_model=64, n_heads=4, n_layers=2,
                    n_decoder_layers=2, d_ff=128, max_seq_len=64, positional="learned", scale_embedding=True,
                    norm_eps=1e-5),
    "native": JConfig(arch="seq2seq", vocab_size=V, d_model=64, n_heads=4, n_layers=2, n_decoder_layers=2, d_ff=128,
                      max_seq_len=64),
}
MODULES = {"t5": jt5, "bart": jbart, "native": jnative}
INITS = {"t5": jt5.init_t5, "bart": jbart.init_bart, "native": jnative.init_seq2seq}


def jmod(cfg):
    return MODULES[cfg.seq2seq_family]


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def jax_params(cfg, seed: int = 1):
    return INITS[cfg.seq2seq_family](jax.random.key(seed), cfg)


def port_model(params, cfg):
    return seq2seq_from_jax(jax.tree.map(np.asarray, params), port_cfg(cfg), device="cpu")


def enc_batch(seed, b=3, t=12):
    """Right-padded encoder inputs (pads are 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, V, (b, t)).astype(np.int32)
    mask = np.ones_like(ids)
    if b > 1:
        mask[1, t - 3:] = 0
    if b > 2:
        mask[2, 5:] = 0
    return ids * mask, mask


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


def margins(params, cfg, enc, mask, stream, bos=0):
    """Top-2 logit margins of the JAX model at each step of ``stream``
    (B, N), teacher-forced by a full decode."""
    dec = np.concatenate([np.full((stream.shape[0], 1), bos, np.int32), stream[:, :-1]], axis=1)
    logits = jmod(cfg).forward(params, cfg, {"input_ids": jnp.asarray(enc), "attention_mask": jnp.asarray(mask),
                                             "decoder_input_ids": jnp.asarray(dec)})
    top2 = jax.lax.top_k(logits, 2)[0]
    return np.asarray(top2[..., 0] - top2[..., 1])


def assert_margin_rule(got, want, params, cfg, enc, mask, bos=0):
    """Row by row, ``got`` equals ``want`` up to the first step whose top-2
    margin on the JAX stream is below MARGIN_TOL."""
    got, want = np.asarray(got), np.asarray(want)
    if np.array_equal(got, want):
        return
    m = margins(params, cfg, enc, mask, want, bos)
    for r in range(want.shape[0]):
        if np.array_equal(got[r], want[r]):
            continue
        ties = np.nonzero(m[r] < MARGIN_TOL)[0]
        until = int(ties[0]) if len(ties) else want.shape[1]
        assert np.array_equal(got[r, :until], want[r, :until]), (r, got[r], want[r])
        assert until < want.shape[1], f"row {r} differs with no near-tie"


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(name):
        if name not in cache:
            cfg = CONFIGS[name]
            params = jax_params(cfg)
            cache[name] = (params, cfg, port_model(params, cfg))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(models, name):
    params, cfg, model = models(name)
    enc, mask = enc_batch(2)
    dec = np.random.default_rng(3).integers(3, V, (3, 9)).astype(np.int32)
    dmask = np.ones_like(dec)
    dmask[0, 7:] = 0
    batch = {"input_ids": enc, "attention_mask": mask, "decoder_input_ids": dec, "decoder_attention_mask": dmask}
    want = np.asarray(jmod(cfg).forward(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.inference_mode():
        got = model(torch_batch(batch)).numpy()
    assert got.shape == (3, 9, V)
    diff = np.abs(got - want)
    assert diff.max() <= MAX_TOL and diff.mean() <= MEAN_TOL, (diff.max(), diff.mean())


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cached_decode_matches_full(models, name, per_row):
    """A step at a time through the decoder cache (an int cursor, or the
    same cursor as a (B,) tensor: the slot engine's form) gives the full
    decode's logits."""
    _, cfg, model = models(name)
    enc, mask = enc_batch(4)
    dec = np.random.default_rng(5).integers(3, V, (3, 8)).astype(np.int32)
    t = dec.shape[1]
    with torch.inference_mode():
        enc_t, mask_t, dec_t = (torch.from_numpy(x) for x in (enc, mask, dec))
        enc_out = model.encode(enc_t, mask_t)
        full = model.decode(dec_t, enc_out, mask_t)
        cache = model.make_cache(3, t)
        ckv = model.precompute_cross_kv(enc_out)
        jj = torch.arange(t)[None, None, :]
        steps = []
        for i in range(t):
            cursor = torch.full((3,), i, dtype=torch.int32) if per_row else i
            steps.append(model.decode(dec_t[:, i: i + 1], None, mask_t, (jj <= i).expand(3, 1, t),
                                      positions=torch.full((3, 1), i), cache=cache, cache_index=cursor,
                                      cross_kv=ckv)[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=CACHE_TOL, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_and_beams_match_jax(models, name):
    params, cfg, model = models(name)
    enc, mask = enc_batch(6, b=4)
    kw = dict(max_new_tokens=10, eos_id=5)
    want = np.asarray(jg.generate_seq2seq(params, cfg, jnp.asarray(enc), jnp.asarray(mask), **kw))
    got = tg.generate_seq2seq(model, torch.from_numpy(enc), torch.from_numpy(mask), **kw).numpy()
    assert got.shape == (4, 10)
    assert_margin_rule(got, want, params, cfg, enc, mask)
    for beams in (1, 3):
        bkw = dict(kw, num_beams=beams, min_new_tokens=2, repetition_penalty=1.3, length_penalty=0.8)
        want = np.asarray(jg.beam_search_seq2seq(params, cfg, jnp.asarray(enc), jnp.asarray(mask), **bkw))
        got = tg.beam_search_seq2seq(model, torch.from_numpy(enc), torch.from_numpy(mask), **bkw).numpy()
        assert np.array_equal(got, want), (beams, got, want)


def test_generate_options_match_jax(models):
    """Forced first / last tokens, the decoder-stream repetition penalty,
    min_new_tokens and another decoder start through generate_with_config."""
    params, cfg, model = models("native")
    enc, mask = enc_batch(7, b=4)
    gen = tg.GenerationConfig(max_new_tokens=8, repetition_penalty=1.5, min_new_tokens=3, forced_bos_token_id=9,
                              forced_eos_token_id=5)
    jgen = jg.GenerationConfig(**dataclasses.asdict(gen))
    want = np.asarray(jg.generate_with_config(params, cfg, jnp.asarray(enc), jnp.asarray(mask), jgen, eos_id=5,
                                              bos_id=2))
    got = tg.generate_with_config(model, torch.from_numpy(enc), torch.from_numpy(mask), gen, eos_id=5,
                                  bos_id=2).numpy()
    assert (got[:, 0] == 9).all() and (got[:, -1] == 5).all()
    assert_margin_rule(got, want, params, cfg, enc, mask, bos=2)
    beams = tg.generate_with_config(model, torch.from_numpy(enc), torch.from_numpy(mask),
                                    dataclasses.replace(gen, num_beams=2), eos_id=5, bos_id=2).numpy()
    jbeams = np.asarray(jg.generate_with_config(params, cfg, jnp.asarray(enc), jnp.asarray(mask),
                                                dataclasses.replace(jgen, num_beams=2), eos_id=5, bos_id=2))
    assert np.array_equal(beams, jbeams)


def test_generate_with_config_refusals():
    model = families.init_seq2seq_model(ModelConfig(arch="seq2seq", vocab_size=64, d_model=32, n_heads=2,
                                                    n_layers=1, d_ff=64, max_seq_len=32),
                                        torch.Generator().manual_seed(0))
    ids = torch.ones((1, 4), dtype=torch.int32)
    for gen, match in ((tg.GenerationConfig(speculative="ngram"), "seq2seq arch"),
                       (tg.GenerationConfig(no_repeat_ngram_size=2), "no_repeat_ngram_size"),
                       (tg.GenerationConfig(kv_dtype="int8"), "kv_dtype")):
        with pytest.raises(ValueError, match=match):
            tg.generate_with_config(model, ids, ids, gen)


def test_sampled_first_token_marginal(models):
    """40,000 rows of one input, one sampled token: the empirical marginal
    against the JAX model's softmax at temperature 0.7."""
    params, cfg, model = models("native")
    enc, mask = enc_batch(8, b=1)
    n = 40000
    encs, masks = np.repeat(enc, n, 0), np.repeat(mask, n, 0)
    got = tg.generate_seq2seq(model, torch.from_numpy(encs), torch.from_numpy(masks), max_new_tokens=1,
                              temperature=0.7, generator=torch.Generator().manual_seed(3)).numpy()[:, 0]
    logits = jmod(cfg).forward(params, cfg, {"input_ids": jnp.asarray(enc), "attention_mask": jnp.asarray(mask),
                                             "decoder_input_ids": jnp.zeros((1, 1), jnp.int32)})
    p = np.asarray(jax.nn.softmax(logits[0, 0] / 0.7))
    emp = np.bincount(got, minlength=V) / n
    assert 0.5 * np.abs(emp - p).sum() < 0.05


def _labels(seed, b=3, t=7):
    lab = np.random.default_rng(seed).integers(3, V, (b, t)).astype(np.int32)
    lab[0, 5:] = -100
    lab[2, 3:] = -100
    return lab


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_lora_grads_match_jitted_jax(models, name):
    params, cfg, model = models(name)
    enc, mask = enc_batch(9)
    batch = {"input_ids": enc, "attention_mask": mask, "labels": _labels(10)}
    jb = {k: jnp.array(v) for k, v in batch.items()}
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    rng = np.random.default_rng(2)
    # B != 0, so the gradients of A are not zero (test_torch_qlora.py's draw)
    adapter = jax.tree.map(lambda x: jnp.array(np.asarray(x) + 0.02 * rng.standard_normal(x.shape), jnp.float32),
                           jlora.init_lora(jax.random.key(2), params, lcfg))

    @jax.jit
    def jloss(ad):
        return jmod(cfg).loss_fn(jlora.merge_lora(params, ad, lcfg), cfg, jb)

    (want_loss, want_n), want_g = jax.value_and_grad(jloss, has_aux=True)(adapter)
    tad = adapter_from_jax(jax.tree.map(np.asarray, adapter), device="cpu")
    merge_lora(model, tad, LoraConfig(r=4, alpha=8))
    try:
        loss, n = families.loss_fn(model, torch_batch(batch))
        leaves = [leaf for _, leaf in sorted(_flat(tad).items())]
        grads = torch.autograd.grad(loss, leaves)
    finally:
        clear_lora(model)
    assert int(n) == int(want_n)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    got = dict(zip(sorted(_flat(tad)), grads))
    want_flat = _flat(jax.tree.map(np.asarray, want_g))
    assert sorted(got) == sorted(want_flat)
    for path, w in want_flat.items():
        assert np.abs(got[path].numpy() - w).max() <= GRAD_TOL * np.abs(w).max(), path


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


class _Hit:
    def __init__(self, doc, score):
        self.doc, self.score, self.id = doc, score, 0


class _Retriever:
    def search(self, queries, k):
        return [[_Hit(f"văn bản số {i} về câu hỏi {q}", 0.9 - 0.1 * i) for i in range(2)] for q in queries]


def test_qa_pipeline_seq2seq_reader_matches_jax(models):
    """A seq2seq reader answers with its decoder tokens (right-padded
    inputs, no speculation) as the JAX pipeline does."""
    from vietnamese_qa_system_tpu.data.tokenizer import ByteTokenizer as JTok
    from vietnamese_qa_system_tpu.engine.qa import QAPipeline as JQA
    from vietnamese_qa_system_tpu_torch.data import ByteTokenizer
    from vietnamese_qa_system_tpu_torch.engine import QAPipeline

    cfg = dataclasses.replace(CONFIGS["native"], vocab_size=ByteTokenizer().vocab_size, max_seq_len=256)
    params = jax_params(cfg, seed=4)
    model = port_model(params, cfg)
    questions = ["Hà Nội ở đâu?", "Ai viết truyện Kiều?", "Sông nào dài nhất?"]
    kw = dict(k=2, max_prompt_len=96, max_new_tokens=6, speculative="ngram")
    got = QAPipeline(_Retriever(), model, ByteTokenizer(), **kw).answer(questions)
    want = JQA(_Retriever(), params, cfg, JTok(), **kw).answer(questions)
    assert [a.answer for a in got] == [a.answer for a in want]
    assert all(a.answer is not None and not a.refused for a in got)


def test_seq2seq_modules_import_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'vietnamese_qa_system_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from vietnamese_qa_system_tpu_torch.models import t5, bart, seq2seq, families, mt5_small_class\n"
        "from vietnamese_qa_system_tpu_torch.engine import continuous\n"
        "from vietnamese_qa_system_tpu_torch.models.config import tiny_test\n"
        "m = families.init_seq2seq_model(tiny_test('seq2seq'), torch.Generator().manual_seed(0))\n"
        "eng = continuous.ContinuousEngine(m, m.cfg, n_slots=2, total=16, buckets=(8,), device='cpu')\n"
        "print(len(eng.generate_ids([5, 6, 7], 4, timeout=120)), mt5_small_class().d_kv)\n"
        "eng.close()\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'vietnamese_qa_system_tpu') "
        "and sys.modules[n] is not None))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[:2] == ["4 64", "[]"]


def test_encoder_inputs_past_the_position_table():
    """``serve --reader-size tiny-s2s`` pads /qa prompts to 512 tokens, past
    the tiny native stack's 256-row position table: JAX's encoder raises
    there (its slice of the table is 256 rows), the port reads the last row
    for the padding past it, so real tokens encode as at a width inside
    the table (within 1e-5: products over other row counts)."""
    from vietnamese_qa_system_tpu.models import config as jc

    cfg = jc.tiny_test("seq2seq")
    params = jax_params(cfg)
    model = port_model(params, cfg)
    ids = np.zeros((1, 512), np.int32)
    ids[0, :30] = np.arange(30) + 3
    mask = (ids > 0).astype(np.int32)
    with pytest.raises(TypeError, match="broadcast"):
        jnative.encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        wide = model.encode(torch.from_numpy(ids), torch.from_numpy(mask))[0, :30]
        inside = model.encode(torch.from_numpy(ids[:, :64]), torch.from_numpy(mask[:, :64]))[0, :30]
    np.testing.assert_allclose(wide.numpy(), inside.numpy(), atol=1e-5, rtol=0)
