"""The port's mBART family against the JAX package's models/bart.py:

- ``shift_labels_mbart`` equal to JAX's (the last real label rotates to
  position 0, -100 becomes the pad);
- a nonzero ``logits_bias`` carried and added (forward logits within
  test_torch_seq2seq.py's 2e-2 / 1e-3 bounds), and refused by the chunked
  loss of a real vocabulary as JAX refuses it;
- both embedding scales; positions at +2 for per-row cursors through the
  slot engine's decode (cached against full, 1e-4);
- W 4 beams with a forced BOS and the MBart default forced eos token for
  token against JAX;
- ``scan_layers`` refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seq2seq import CONFIGS, MAX_TOL, MEAN_TOL, enc_batch, port_cfg, port_model, torch_batch
from vietnamese_qa_system_tpu.models import bart as jbart
from vietnamese_qa_system_tpu.models import generate as jg
from vietnamese_qa_system_tpu_torch.models import bart as tbart
from vietnamese_qa_system_tpu_torch.models import generate as tg

torch.set_num_threads(2)
CFG = CONFIGS["bart"]


def test_shift_labels_matches_jax():
    labels = np.array([[5, 6, 7, 2, 30, -100, -100], [8, 9, 2, 31, 11, 12, 13], [-100] * 7], np.int32)
    want = np.asarray(jbart.shift_labels_mbart(jnp.asarray(labels)))
    got = tbart.shift_labels_mbart(torch.from_numpy(labels))
    assert np.array_equal(got.numpy(), want)
    assert got[0, 0] == 30 and got[1, 0] == 13 and got[2, 0] == 1


@pytest.mark.parametrize("scale", [True, False])
def test_logits_bias_and_embedding_scale(scale):
    cfg = dataclasses.replace(CFG, scale_embedding=scale)
    params = jbart.init_bart(jax.random.key(2), cfg)
    params["logits_bias"] = jnp.asarray(np.random.default_rng(0).standard_normal(cfg.vocab_size), jnp.float32)
    model = port_model(params, cfg)
    assert model.logits_bias is not None
    enc, mask = enc_batch(1)
    dec = np.random.default_rng(2).integers(3, cfg.vocab_size, (3, 6)).astype(np.int32)
    batch = {"input_ids": enc, "attention_mask": mask, "decoder_input_ids": dec}
    want = np.asarray(jbart.forward(params, cfg, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.inference_mode():
        got = model(torch_batch(batch)).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= MAX_TOL and diff.mean() <= MEAN_TOL
    big = dataclasses.replace(port_cfg(cfg), vocab_size=16384)
    wide = tbart.Bart(big, logits_bias=True, device="meta")
    lab = {"input_ids": torch.ones((1, 4), dtype=torch.long), "attention_mask": torch.ones((1, 4), dtype=torch.long),
           "labels": torch.ones((1, 3), dtype=torch.long)}
    with pytest.raises(ValueError, match="final_logits_bias"):
        tbart.loss_fn(wide, lab)


def test_per_row_cursor_positions():
    """The decoder's learned positions read at cursor + 2 per row: rows
    decoded at different cursors, one token a step, give the full
    decode's logits of their own streams."""
    params = jbart.init_bart(jax.random.key(3), CFG)
    model = port_model(params, CFG)
    enc, mask = enc_batch(4)
    dec = np.random.default_rng(6).integers(3, CFG.vocab_size, (3, 6)).astype(np.int32)
    start = torch.tensor([0, 2, 1])  # row b's stream starts at step start[b]
    total = 8
    with torch.inference_mode():
        enc_out = model.encode(torch.from_numpy(enc), torch.from_numpy(mask))
        full = model.decode(torch.from_numpy(dec), enc_out, torch.from_numpy(mask)).numpy()
        cache = model.make_cache(3, total + 1)
        ckv = model.precompute_cross_kv(enc_out)
        got = np.zeros_like(full)
        jj = torch.arange(total)[None, None, :]
        for step in range(dec.shape[1] + 2):
            cursor = (step - start).clamp(0, total)
            live = (step >= start) & (cursor < dec.shape[1])
            toks = torch.from_numpy(dec)[torch.arange(3), cursor.clamp_max(dec.shape[1] - 1)]
            logits = model.decode(toks[:, None], None, torch.from_numpy(mask), (jj <= cursor[:, None, None]),
                                  positions=cursor[:, None], cache=cache, cache_index=torch.where(live, cursor, total),
                                  cross_kv=ckv)[:, 0].numpy()
            for b in range(3):
                if live[b]:
                    got[b, cursor[b]] = logits[b]
    np.testing.assert_allclose(got, full, atol=1e-4, rtol=0)


def test_forced_bos_beams_match_jax():
    params = jbart.init_bart(jax.random.key(5), CFG)
    model = port_model(params, CFG)
    enc, mask = enc_batch(8, b=4)
    kw = dict(max_new_tokens=7, num_beams=4, eos_id=2, bos_id=2, forced_bos_id=11, forced_eos_id=2)
    want = np.asarray(jg.beam_search_seq2seq(params, CFG, jnp.asarray(enc), jnp.asarray(mask), **kw))
    got = tg.beam_search_seq2seq(model, torch.from_numpy(enc), torch.from_numpy(mask), **kw).numpy()
    assert np.array_equal(got, want)
    assert (got[:, 0] == 11).all() and (got[:, -1] == 2).all()


def test_scan_layers_refused():
    with pytest.raises(ValueError, match="scan-over-layers"):
        tbart.init(dataclasses.replace(port_cfg(CFG), scan_layers=True), torch.Generator().manual_seed(0))
