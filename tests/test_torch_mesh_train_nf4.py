"""QLoRA over nf4 and nf4-dq bases split over a model axis:

- the port's trainer against the JAX ``Trainer`` on the same mesh shape
  (JAX tests/test_quantize_base.py:149-177's setup: ``tiny_test("causal")``,
  LoRA r 4, ``fsdp_tp`` on ``{"data": 2, "model": 4}``, and ``tp`` on
  ``{"model": 4}``), by test_torch_mesh_train.py's tolerances and move
  rules; the whole base assembled from the parts bit-equal to JAX's codes;
- ``layers.split_dense``'s nf4 / nf4-dq column and row parts, put back
  through their ``tp_index``, bit-equal to the whole leaves, and the
  refusal of a row range that cuts a packed byte.

The JAX side runs on the conftest's virtual CPU devices, the port on
``["cpu"] * n``."""

import numpy as np
import pytest
import torch

from test_torch_mesh_train import check_lora_step
from vietnamese_qa_system_tpu_torch.models.layers import Dense, dequantize_weight, split_dense
from vietnamese_qa_system_tpu_torch.models.quantize import quantize_weight

torch.set_num_threads(2)


@pytest.mark.parametrize("strategy,axes", [("tp", {"model": 4}), ("fsdp_tp", {"data": 2, "model": 4})])
@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
def test_nf4_lora_step_matches_jax_trainer(tmp_path, mode, strategy, axes):
    check_lora_step(tmp_path, strategy, axes, mode)


def _dense(mode, d_in=256, d_out=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    dense = Dense(d_in, d_out, use_bias=True)
    with torch.no_grad():
        dense.b.normal_(generator=g)
    dense.set_quantized(**quantize_weight(torch.randn(d_in, d_out, generator=g), mode))
    return dense


@pytest.mark.parametrize("mode", ["nf4", "nf4-dq"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_split_dense_parts_reassemble_bit_equal(mode, n):
    """Column parts (q/k/v, wi) and row parts (wo) of an nf4 / nf4-dq layer
    (256 x 96, scale blocks of 64 rows: a row part spans whole blocks at 2
    and 4 parts and lies inside one at 8) put back through ``tp_index``
    give the whole leaves bit for bit; each part dequantizes to its slice
    of the whole weight; nf4-dq's per-block-row ``s_s`` / ``s_m`` stay whole
    in a column part."""
    dense = _dense(mode)
    d_in, d_out = dense.shape
    whole_w = dense.dequantized(torch.float32)
    leaves = {k: getattr(dense, k) for k in ("w_q", "w_s", "s_q", "s_s", "s_m") if getattr(dense, k) is not None}
    for kind, size in (("cols", d_out // n), ("rows", d_in // n)):
        got = {k: torch.full_like(t, -1) if t.is_floating_point() else torch.zeros_like(t) for k, t in leaves.items()}
        for j in range(n):
            cut = slice(j * size, (j + 1) * size)
            part = split_dense(dense, "cpu", **{kind: cut})
            assert set(part.tp_index) >= set(leaves)
            for k in leaves:
                t = getattr(part, k)
                assert t.data_ptr() != leaves[k].data_ptr()  # a part owns its storage
                assert tuple(t.shape) == tuple(s.stop - s.start for s in part.tp_index[k])
                got[k][part.tp_index[k]] = t
            if kind == "cols":
                want = whole_w[:, cut]
                if mode == "nf4-dq":
                    assert torch.equal(part.s_s, dense.s_s) and torch.equal(part.s_m, dense.s_m)
            else:
                want = whole_w[cut]
                assert part.b is None  # the row-parallel sum adds the bias once
            assert part.shape == tuple(want.shape)
            assert torch.equal(part.dequantized(torch.float32), want)
        for k in leaves:
            assert torch.equal(got[k], leaves[k]), (kind, k)


def test_split_dense_refuses_a_cut_packed_byte():
    """A row range that would cut a packed nf4 byte raises; so does one
    that straddles two scale blocks."""
    dense = _dense("nf4")
    with pytest.raises(ValueError, match="packed"):
        split_dense(dense, "cpu", rows=slice(0, 31))
    with pytest.raises(ValueError, match="straddle"):
        split_dense(dense, "cpu", rows=slice(32, 96))
    # the one block a part lies in
    part = split_dense(dense, "cpu", rows=slice(64, 96))
    assert part.tp_index["w_s"][0] == slice(1, 2) and part.tp_index["w_q"][0] == slice(32, 48)
    assert torch.equal(dequantize_weight(part.w_q, part.w_s, torch.float32), dense.dequantized(torch.float32)[64:96])
