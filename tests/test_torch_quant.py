"""Parity of the port's int8 quantization with the JAX package: codes and
scales must be bit-identical (same f32 division, round half to even,
clamp to +-127)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietnamese_qa_system_tpu.ops import quant as jq
from vietnamese_qa_system_tpu_torch.ops import quant as tq

torch.set_num_threads(2)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0, (shape[0], 1))).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-12 scale floor
    x[-1, :4] = [0.5, -0.5, 1.5, -2.5]  # exact halves round to even
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("shape", [(7, 16), (64, 128), (5, 768)])
def test_int8_reference_bit_identical(shape):
    x = _inputs(shape, 0)
    jqv, jsc = jq.quantize_int8_reference(jnp.asarray(x))
    tqv, tsc = tq.quantize_int8_reference(torch.from_numpy(x))
    assert tqv.dtype == torch.int8 and tsc.shape == (shape[0],)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_bits(tsc.numpy()), _bits(jsc))


@pytest.mark.parametrize("shape", [(7, 16), (64, 128)])
def test_int8_residual_bit_identical(shape):
    x = _inputs(shape, 1)
    for j, t in zip(jq.quantize_int8_residual(jnp.asarray(x)), tq.quantize_int8_residual(torch.from_numpy(x))):
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


@pytest.mark.parametrize("shape", [(7, 16), (64, 128)])
def test_int8_global_bit_identical(shape):
    x = _inputs(shape, 2)
    jqv, jsc = jq.quantize_int8_global(jnp.asarray(x))
    tqv, tsc = tq.quantize_int8_global(torch.from_numpy(x))
    assert tsc.ndim == 0
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_bits(tsc.numpy()), _bits(jsc))


def test_dequantize_matches():
    x = _inputs((9, 32), 3)
    jqv, jsc = jq.quantize_int8_reference(jnp.asarray(x))
    out = tq.dequantize_int8(torch.from_numpy(np.asarray(jqv)), torch.from_numpy(np.asarray(jsc)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jq.dequantize_int8(jqv, jsc)))


@pytest.mark.parametrize("shape", [(7, 16), (300, 64), (5, 768)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_matches_jax_kernel(shape, dtype):
    """K8's CPU route (its plain version) against the XLA reference (codes
    and scales bit-equal) and the Pallas kernel in interpret mode, for f32
    and bf16 inputs and ragged row counts (300 rows over 256-row tiles).

    The Pallas kernel runs under jit, where XLA turns ``absmax / 127`` into
    a product with the reciprocal: its scales are up to one ulp off its own
    reference (a fault of the JAX package).  Its codes equal the port's
    wherever its scale is the reference's."""
    x = _inputs(shape, 4)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tqv, tsc = tq.quantize_int8(tx)
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float32 and tsc.shape == (shape[0],)
    rqv, rsc = jq.quantize_int8_reference(jx)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(rqv))
    np.testing.assert_array_equal(_bits(tsc.numpy()), _bits(rsc))
    kqv, ksc = jq.quantize_int8(jx)
    ulps = np.abs(_bits(ksc).astype(np.int64) - _bits(tsc.numpy()).astype(np.int64))
    assert ulps.max() <= 1
    same = ulps == 0
    np.testing.assert_array_equal(np.asarray(kqv)[same], tqv.numpy()[same])
    with pytest.raises(ValueError, match="expects"):
        tq.quantize_int8(tx[0])
