"""Port parity: repro_torch.quant against repro.quant.

``quantize`` and ``quantize_conv`` must give identical words and scales
(the same float32 operations in the same order, and the same 16 clip
fractions); ``fake_quant`` must match within 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import ptq as jptq
from repro.quant import qat as jqat
from repro.quant.formats import PrecisionConfig as JPC
from repro_torch.quant import ptq, qat
from repro_torch.quant.formats import PrecisionConfig


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("group_size", [-1, 16])
@pytest.mark.parametrize("symmetric", [True, False])
def test_quantize_words_and_scales_identical(bits, group_size, symmetric):
    w = np.random.default_rng(bits + group_size).standard_normal(
        (24, 48)).astype(np.float32)
    want = jptq.quantize(jnp.asarray(w), JPC(bits=bits, group_size=group_size,
                                             symmetric=symmetric))
    got = ptq.quantize(torch.from_numpy(w),
                       PrecisionConfig(bits=bits, group_size=group_size,
                                       symmetric=symmetric))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
    if symmetric:
        assert got.zero is None and want.zero is None
    else:
        np.testing.assert_array_equal(got.zero.numpy(),
                                      np.asarray(want.zero))
    assert got.shape == want.shape and got.bits == bits


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(3, 3, 40, 36), (1, 1, 64, 32),
                                   (3, 3, 3, 8)])
def test_quantize_conv_identical(bits, shape):
    w = (np.random.default_rng(bits).standard_normal(shape)
         * 0.1).astype(np.float32)
    want = jptq.quantize_conv(jnp.asarray(w), JPC(bits=bits))
    got = ptq.quantize_conv(torch.from_numpy(w), PrecisionConfig(bits=bits))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
    assert got.c_in_pad == want.c_in_pad and got.shape == want.shape
    np.testing.assert_array_equal(ptq.unpack_conv_codes(got).numpy(),
                                  np.asarray(jptq.unpack_conv_codes(want)))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_matches(bits):
    w = np.random.default_rng(7).standard_normal((16, 27)).astype(np.float32)
    want = np.asarray(jqat.fake_quant(jnp.asarray(w), JPC(bits=bits)))
    want_grad = np.asarray(jax.grad(lambda x: jnp.sum(
        jqat.fake_quant(x, JPC(bits=bits))))(jnp.asarray(w)))
    x = torch.from_numpy(w).requires_grad_(True)
    got = qat.fake_quant(x, PrecisionConfig(bits=bits))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    got.sum().backward()     # straight-through inside the clip range
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0, atol=1e-6)
