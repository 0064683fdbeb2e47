"""Port parity: repro_torch.core.packing against repro.core.packing.

Inputs are made with numpy from a seed and go through both packages.
Tolerance: none, words and values must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro_torch.core import packing


def _values(bits, shape, seed):
    g = np.random.default_rng(seed)
    lo = 0 if bits == 1 else -(1 << (bits - 1))
    hi = 1 if bits == 1 else (1 << (bits - 1)) - 1
    return g.integers(lo, hi, size=shape, endpoint=True).astype(np.int32)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 256])
def test_pack_unpack_match_repro(bits, n):
    v = _values(bits, (3, n), seed=bits * 1000 + n)
    want = np.asarray(jpacking.pack(jnp.asarray(v), bits))
    got = packing.pack(torch.from_numpy(v), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = packing.unpack(got, bits, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpacking.unpack(jnp.asarray(want), bits, n)))
    np.testing.assert_array_equal(back.numpy(), v)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_bit31_field_wraps_like_repro(bits):
    """The top field of a word lands in the sign bit: an all-ones word is
    -1 in both packages, and a top-field-only word is INT32_MIN-based."""
    vpw = packing.values_per_word(bits)
    top = 1 if bits == 1 else (1 << (bits - 1)) - 1
    v = np.zeros((2, vpw), np.int32)
    if bits > 1:
        v[:] = -(1 << (bits - 1))       # biased fields of zero
    v[0, :] = top                        # every field all-ones
    v[1, -1] = top                       # only the bit-31 field set
    want = np.asarray(jpacking.pack(jnp.asarray(v), bits))
    got = packing.pack(torch.from_numpy(v), bits).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == -1 and got[1, 0] < 0


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_bool_and_numpy_twins_match_repro(bits):
    v = _values(bits, (4, 77), seed=bits)
    np.testing.assert_array_equal(packing.pack_np(v, bits),
                                  jpacking.pack_np(v, bits))
    w = jpacking.pack_np(v, bits)
    np.testing.assert_array_equal(packing.unpack_np(w, bits, 77),
                                  jpacking.unpack_np(w, bits, 77))
    if bits == 1:
        got = packing.pack_bool(torch.from_numpy(v.astype(bool)))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jpacking.pack_bool(jnp.asarray(v))))
        np.testing.assert_array_equal(packing.unpack_bool(got, 77).numpy(),
                                      v)
