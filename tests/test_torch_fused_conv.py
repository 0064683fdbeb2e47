"""The fused packed-conv rollout of the port.

* The plain PyTorch version (and the ops wrapper on CPU tensors) against
  ``repro``'s ``fused_conv_ops.fused_conv_rollout`` on its default ``jnp``
  backend, over bits x reset x padding x stride x kernel size, with
  ``c_in``/``c_out`` that are not multiples of 32, and T in {0, 1, 3}.
  Membranes and packed words must be bit-exact.
* The CUDA kernel itself is held against the plain version on the card
  in test_torch_kernels_cuda.py.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_conv_ops as jops
from repro.quant.formats import PrecisionConfig as JPC
from repro.quant.ptq import quantize_conv as jquantize_conv
from repro_torch.core import packing
from repro_torch.kernels.fused_conv import ops
from repro_torch.kernels.fused_conv.ref import fused_conv_rollout_torch
from repro_torch.quant.formats import PrecisionConfig, QuantizedConvTensor
from repro_torch.quant.ptq import quantize_conv


def _case(t, b, h, w, c_in, c_out, k, bits, seed, density=0.3):
    """Numpy inputs: packed spike planes, float HWIO weights, thetas."""
    g = np.random.default_rng(seed)
    s = (g.random((t, b, h, w, c_in)) < density).astype(np.int32)
    planes = packing.pack_np(s, 1)
    wf = (g.standard_normal((k, k, c_in, c_out)) * 0.2).astype(np.float32)
    qmax = (1 << (bits - 1)) - 1
    theta = g.integers(1, 3 * qmax + 2, size=(c_out,)).astype(np.int32)
    return planes, wf, theta


def _port_qct(jqct):
    return QuantizedConvTensor(
        data=torch.from_numpy(np.asarray(jqct.data)),
        scale=torch.from_numpy(np.asarray(jqct.scale)),
        shape=tuple(jqct.shape), bits=jqct.bits, c_in_pad=jqct.c_in_pad)


MATRIX = list(itertools.product((2, 4, 8), (True, False), ("SAME", "VALID"),
                                (1, 2), (3, 1)))


@pytest.mark.parametrize("bits,soft,padding,stride,k", MATRIX)
def test_plain_matches_repro(bits, soft, padding, stride, k):
    planes, wf, theta = _case(3, 2, 9, 7, 40, 36, k, bits,
                              seed=bits * 100 + stride * 10 + k)
    jq = jquantize_conv(jnp.asarray(wf), JPC(bits=bits))
    kw = dict(stride=stride, padding=padding, leak_shift=2, v_reset_q=-1,
              soft_reset=soft)
    jv, js = jops.fused_conv_rollout(jnp.asarray(planes), jq,
                                     threshold_q=jnp.asarray(theta), **kw)
    tv, ts = fused_conv_rollout_torch(torch.from_numpy(planes),
                                      _port_qct(jq),
                                      threshold_q=torch.from_numpy(theta),
                                      **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.asarray(js).any(), "vacuous case: no output spikes"


@pytest.mark.parametrize("t_steps", [0, 1, 3])
@pytest.mark.parametrize("bits", [2, 8])
def test_ops_cpu_matches_repro_over_t(t_steps, bits):
    planes, wf, theta = _case(t_steps, 2, 6, 6, 33, 70, 3, bits, seed=t_steps)
    jq = jquantize_conv(jnp.asarray(wf), JPC(bits=bits))
    kw = dict(stride=1, padding="SAME", leak_shift=3, soft_reset=True)
    jv, js = jops.fused_conv_rollout(jnp.asarray(planes), jq,
                                     threshold_q=jnp.asarray(theta), **kw)
    tv, ts = ops.fused_conv_rollout(torch.from_numpy(planes),
                                    quantize_conv(torch.from_numpy(wf),
                                                  PrecisionConfig(bits=bits)),
                                    threshold_q=torch.from_numpy(theta), **kw)
    assert ts.shape == np.asarray(js).shape
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ops_rejects_mismatched_plane_width():
    planes, wf, theta = _case(1, 1, 4, 4, 40, 8, 3, 4, seed=0)
    qct = quantize_conv(torch.from_numpy(wf), PrecisionConfig(bits=4))
    with pytest.raises(ValueError, match="channel words"):
        ops.fused_conv_rollout(torch.from_numpy(planes[..., :1]), qct,
                               leak_shift=3, threshold_q=5)
    qct.data = qct.data[:, :-1]
    with pytest.raises(ValueError, match="the geometry needs"):
        ops.fused_conv_rollout(torch.from_numpy(planes), qct, leak_shift=3,
                               threshold_q=5)
