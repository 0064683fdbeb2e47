"""The fused NCE (dense) rollout of the port.

* The plain PyTorch version (and the ops wrapper on CPU tensors) against
  ``repro``'s ``fused_nce_ops.fused_nce_rollout`` on its default ``jnp``
  backend, over bits x reset, with ``d_in``/``d_out`` that are not
  multiples of 32, and T in {0, 1, 3}.  Bit-exact.
* The CUDA kernel itself is held against the plain version on the card
  in test_torch_kernels_cuda.py.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_nce_ops as jops
from repro.quant.formats import PrecisionConfig as JPC
from repro.quant.ptq import quantize as jquantize
from repro_torch.core import packing
from repro_torch.kernels.fused_nce import ops
from repro_torch.kernels.fused_nce.ref import fused_nce_rollout_torch
from repro_torch.quant.formats import PrecisionConfig, QuantizedTensor
from repro_torch.quant.ptq import quantize


def _case(t, m, d_in, d_out, bits, seed, density=0.3):
    g = np.random.default_rng(seed)
    s = (g.random((t, m, d_in)) < density).astype(np.int32)
    spikes = packing.pack_np(s, 1)
    wf = (g.standard_normal((d_out, d_in)) * 0.2).astype(np.float32)
    qmax = (1 << (bits - 1)) - 1
    theta = g.integers(1, 3 * qmax + 2, size=(d_out,)).astype(np.int32)
    return spikes, wf, theta


def _port_qt(jqt):
    return QuantizedTensor(
        data=torch.from_numpy(np.asarray(jqt.data)),
        scale=torch.from_numpy(np.asarray(jqt.scale)), zero=None,
        shape=tuple(jqt.shape), bits=jqt.bits, group_size=jqt.group_size)


@pytest.mark.parametrize("bits,soft,t_steps", list(itertools.product(
    (2, 4, 8), (True, False), (0, 1, 3))))
def test_plain_matches_repro(bits, soft, t_steps):
    d_in, d_out = 75, 45
    spikes, wf, theta = _case(t_steps, 5, d_in, d_out, bits,
                              seed=bits * 10 + t_steps)
    jq = jquantize(jnp.asarray(wf), JPC(bits=bits))
    kw = dict(d_in=d_in, leak_shift=2, v_reset_q=1, soft_reset=soft)
    jv, js = jops.fused_nce_rollout(jnp.asarray(spikes), jq,
                                    threshold_q=jnp.asarray(theta), **kw)
    tv, ts = fused_nce_rollout_torch(torch.from_numpy(spikes), _port_qt(jq),
                                     threshold_q=torch.from_numpy(theta),
                                     **kw)
    assert ts.shape == np.asarray(js).shape
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if t_steps:
        assert np.asarray(js).any(), "vacuous case: no output spikes"


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_ops_cpu_matches_repro(bits):
    d_in, d_out = 96, 64
    spikes, wf, theta = _case(3, 8, d_in, d_out, bits, seed=bits)
    jq = jquantize(jnp.asarray(wf), JPC(bits=bits))
    jv, js = jops.fused_nce_rollout(jnp.asarray(spikes), jq, d_in=d_in,
                                    leak_shift=3,
                                    threshold_q=jnp.asarray(theta))
    tv, ts = ops.fused_nce_rollout(
        torch.from_numpy(spikes),
        quantize(torch.from_numpy(wf), PrecisionConfig(bits=bits)),
        d_in=d_in, leak_shift=3, threshold_q=torch.from_numpy(theta))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ops_rejects_wrong_d_in():
    spikes, wf, theta = _case(1, 2, 64, 32, 4, seed=0)
    qt = quantize(torch.from_numpy(wf), PrecisionConfig(bits=4))
    with pytest.raises(ValueError, match="d_in"):
        ops.fused_nce_rollout(torch.from_numpy(spikes), qt, d_in=60,
                              leak_shift=3, threshold_q=4)
    qt.data = qt.data[:-1]
    with pytest.raises(ValueError, match="words"):
        ops.fused_nce_rollout(torch.from_numpy(spikes), qt, d_in=64,
                              leak_shift=3, threshold_q=4)
