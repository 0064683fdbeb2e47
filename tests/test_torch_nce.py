"""The NCE step path of the port: ``spike_matmul``, ``lif_step``,
``core/nce.py`` and ``core/encoding.py``.

Inputs come from numpy seeds and go through ``repro`` (its default
``jnp`` backend) and the port on the CPU, where each wrapper runs its
kernel's plain version.  Everything integer is bit-exact: currents,
membranes, packed spike words, packed weight words.  ``rate_encode``
draws from a ``torch.Generator`` in the port and from ``jax.random`` in
JAX, so it is held to the same firing rate only.  The CUDA kernels are
held against these plain versions on the card in
test_torch_kernels_cuda.py and chip_smoke.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import nce as jnce
from repro.core import packing as jpacking
from repro.kernels.lif_step.ref import lif_step_ref as jlif_ref
from repro.kernels.spike_matmul.ref import spike_matmul_ref as jsm_ref
from repro.quant.formats import PrecisionConfig as JPC
from repro.quant.ptq import quantize as jquantize
from repro_torch import convert
from repro_torch.core import encoding, nce, packing
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step.ref import lif_step_ref
from repro_torch.kernels.spike_matmul import ops as sm_ops
from repro_torch.kernels.spike_matmul.ref import spike_matmul_ref
from repro_torch.quant.formats import PrecisionConfig


def _spikes(shape, seed, density=0.3):
    s = np.random.default_rng(seed).random(shape) < density
    return packing.pack_np(s.astype(np.int32), 1)


def _weights(d_in, d_out, bits, seed):
    wf = (np.random.default_rng(seed).standard_normal((d_in, d_out))
          * 0.2).astype(np.float32)
    jqt = jquantize(jnp.asarray(wf.T), JPC(bits=bits))
    return wf, jqt, convert.quantized_from_numpy(
        jax.tree.map(np.asarray, jqt), device="cpu")


@pytest.mark.parametrize("bits,d_in", list(itertools.product(
    (2, 4, 8), (64, 75, 129))))
def test_spike_matmul_plain_matches_repro(bits, d_in):
    d_out = 45
    sp = _spikes((2, 3, d_in), seed=bits + d_in)
    if d_in % 32:      # stray bits past d_in must be inert in both
        sp[..., -1] |= np.int32(-1 << (d_in % 32))
    _, jqt, qt = _weights(d_in, d_out, bits, seed=d_in)
    want = np.asarray(jsm_ref(jnp.asarray(sp), jqt, d_in=d_in))
    got = spike_matmul_ref(torch.from_numpy(sp), qt, d_in=d_in)
    via_ops = sm_ops.spike_matmul(torch.from_numpy(sp), qt, d_in=d_in)
    assert got.dtype == torch.int32 and got.shape == (2, 3, d_out)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(via_ops, got)
    assert np.abs(want).sum() > 0


@pytest.mark.parametrize("soft,shape", [(True, (4, 37)), (False, (4, 37)),
                                        (True, (2, 3, 64)),
                                        (False, (2, 3, 64))])
def test_lif_step_plain_matches_repro(soft, shape):
    g = np.random.default_rng(len(shape))
    v = g.integers(-400, 400, shape).astype(np.int32)   # negative: >> floors
    i = g.integers(-150, 250, shape).astype(np.int32)
    kw = dict(leak_shift=3, threshold_q=64, v_reset_q=-7, soft_reset=soft)
    jv, js = jlif_ref(jnp.asarray(v), jnp.asarray(i), **kw)
    pv, ps = lif_step_ref(torch.from_numpy(v), torch.from_numpy(i), **kw)
    ov, os_ = lif_ops.lif_step(torch.from_numpy(v), torch.from_numpy(i), **kw)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert torch.equal(ov, pv) and torch.equal(os_, ps)
    assert 0 < int(ps.sum()) < ps.numel()


@pytest.mark.parametrize("soft,shape", [(True, (4, 37)), (False, (4, 37)),
                                        (True, (8, 100)), (False, (8, 100)),
                                        (True, (2, 3, 64)), (False, (8, 512))])
def test_lif_step_packed_plain_matches_repro(soft, shape):
    """The packed entry's plain version (lif_step_ref, then pack_bool)
    against JAX's lif_step_ref and pack_bool: v' and the words, bit 31
    (the sign bit) and the zero bits past a ragged row's end included."""
    g = np.random.default_rng(shape[-1] + soft)
    v = g.integers(-400, 400, shape).astype(np.int32)
    i = g.integers(-150, 250, shape).astype(np.int32)
    kw = dict(leak_shift=3, threshold_q=64, v_reset_q=-7, soft_reset=soft)
    jv, js = jlif_ref(jnp.asarray(v), jnp.asarray(i), **kw)
    jwords = np.asarray(jpacking.pack_bool(js))
    before = lif_ops.lif_step.launches
    pv, pw = lif_ops.lif_step_packed(torch.from_numpy(v),
                                     torch.from_numpy(i), **kw)
    assert lif_ops.lif_step.launches == before      # no kernel on the CPU
    assert pw.dtype == torch.int32
    assert pw.shape == (*shape[:-1], -(-shape[-1] // 32))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pw.numpy(), jwords)
    if shape[-1] % 32 == 0:
        assert (pw.numpy() < 0).any()               # a bit-31 spike wraps
    else:
        assert not (pw.numpy()[..., -1] >> (shape[-1] % 32)).any()


def _engines(bits, soft, d_in=75, d_out=45):
    theta = {2: 3, 4: 8, 8: 24}[bits]    # some neurons fire, some do not
    wf, _, _ = _weights(d_in, d_out, bits, seed=bits * 7 + d_in)
    jcfg = jnce.NCEConfig(precision=JPC(bits=bits), threshold_q=theta,
                          soft_reset=soft)
    cfg = nce.NCEConfig(precision=PrecisionConfig(bits=bits),
                        threshold_q=theta, soft_reset=soft)
    jeng = jnce.NeuronComputeEngine.from_float(jcfg, jnp.asarray(wf))
    eng = nce.NeuronComputeEngine.from_float(cfg, torch.from_numpy(wf))
    return jeng, eng


@pytest.mark.parametrize("bits,soft", list(itertools.product(
    (2, 4, 8), (True, False))))
def test_engine_step_and_unfused_rollout_match_repro(bits, soft):
    jeng, eng = _engines(bits, soft)
    # the packed weights of from_float are the same words and scales
    np.testing.assert_array_equal(eng.weights.data.numpy(),
                                  np.asarray(jeng.weights.data))
    np.testing.assert_array_equal(eng.weights.scale.numpy(),
                                  np.asarray(jeng.weights.scale))
    assert (eng.d_in, eng.d_out) == (jeng.d_in, jeng.d_out) == (75, 45)
    sp = _spikes((5, 4, 75), seed=bits)
    v0 = np.random.default_rng(bits).integers(-50, 50, (4, 45)).astype(
        np.int32)
    jv, js = jeng.step(jnp.asarray(v0), jnp.asarray(sp[0]))
    pv, ps = eng.step(torch.from_numpy(v0), torch.from_numpy(sp[0]))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        eng.accumulate(torch.from_numpy(sp[1])).numpy(),
        np.asarray(jeng.accumulate(jnp.asarray(sp[1]))))
    jv, js = jeng.rollout_unfused(jnp.asarray(sp))
    pv, ps = eng.rollout_unfused(torch.from_numpy(sp))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert ps.shape == (5, 4, 2) and ps.any()
    assert not torch.equal(ps, torch.full_like(ps, -1))


@pytest.mark.parametrize("bits,soft,d_in,d_out", [
    (b, s, d_in, d_out) for b in (2, 4, 8) for s in (True, False)
    for d_in, d_out in ((130, 100), (96, 512))])
def test_step_and_unfused_rollout_match_repro_at_served_widths(
        bits, soft, d_in, d_out):
    """``step`` (spike_matmul, then the packed LIF entry) and
    ``rollout_unfused`` against JAX's ``step`` (lif_step, then
    pack_bool) at a ragged d_out (100) and fc1's (512)."""
    jeng, eng = _engines(bits, soft, d_in=d_in, d_out=d_out)
    sp = _spikes((3, 8, d_in), seed=bits + d_out)
    v0 = np.random.default_rng(d_out).integers(-60, 60, (8, d_out)).astype(
        np.int32)
    jv, js = jeng.step(jnp.asarray(v0), jnp.asarray(sp[0]))
    pv, ps = eng.step(torch.from_numpy(v0), torch.from_numpy(sp[0]))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    jv, js = jeng.rollout_unfused(jnp.asarray(sp))
    pv, ps = eng.rollout_unfused(torch.from_numpy(sp))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert ps.shape == (3, 8, -(-d_out // 32)) and ps.any()


@pytest.mark.parametrize("bits,soft,t_steps", [
    (2, True, 4), (4, False, 4), (8, True, 1), (4, True, 0)])
def test_unfused_rollout_equals_fused_rollout(bits, soft, t_steps):
    _, eng = _engines(bits, soft, d_in=100, d_out=70)
    sp = torch.from_numpy(_spikes((t_steps, 6, 100), seed=bits + t_steps))
    fv, fs = eng.rollout(sp)
    uv, us = eng.rollout_unfused(sp)
    assert torch.equal(fv, uv) and torch.equal(fs, us)
    assert fs.shape == (t_steps, 6, 3)


def test_unfused_rollout_counts_nothing_on_the_cpu():
    """The launch counters count kernel launches only: a CPU rollout runs
    the plain versions and leaves them alone."""
    _, eng = _engines(4, True)
    before = (sm_ops.spike_matmul.launches, lif_ops.lif_step.launches)
    eng.rollout_unfused(torch.from_numpy(_spikes((3, 2, 75), seed=1)))
    assert (sm_ops.spike_matmul.launches,
            lif_ops.lif_step.launches) == before


def test_engine_refuses_mismatched_precision():
    _, _, qt = _weights(64, 32, 4, seed=0)
    with pytest.raises(ValueError, match="weight bits"):
        nce.NeuronComputeEngine(
            nce.NCEConfig(precision=PrecisionConfig(bits=8)), qt)


def test_engine_from_converted_weights_matches_repro():
    """An engine built from a JAX engine's weights (convert) steps the same
    bits."""
    jeng, _ = _engines(4, True)
    eng = nce.NeuronComputeEngine(
        nce.NCEConfig(precision=PrecisionConfig(bits=4), threshold_q=8),
        convert.quantized_from_numpy(jax.tree.map(np.asarray, jeng.weights),
                                     device="cpu"))
    sp = _spikes((3, 2, 75), seed=5)
    jv, js = jeng.rollout_unfused(jnp.asarray(sp))
    pv, ps = eng.rollout_unfused(torch.from_numpy(sp))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_throughput_model_matches_repro(bits):
    want = jnce.throughput_model(jnce.NCEConfig(precision=JPC(bits=bits)),
                                 12345)
    got = nce.throughput_model(
        nce.NCEConfig(precision=PrecisionConfig(bits=bits)), 12345)
    assert got == want and got["simd_lanes"] == 32 // bits


def _analog(shape, seed):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    x.reshape(-1)[:3] = (-0.5, 0.0, 1.5)   # clamped at both ends
    return x


@pytest.mark.parametrize("timesteps", (1, 4, 7))
def test_direct_and_latency_encoding_match_repro(timesteps):
    x = _analog((3, 40), seed=timesteps)
    np.testing.assert_array_equal(
        encoding.direct_encode(torch.from_numpy(x), timesteps).numpy(),
        np.asarray(jenc.direct_encode(jnp.asarray(x), timesteps)))
    lat = encoding.latency_encode(torch.from_numpy(x), timesteps)
    want = np.asarray(jenc.latency_encode(jnp.asarray(x), timesteps))
    assert lat.dtype == torch.int8
    np.testing.assert_array_equal(lat.numpy(), want)
    np.testing.assert_array_equal(
        encoding.spike_rate(lat).numpy(),
        np.asarray(jenc.spike_rate(jnp.asarray(want))))


def test_spike_train_packing_matches_repro():
    s = (np.random.default_rng(3).random((4, 2, 70)) < 0.4).astype(np.int8)
    words = encoding.pack_spike_train(torch.from_numpy(s))
    want = np.asarray(jenc.pack_spike_train(jnp.asarray(s)))
    np.testing.assert_array_equal(words.numpy(), want)
    back = encoding.unpack_spike_train(words, 70)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jenc.unpack_spike_train(jnp.asarray(want),
                                                         70)))
    np.testing.assert_array_equal(back.numpy(), s)


def test_rate_encoding_has_the_same_rate_as_repro():
    """Different generators, same distribution: over 4000 draws per input
    the mean rate of each input is within 0.05 of its clamped value (the
    binomial standard error is <= 0.008) in both frameworks."""
    x = _analog((6,), seed=9)
    t = 4000
    s = encoding.rate_encode(torch.Generator().manual_seed(0),
                             torch.from_numpy(x), t)
    js = np.asarray(jenc.rate_encode(jax.random.PRNGKey(0), jnp.asarray(x),
                                     t))
    assert s.dtype == torch.int8 and s.shape == js.shape == (t, 6)
    p = np.clip(x, 0, 1)
    np.testing.assert_allclose(s.float().mean(0).numpy(), p, atol=0.05)
    np.testing.assert_allclose(js.mean(0), p, atol=0.05)
