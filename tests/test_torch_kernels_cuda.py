"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every case is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  This file imports neither JAX nor ``repro``, so it also runs on
a GPU machine without JAX (with ``--noconftest``, since the suite's
conftest imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q \
        tests/test_torch_kernels_cuda.py

Tolerance: none; membranes and packed spike words must be bit-exact, and
each wrapper call must add exactly one to its launch counter.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.kernels.fused_conv import ops as conv_ops
from repro_torch.kernels.fused_conv.ref import fused_conv_rollout_torch
from repro_torch.kernels.fused_group import ops as group_ops
from repro_torch.kernels.fused_group.ref import fused_group_rollout_torch
from repro_torch.kernels.fused_nce import ops as nce_ops
from repro_torch.kernels.fused_nce.ref import fused_nce_rollout_torch
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.quant.ptq import quantize, quantize_conv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card for the hand-written kernels")
    return torch.device("cuda")


def _spikes(shape, seed, density=0.2):
    s = np.random.default_rng(seed).random(shape) < density
    return torch.from_numpy(packing.pack_np(s.astype(np.int32), 1))


def _theta(seed, n, bits):
    qmax = (1 << (bits - 1)) - 1
    g = np.random.default_rng(seed + 1)
    return torch.from_numpy(
        g.integers(1, 6 * qmax + 2, size=(n,)).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c_in,c_out,k,stride,padding,bits,soft", [
    (32, 32, 64, 64, 3, 1, "SAME", 4, True),    # vgg9 convs.1
    (16, 16, 128, 128, 3, 1, "SAME", 8, True),  # vgg9 convs.3
    (8, 8, 128, 256, 3, 1, "SAME", 2, False),   # vgg9 convs.4
    (9, 7, 40, 36, 3, 2, "SAME", 8, True),      # stride 2, ragged channels
    (9, 9, 33, 70, 1, 2, "SAME", 4, False),     # stride-2 1x1 projection
    (7, 6, 20, 40, 3, 1, "VALID", 8, True),
])
def test_fused_conv_kernel_matches_plain(cuda, h, w, c_in, c_out, k, stride,
                                         padding, bits, soft):
    seed = h * 1000 + c_in
    planes = _spikes((4, 3, h, w, c_in), seed).to(cuda)
    wf = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (k, k, c_in, c_out)) * 0.2).astype(np.float32))
    qct = quantize_conv(wf, PrecisionConfig(bits=bits)).to(cuda)
    kw = dict(stride=stride, padding=padding, leak_shift=3, v_reset_q=-3,
              soft_reset=soft, threshold_q=_theta(seed, c_out, bits).to(cuda))
    pv, ps = fused_conv_rollout_torch(planes, qct, **kw)
    before = conv_ops.fused_conv_rollout.launches
    kv, ks = conv_ops.fused_conv_rollout(planes, qct, **kw)
    torch.cuda.synchronize()
    assert conv_ops.fused_conv_rollout.launches == before + 1
    assert kv.shape == pv.shape and ks.shape == ps.shape
    assert torch.equal(kv, pv) and torch.equal(ks, ps)
    assert ps.any() and not torch.equal(ps, torch.full_like(ps, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d_in,d_out,bits,soft", [
    (8, 4096, 512, 4, True),     # vgg9 fc1
    (13, 75, 45, 2, False),      # ragged rows and widths
    (3, 1000, 100, 8, True),
])
def test_fused_nce_kernel_matches_plain(cuda, m, d_in, d_out, bits, soft):
    spikes = _spikes((4, m, d_in), d_in).to(cuda)
    wf = torch.from_numpy((np.random.default_rng(d_in).standard_normal(
        (d_out, d_in)) * 0.2).astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits)).to(cuda)
    kw = dict(d_in=d_in, leak_shift=3, v_reset_q=2, soft_reset=soft,
              threshold_q=_theta(d_in, d_out, bits).to(cuda))
    pv, ps = fused_nce_rollout_torch(spikes, qt, **kw)
    before = nce_ops.fused_nce_rollout.launches
    kv, ks = nce_ops.fused_nce_rollout(spikes, qt, **kw)
    torch.cuda.synchronize()
    assert nce_ops.fused_nce_rollout.launches == before + 1
    assert torch.equal(kv, pv) and torch.equal(ks, ps)
    assert ps.any()


@pytest.mark.cuda
def test_empty_rollout_launches_nothing(cuda):
    qct = quantize_conv(torch.randn(3, 3, 32, 32),
                        PrecisionConfig(bits=4)).to(cuda)
    before = conv_ops.fused_conv_rollout.launches
    v, s = conv_ops.fused_conv_rollout(
        torch.zeros((0, 2, 5, 5, 1), dtype=torch.int32, device=cuda), qct,
        leak_shift=3, threshold_q=4)
    assert conv_ops.fused_conv_rollout.launches == before
    assert v.shape == (2, 5, 5, 32) and s.shape == (0, 2, 5, 5, 1)
    assert not v.any()


def _group_members(spec, c_in, bits, seed, cuda):
    """A fusion chain like [64, "P", 128] with random codes and thetas."""
    g = np.random.default_rng(seed)
    members, c = [], c_in
    for item in spec:
        if item == "P":
            members.append(("pool", 2))
            continue
        wf = torch.from_numpy((g.standard_normal((3, 3, c, item))
                               * 0.2).astype(np.float32))
        qct = quantize_conv(wf, PrecisionConfig(bits=bits)).to(cuda)
        members.append(("conv", qct, _theta(seed + item, item, bits)
                        .mul(3).to(cuda)))
        c = item
    return tuple(members)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c_in,spec,bits,soft", [
    (32, 64, [64, "P", 128, 128, "P", 256, "P"], 4, True),  # vgg9 chain
    (16, 128, [128, 128], 8, False),                         # resnet18 body
    (4, 512, [512, 512], 2, True),                           # resnet18 body
    (12, 20, [40, "P", 36, "P"], 8, True),                   # ragged, pool
])
def test_fused_group_kernel_matches_plain(cuda, hw, c_in, spec, bits, soft):
    members = _group_members(spec, c_in, bits, hw + bits, cuda)
    planes = _spikes((4, 3, hw, hw, c_in), hw * 7).to(cuda)
    kw = dict(leak_shift=3, v_reset_q=-3, soft_reset=soft)
    pv, ps = fused_group_rollout_torch(planes, members, **kw)
    before = group_ops.fused_group_rollout.launches
    kv, ks = group_ops.fused_group_rollout(planes, members, **kw)
    torch.cuda.synchronize()
    assert group_ops.fused_group_rollout.launches == before + 1
    assert kv.shape == pv.shape and ks.shape == ps.shape
    assert torch.equal(kv, pv) and torch.equal(ks, ps)
    assert pv.any()


@pytest.mark.cuda
def test_fused_group_empty_rollout_and_budget(cuda):
    members = _group_members([32, 32], 32, 4, 1, cuda)
    before = group_ops.fused_group_rollout.launches
    v, s = group_ops.fused_group_rollout(
        torch.zeros((0, 2, 6, 6, 1), dtype=torch.int32, device=cuda),
        members, leak_shift=3)
    assert v.shape == (2, 6, 6, 32) and s.shape == (0, 2, 6, 6, 1)
    big = _group_members([64, 64], 64, 4, 2, cuda)
    with pytest.raises(ValueError, match="shared memory > budget"):
        group_ops.fused_group_rollout(
            torch.zeros((1, 1, 256, 256, 2), dtype=torch.int32,
                        device=cuda), big, leak_shift=3)
    assert group_ops.fused_group_rollout.launches == before
