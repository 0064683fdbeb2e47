"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every case is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  This file imports neither JAX nor ``repro``, so it also runs on
a GPU machine without JAX (with ``--noconftest``, since the suite's
conftest imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q \
        tests/test_torch_kernels_cuda.py

Tolerance: none for the integer kernels (fused_conv, fused_nce,
fused_group, spike_matmul, lif_step): membranes, currents and packed
spike words must be bit-exact.  The float kernels (packed_qmatmul,
kv_attention) state theirs at each test.  Each wrapper call must add
exactly one to its launch counter.
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
from repro_torch.kernels.kv_attention import ops as kv_ops
from repro_torch.kernels.kv_attention import ref as kv_ref
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step import ref as lif_ref
from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
from repro_torch.kernels.packed_qmatmul import ref as qmm_ref
from repro_torch.kernels.spike_matmul import ops as sm_ops
from repro_torch.kernels.spike_matmul import ref as sm_ref
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
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("m,d_in,d_out", [
    (1, 4096, 512), (3, 4096, 512), (8, 4096, 512), (64, 4096, 512),
    (8, 1000, 100),
])
def test_fused_nce_every_batch_bits_and_reset(cuda, m, d_in, d_out, bits,
                                               soft):
    """Any m (the served buckets 1-8 and 64), the ragged 1000 -> 100, at
    every contraction split the wrapper picks for them."""
    seed = m * 7 + d_in + bits
    spikes = _spikes((4, m, d_in), seed).to(cuda)
    wf = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (d_out, d_in)) * 0.05).astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits)).to(cuda)
    kw = dict(d_in=d_in, leak_shift=3, v_reset_q=-2, soft_reset=soft,
              threshold_q=_theta(seed, d_out, bits).mul(2).to(cuda))
    pv, ps = fused_nce_rollout_torch(spikes, qt, **kw)
    before = nce_ops.fused_nce_rollout.launches
    kv, ks = nce_ops.fused_nce_rollout(spikes, qt, **kw)
    torch.cuda.synchronize()
    assert nce_ops.fused_nce_rollout.launches == before + 1
    assert torch.equal(kv, pv) and torch.equal(ks, ps)
    assert ps.any()


def _conv_case(cuda, h, w, c_in, c_out, k, stride, bits, b, t_steps, seed,
               padding="SAME", soft=True):
    """fused_conv against its plain version: one launch, bit-exact.
    Returns the wrapper's launch plan."""
    planes = _spikes((t_steps, b, h, w, c_in), seed).to(cuda)
    wf = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (k, k, c_in, c_out)) * 0.2).astype(np.float32))
    qct = quantize_conv(wf, PrecisionConfig(bits=bits)).to(cuda)
    # thresholds up to twice the spread of a step's current at 20% density
    codes = packing.unpack(qct.data, bits, qct.k_flat).float()
    hi = max(2, int(2 * float(codes.std()) * (0.2 * k * k * c_in) ** 0.5))
    theta = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        1, hi, size=(c_out,)).astype(np.int32))
    kw = dict(stride=stride, padding=padding, leak_shift=3, v_reset_q=-3,
              soft_reset=soft, threshold_q=theta.to(cuda))
    pv, ps = fused_conv_rollout_torch(planes, qct, **kw)
    before = conv_ops.fused_conv_rollout.launches
    kv, ks = conv_ops.fused_conv_rollout(planes, qct, **kw)
    torch.cuda.synchronize()
    assert conv_ops.fused_conv_rollout.launches == before + 1
    assert kv.shape == pv.shape and ks.shape == ps.shape
    assert torch.equal(kv, pv) and torch.equal(ks, ps)
    assert ps.any() and not torch.equal(ps, torch.full_like(ps, -1))
    ho, wo = pv.shape[1:3]
    return conv_ops._conv_plan(b, ho * wo, -(-c_out // 32),
                               k * k * planes.shape[-1], qct.data.shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("h,w,c_in,c_out,k,stride", [
    (4, 4, 512, 512, 3, 1),      # resnet18 blocks.6.conv2
    (8, 8, 256, 512, 3, 2),      # blocks.6.conv1
    (32, 32, 64, 128, 1, 2),     # blocks.2.proj
    (16, 16, 128, 256, 1, 2),    # blocks.4.proj
    (8, 8, 256, 512, 1, 2),      # blocks.6.proj
])
def test_fused_conv_resnet18_geometries(cuda, h, w, c_in, c_out, k, stride,
                                        bits):
    _conv_case(cuda, h, w, c_in, c_out, k, stride, bits, 8, 4,
               seed=h * 100 + c_out + bits, soft=bits != 2)


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [True, False])
def test_fused_conv_tile_above_smem_reads_l2(cuda, soft):
    """3x3 x 1024 -> 64 at w8: 288 KB of packed codes for one 32-channel
    group, beyond SMEM_LIMIT: the codes are read from L2."""
    ks, _, staged = _conv_case(cuda, 6, 6, 1024, 64, 3, 1, 8, 2, 3,
                               seed=1024, soft=soft)
    assert not staged


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("t_steps", [1, 3, 4, 12])
def test_fused_conv_batches_and_steps(cuda, b, t_steps):
    """T in chunks of up to 4 steps with every tail, at the batch sizes a
    served bucket takes (vgg9 convs.3, and a stride-2 ragged layer)."""
    _conv_case(cuda, 16, 16, 128, 128, 3, 1, 4, b, t_steps,
               seed=b * 10 + t_steps)
    _conv_case(cuda, 9, 7, 40, 36, 3, 2, 8, b, t_steps,
               seed=b * 10 + t_steps + 1, soft=False)


# every launch-plan variant, each by the wrapper's own choice:
# (h, w, c_in, c_out, k, bits, b) -> (ks, staged)
_CONV_PLANS = {
    (32, 32, 64, 64, 3, 4, 8): (1, True),      # vgg9 convs.1
    (16, 16, 128, 128, 3, 4, 8): (2, True),    # vgg9 convs.3
    (8, 8, 128, 256, 3, 4, 8): (4, True),      # vgg9 convs.4
    (4, 4, 512, 512, 3, 4, 8): (8, True),      # resnet18 blocks.6.conv2
    (16, 16, 1024, 256, 3, 8, 5): (1, False),  # 640 units
    (16, 16, 1024, 256, 3, 8, 3): (2, False),  # 384 units
    (8, 8, 1024, 256, 3, 8, 5): (4, False),    # 160 units
    (4, 4, 1024, 64, 3, 8, 8): (8, False),     # 16 units
}


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(_CONV_PLANS),
                         ids=[f"ks{v[0]}-{'staged' if v[1] else 'l2'}"
                              for v in _CONV_PLANS.values()])
def test_fused_conv_every_launch_plan(cuda, geom):
    h, w, c_in, c_out, k, bits, b = geom
    ks, _, staged = _conv_case(cuda, h, w, c_in, c_out, k, 1, bits, b, 4,
                               seed=sum(geom))
    assert (ks, staged) == _CONV_PLANS[geom]


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


_VGG9 = (32, 64, [64, "P", 128, 128, "P", 256, "P"])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("b,t_steps,chain", [
    (8, 4, _VGG9),                        # the served configuration
    (1, 12, _VGG9),                       # T in two chunks (tc = 10-11)
    (3, 1, (32, 64, [64, 64])),           # resnet18 blocks.0, one step
    (3, 4, (4, 512, [512, 512])),         # resnet18 blocks.7
])
def test_fused_group_batches_steps_and_chunks(cuda, b, t_steps, chain,
                                              bits, soft):
    hw, c_in, spec = chain
    members = _group_members(spec, c_in, bits, hw + bits + b, cuda)
    planes = _spikes((t_steps, b, hw, hw, c_in), hw * 5 + b).to(cuda)
    kw = dict(leak_shift=3, v_reset_q=-3, soft_reset=soft)
    pv, ps = fused_group_rollout_torch(planes, members, **kw)
    before = group_ops.fused_group_rollout.launches
    kv, ks = group_ops.fused_group_rollout(planes, members, **kw)
    torch.cuda.synchronize()
    assert group_ops.fused_group_rollout.launches == before + 1
    assert kv.shape == pv.shape and ks.shape == ps.shape
    assert torch.equal(kv, pv) and torch.equal(ks, ps)
    assert pv.any() and ps.any()
    geoms = group_ops._chain_geoms(
        group_ops._normalize_members(members, hw, hw, planes.shape[-1]),
        hw, hw)
    _, tc, _, _, smem_bytes = group_ops._launch_plan(geoms, t_steps, b)
    assert smem_bytes <= group_ops._smem.SMEM_LIMIT
    if t_steps == 12:
        assert tc < t_steps               # the case is chunked


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


def _threaded_cases(cuda):
    """(name, call) pairs whose calls launch one kernel each at shared
    memory sizes that differ within one template instance: vgg9's four
    convs (all ``<4, staged>``), fc1 at two batch sizes (two contraction
    splits) and the vgg9 chain at two batch sizes."""
    cases = []
    for i, (hw, c_in, c_out) in enumerate([(32, 64, 64), (16, 64, 128),
                                           (16, 128, 128), (8, 128, 256)]):
        planes = _spikes((4, 8, hw, hw, c_in), 40 + i).to(cuda)
        wf = torch.from_numpy((np.random.default_rng(40 + i)
                               .standard_normal((3, 3, c_in, c_out))
                               * 0.2).astype(np.float32))
        qct = quantize_conv(wf, PrecisionConfig(bits=4)).to(cuda)
        kw = dict(leak_shift=3, v_reset_q=-3, soft_reset=True,
                  threshold_q=_theta(40 + i, c_out, 4).to(cuda))
        cases.append((conv_ops.fused_conv_rollout,
                      fused_conv_rollout_torch, (planes, qct), kw))
    wf = torch.from_numpy((np.random.default_rng(50).standard_normal(
        (512, 4096)) * 0.05).astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=4)).to(cuda)
    for m in (8, 1):
        kw = dict(d_in=4096, leak_shift=3, v_reset_q=-2, soft_reset=True,
                  threshold_q=_theta(50, 512, 4).mul(2).to(cuda))
        cases.append((nce_ops.fused_nce_rollout, fused_nce_rollout_torch,
                      (_spikes((4, m, 4096), 50 + m).to(cuda), qt), kw))
    hw, c_in, spec = _VGG9
    members = _group_members(spec, c_in, 4, 60, cuda)
    for b in (8, 2):
        cases.append((group_ops.fused_group_rollout,
                      fused_group_rollout_torch,
                      (_spikes((4, b, hw, hw, c_in), 60 + b).to(cuda),
                       members), dict(leak_shift=3, v_reset_q=-3,
                                      soft_reset=True)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [2, 4])
def test_spiking_kernels_launched_from_threads(cuda, threads):
    """Host threads launching at once (as the async tier's workers do:
    the wrappers release the interpreter lock in their launches), each
    walking the cases in its own order, at shared-memory sizes that
    differ within one kernel instance: every result bit-exact, every
    launch counted."""
    import threading

    cases = _threaded_cases(cuda)
    refs = [ref(*args, **kw) for _, ref, args, kw in cases]
    rounds = 6
    wrappers = {fn for fn, _, _, _ in cases}
    before = {fn: fn.launches for fn in wrappers}
    got = [[] for _ in range(threads)]
    errors = []

    def work(tid):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(rounds):     # every case once a round
                for i in rng.permutation(len(cases)):
                    fn, _, args, kw = cases[i]
                    got[tid].append((i, fn(*args, **kw)))
        except Exception as exc:     # reported below, on the test's thread
            errors.append(exc)

    ts = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts), "a launching thread hung"
    assert not errors, errors
    torch.cuda.synchronize()
    for tid in range(threads):
        assert len(got[tid]) == rounds * len(cases)
        for i, (kv, ks) in got[tid]:
            pv, ps = refs[i]
            assert torch.equal(kv, pv) and torch.equal(ks, ps), (tid, i)
    for fn in wrappers:
        n = sum(f is fn for f, _, _, _ in cases)
        assert fn.launches == before[fn] + threads * rounds * n


# --- the NCE step kernels: bit-exact ------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,d_in,d_out,bits", [
    (8, 4096, 512, 4),      # vgg9 fc1, one step
    (64, 2048, 2048, 8),    # kernel_bench NCE geometry
    (64, 2048, 2048, 2),
    (13, 75, 45, 2),        # ragged rows, d_in and d_out
    (3, 1000, 100, 8),
])
def test_spike_matmul_kernel_matches_plain(cuda, m, d_in, d_out, bits):
    spikes = _spikes((m, d_in), d_in + bits).to(cuda)
    spikes[..., -1] |= -1 << (d_in % 32) if d_in % 32 else 0  # stray bits
    wf = torch.from_numpy((np.random.default_rng(d_in).standard_normal(
        (d_out, d_in)) * 0.2).astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits)).to(cuda)
    ref = sm_ref.spike_matmul_ref(spikes, qt, d_in=d_in)
    before = sm_ops.spike_matmul.launches
    got = sm_ops.spike_matmul(spikes, qt, d_in=d_in)
    torch.cuda.synchronize()
    assert sm_ops.spike_matmul.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert ref.abs().sum() > 0


# (m, d_in, d_out, bits) -> the (rb, split) `_nce_plan(1, ...)` picks
_SM_PLANS = {
    (8, 4096, 256, 4): (8, 16),
    (8, 4096, 512, 4): (8, 8),        # vgg9 fc1
    (8, 4096, 1024, 2): (8, 4),
    (64, 2048, 2048, 8): (64, 2),     # kernel_bench's NCE step
    (8, 4096, 4096, 4): (8, 1),
    (1, 4096, 512, 4): (1, 8),
    (200, 1000, 100, 8): (64, 8),
    (200, 75, 45, 2): (64, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("geom", list(_SM_PLANS))
def test_spike_matmul_every_split(cuda, geom):
    """Every contraction split the plan takes, m = 1 and 200, ragged d_in
    and d_out, stray bits past d_in set: one launch, bit-exact."""
    m, d_in, d_out, bits = geom
    spikes = _spikes((m, d_in), sum(geom)).to(cuda)
    spikes[..., -1] |= -1 << (d_in % 32) if d_in % 32 else 0  # stray bits
    wf = torch.from_numpy((np.random.default_rng(d_out).standard_normal(
        (d_out, d_in)) * 0.2).astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits)).to(cuda)
    ref = sm_ref.spike_matmul_ref(spikes, qt, d_in=d_in)
    before = sm_ops.spike_matmul.launches
    got = sm_ops.spike_matmul(spikes, qt, d_in=d_in)
    torch.cuda.synchronize()
    assert sm_ops.spike_matmul.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert sm_ops._launch_plan(m, spikes.shape[-1], bits,
                               -(-d_out // 32) * 32) == _SM_PLANS[geom]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,soft", [
    ((8, 512), True), ((64, 2048), False), ((5, 37), True), ((3, 7, 11), False),
])
def test_lif_step_kernel_matches_plain(cuda, shape, soft):
    g = np.random.default_rng(len(shape) + shape[-1])
    v = torch.from_numpy(g.integers(-300, 300, shape).astype(np.int32))
    i = torch.from_numpy(g.integers(-200, 200, shape).astype(np.int32))
    kw = dict(leak_shift=3, threshold_q=64, v_reset_q=-5, soft_reset=soft)
    pv, ps = lif_ref.lif_step_ref(v, i, **kw)
    before = lif_ops.lif_step.launches
    kv, ks = lif_ops.lif_step(v.to(cuda), i.to(cuda), **kw)
    torch.cuda.synchronize()
    assert lif_ops.lif_step.launches == before + 1
    assert torch.equal(kv.cpu(), pv) and torch.equal(ks.cpu(), ps)
    assert 0 < int(ps.sum()) < ps.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("shape", [
    (8, 512), (64, 2048), (8, 100), (5, 37), (3, 7, 11), (1, 1), (2, 33),
    (4097, 64)])
def test_lif_step_packed_kernel_matches_plain(cuda, shape, soft):
    """The packed entry: v' and the words bit-exact with lif_step_ref then
    pack_bool, ragged rows (zero bits past the end), bit 31, wraparound
    and a grid past 4096 blocks (4097 x 64: the warp-stride loop)."""
    g = np.random.default_rng(shape[-1] * 3 + soft)
    v = torch.from_numpy(g.integers(-300, 300, shape).astype(np.int32))
    i = torch.from_numpy(g.integers(-200, 200, shape).astype(np.int32))
    v.view(-1)[:2] = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32)[
        :v.numel()]
    kw = dict(leak_shift=3, threshold_q=64, v_reset_q=-5, soft_reset=soft)
    pv, ps = lif_ref.lif_step_ref(v, i, **kw)
    before = lif_ops.lif_step.launches
    kv, kwords = lif_ops.lif_step_packed(v.to(cuda), i.to(cuda), **kw)
    torch.cuda.synchronize()
    assert lif_ops.lif_step.launches == before + 1
    assert torch.equal(kv.cpu(), pv)
    assert torch.equal(kwords.cpu(), packing.pack_bool(ps))


@pytest.mark.cuda
def test_lif_step_packed_on_a_strided_view_and_empty(cuda):
    g = np.random.default_rng(7)
    v = torch.from_numpy(g.integers(-300, 300, (6, 96)).astype(np.int32))
    i = torch.from_numpy(g.integers(-200, 200, (6, 96)).astype(np.int32))
    kw = dict(leak_shift=2, threshold_q=40)
    pv, ps = lif_ref.lif_step_ref(v[:, 1:], i[:, 1:], **kw)
    kv, kwords = lif_ops.lif_step_packed(v.to(cuda)[:, 1:],
                                         i.to(cuda)[:, 1:], **kw)
    assert torch.equal(kv.cpu(), pv)
    assert torch.equal(kwords.cpu(), packing.pack_bool(ps))
    before = lif_ops.lif_step.launches
    e = torch.zeros((0, 64), dtype=torch.int32, device=cuda)
    ev, ew = lif_ops.lif_step_packed(e, e, **kw)
    assert ev.shape == (0, 64) and ew.shape == (0, 2)
    assert lif_ops.lif_step.launches == before


# --- the LM kernels: float, within the stated tolerance --------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bits,gs,dtype", [
    (8, 2048, 8192, 4, -1, torch.bfloat16),   # olmo-1b wi at decode
    (37, 8192, 2048, 4, -1, torch.bfloat16),  # olmo-1b wo at a prefill
    (5, 256, 96, 8, -1, torch.float32),
    (3, 72, 45, 2, 24, torch.float32),        # grouped, k % 16 != 0
    (20, 512, 64, 4, 256, torch.float16),     # groups wider than a word run
])
def test_packed_qmatmul_kernel_matches_plain(cuda, m, k, n, bits, gs, dtype):
    """Tolerance: both sum the same float32 products (the dequantized
    weight rounded to float32 first) in another order; in float32 that
    moves a sum by ~sqrt(k) ulps, so 1e-4 of the output's scale; the
    bfloat16/float16 outputs round once more, so one ulp of that type
    (2^-7 / 2^-10 relative) on top."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = np.random.default_rng(m * k + n)
    x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32))
    x = x.to(cuda, dtype)
    wf = torch.from_numpy((g.standard_normal((n, k)) * 0.05)
                          .astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits, group_size=gs)).to(cuda)
    ref = qmm_ref.qmatmul_ref(x, qt).float()
    before = qmm_ops.qmatmul.launches
    got = qmm_ops.qmatmul(x, qt)
    torch.cuda.synchronize()
    assert qmm_ops.qmatmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    rel = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}[dtype]
    err = (got.float() - ref).abs()
    assert float((err - rel * ref.abs()).max()) <= 1e-4 * float(
        ref.abs().max())


@pytest.mark.cuda
def test_packed_qmatmul_refuses_zero_point_on_cuda(cuda):
    qt = quantize(torch.randn(32, 64), PrecisionConfig(bits=4,
                                                       symmetric=False))
    with pytest.raises(ValueError, match="zero-point"):
        qmm_ops.qmatmul(torch.randn(2, 64, device=cuda), qt.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,kh,g,hd,bits,lens,window,cap,dtype", [
    (8, 1024, 16, 1, 128, 4, 544, 0, None, torch.bfloat16),  # olmo-1b
    (2, 300, 2, 2, 64, 2, (300, 77), 0, None, torch.float32),
    (2, 257, 2, 4, 64, 8, (257, 130), 50, 30.0, torch.float32),
    (3, 64, 1, 8, 256, 4, (1, 64, 33), 16, 50.0, torch.bfloat16),
])
def test_kv_attention_kernel_matches_plain(cuda, b, s, kh, g, hd, bits,
                                           lens, window, cap, dtype):
    """Tolerance: the kernel's online softmax divides once at the end where
    the plain version normalises and rounds each probability to bfloat16
    before the weighted sum (~2^-9 relative per term); atol 1e-2 on
    outputs of magnitude ~1 covers that and a bfloat16 output rounding."""
    gen = torch.Generator().manual_seed(b * s + g)
    q = torch.randn((b, 1, kh * g, hd), generator=gen).to(cuda, dtype)
    k = torch.randn((b, s, kh, hd), generator=gen).to(cuda)
    v = torch.randn((b, s, kh, hd), generator=gen).to(cuda)
    kp, ks = kv_ref.quantize_kv(k, bits)
    vp, vs = kv_ref.quantize_kv(v, bits)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda) \
        if isinstance(lens, tuple) else lens
    kw = dict(bits=bits, scale=hd ** -0.5, cache_len=cl, window=window,
              logit_cap=cap)
    ref = kv_ref.quant_kv_decode_attention_ref(q, kp, ks, vp, vs, **kw)
    before = kv_ops.quant_kv_decode_attention.launches
    got = kv_ops.quant_kv_decode_attention(q, kp, ks, vp, vs, **kw)
    torch.cuda.synchronize()
    assert kv_ops.quant_kv_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                               rtol=2e-2)


def _check_qmatmul(got, ref, dtype):
    rel = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}[dtype]
    err = (got.float() - ref).abs()
    assert float((err - rel * ref.abs()).max()) <= 1e-4 * float(
        ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bits,gs,dtype,variant", [
    (64, 2048, 2048, 4, -1, torch.bfloat16, "mma"),     # variant boundary
    (63, 2048, 2048, 4, -1, torch.bfloat16, "gemv"),
    (65, 2048, 8192, 4, -1, torch.bfloat16, "mma"),     # olmo-1b wi
    (256, 8192, 2048, 4, -1, torch.bfloat16, "mma"),    # olmo-1b wo
    (256, 2048, 2048, 8, -1, torch.float16, "mma"),
    (256, 2048, 8192, 2, 128, torch.bfloat16, "mma"),
    (4096, 2048, 2048, 4, -1, torch.bfloat16, "mma"),   # INT4-KV prefill
    (4096, 2048, 8192, 4, 128, torch.float16, "mma"),
    (4096, 8192, 2048, 8, -1, torch.bfloat16, "mma"),
    (4096, 2048, 2048, 8, -1, torch.float16, "mma"),
    (100, 200, 45, 4, -1, torch.bfloat16, "mma"),       # ragged M, N, K
    (100, 200, 45, 8, -1, torch.float16, "mma"),
    (100, 256, 45, 2, 128, torch.bfloat16, "mma"),
    (77, 264, 40, 8, -1, torch.float16, "mma"),         # 4-byte word copies
    (64, 512, 96, 4, 128, torch.float32, "gemv"),
    (40, 8192, 2048, 4, -1, torch.bfloat16, "gemv"),    # 16-byte word loads
    (8, 2048, 2048, 8, 32, torch.bfloat16, "gemv"),     # groups < K tile
    # the LM families' served linears (W4, one scale a row, bf16)
    (8, 2048, 8512, 4, -1, torch.bfloat16, "gemv"),     # mamba2 in_proj
    (181, 2048, 8512, 4, -1, torch.bfloat16, "mma"),    # ... at a prefill
    (8, 4096, 2048, 4, -1, torch.bfloat16, "gemv"),     # mamba2 out_proj
    (8, 1536, 1536, 4, -1, torch.bfloat16, "gemv"),     # granite wq / wo
    (8, 1536, 512, 4, -1, torch.bfloat16, "gemv"),      # granite wk / wv
    (150, 1536, 512, 4, -1, torch.bfloat16, "mma"),     # ... at a prefill
    (4096, 1600, 6482, 4, -1, torch.bfloat16, "mma"),   # hymba in_proj
])
def test_packed_qmatmul_variants_match_plain(cuda, m, k, n, bits, gs, dtype,
                                             variant):
    """Both variants, at the variant boundary and the olmo-1b prefill
    widths; the tolerance of test_packed_qmatmul_kernel_matches_plain
    (the tensor-core variant sums the same exact products x * code in
    another order and applies the scale in float32 afterwards)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert qmm_ops._variant(m, dtype, gs) == variant
    g = np.random.default_rng(m * k + n + bits)
    x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32))
    x = x.to(cuda, dtype)
    wf = torch.from_numpy((g.standard_normal((n, k)) * 0.05)
                          .astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits, group_size=gs)).to(cuda)
    ref = qmm_ref.qmatmul_ref(x, qt).float()
    before = qmm_ops.qmatmul.launches
    got = qmm_ops.qmatmul(x, qt)
    torch.cuda.synchronize()
    assert qmm_ops.qmatmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _check_qmatmul(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,kh,g,hd,bits,lens,window,cap,dtype", [
    (4, 1024, 2, 1, 128, 4, (1, 7, 544, 1024), 0, None, torch.bfloat16),
    (2, 1024, 2, 2, 128, 4, (544, 100), 5, None, torch.bfloat16),  # empty
    (2, 1024, 2, 4, 64, 8, (1024, 1024), 0, 30.0, torch.float16),  # S full
    (2, 300, 1, 8, 256, 2, (300, 2), 0, None, torch.float32),
    (2, 600, 4, 4, 256, 4, (600, 333), 128, None, torch.bfloat16),
    (1, 4096, 1, 2, 128, 4, (4096,), 0, None, torch.bfloat16),  # 4 tiles
    (2, 100, 2, 1, 72, 4, (90, 3), 0, 20.0, torch.float32),     # 9 words
    # G not a power of two: the G=4 and G=8 variants with idle head slots
    (2, 1024, 2, 3, 128, 4, (1024, 700), 0, None, torch.bfloat16),
    (2, 300, 8, 6, 128, 4, (300, 150), 0, None, torch.bfloat16),
    (1, 500, 1, 5, 64, 8, (500,), 0, None, torch.float16),
    (2, 200, 1, 7, 256, 2, (200, 31), 64, 30.0, torch.float32),
    # hymba-1.5b (5 KV heads of 5, a 1024 window crossed) and
    # paligemma-3b (1 KV head of 8 at head_dim 256), INT4 as served
    (4, 1040, 5, 5, 64, 4, (1040, 1030, 1025, 1024), 1024, None,
     torch.bfloat16),
    (4, 1040, 5, 5, 64, 4, (1040, 1040, 700, 1), 0, None, torch.bfloat16),
    (4, 336, 1, 8, 256, 4, (336, 336, 300, 257), 0, None, torch.bfloat16),
])
def test_kv_attention_split_kernel_matches_plain(cuda, b, s, kh, g, hd,
                                                 bits, lens, window, cap,
                                                 dtype):
    """The key-split kernel over ragged lens, empty splits (a window of 5
    keys over 8 blocks, lens 1 and 2), G 1-8, hd 64/72/128/256 and
    several tiles per block; the tolerance of
    test_kv_attention_kernel_matches_plain."""
    gen = torch.Generator().manual_seed(b * s + g * hd)
    q = torch.randn((b, 1, kh * g, hd), generator=gen).to(cuda, dtype)
    k = torch.randn((b, s, kh, hd), generator=gen).to(cuda)
    v = torch.randn((b, s, kh, hd), generator=gen).to(cuda)
    kp, ks = kv_ref.quantize_kv(k, bits)
    vp, vs = kv_ref.quantize_kv(v, bits)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(bits=bits, scale=hd ** -0.5, cache_len=cl, window=window,
              logit_cap=cap)
    ref = kv_ref.quant_kv_decode_attention_ref(q, kp, ks, vp, vs, **kw)
    before = kv_ops.quant_kv_decode_attention.launches
    got = kv_ops.quant_kv_decode_attention(q, kp, ks, vp, vs, **kw)
    torch.cuda.synchronize()
    assert kv_ops.quant_kv_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_kv_attention_empty_cache_returns_zeros(cuda):
    """cache_len 0: every split is empty, and the kernel writes zeros (the
    documented difference from the plain version, which averages the
    masked positions)."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((2, 1, 4, 128), generator=gen).to(cuda, torch.bfloat16)
    kp, ks = kv_ref.quantize_kv(torch.randn((2, 64, 2, 128),
                                            generator=gen).to(cuda), 4)
    before = kv_ops.quant_kv_decode_attention.launches
    got = kv_ops.quant_kv_decode_attention(q, kp, ks, kp, ks, bits=4,
                                           scale=0.1, cache_len=0)
    torch.cuda.synchronize()
    assert kv_ops.quant_kv_decode_attention.launches == before + 1
    assert torch.equal(got.float(), torch.zeros_like(got.float()))


# (m, k, n, group_size) that make _mma_tile pick each tile the kernel has
_MMA_INSTANCES = {
    ((128, 256), False): (1152, 256, 4096, -1),   # 9 x 16 tiles
    ((128, 64), False): (256, 512, 8192, -1),     # olmo-1b wi at M=256
    ((64, 64), False): (100, 200, 300, -1),       # ragged, 4-byte words
    ((128, 64), True): (256, 512, 8192, 128),
    ((64, 64), True): (96, 384, 200, 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("tile,grouped", list(_MMA_INSTANCES),
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else f"grouped={v}")
def test_packed_qmatmul_every_mma_instance(cuda, tile, grouped, dtype, bits):
    """Each tile x scale layout x dtype x bit width the mma variant is
    built for, reached through the wrapper's own choice; the tolerance of
    test_packed_qmatmul_kernel_matches_plain."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n, gs = _MMA_INSTANCES[tile, grouped]
    assert qmm_ops._variant(m, dtype, gs) == "mma"
    assert qmm_ops._mma_tile(m, n, grouped) == tile
    g = np.random.default_rng(m + k + n + bits)
    x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32))
    x = x.to(cuda, dtype)
    wf = torch.from_numpy((g.standard_normal((n, k)) * 0.05)
                          .astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits, group_size=gs)).to(cuda)
    assert (qt.n_groups > 1) == grouped
    ref = qmm_ref.qmatmul_ref(x, qt).float()
    before = qmm_ops.qmatmul.launches
    got = qmm_ops.qmatmul(x, qt)
    torch.cuda.synchronize()
    assert qmm_ops.qmatmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _check_qmatmul(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_float_conv_is_full_fp32_forward_and_backward(cuda, stride):
    """The float/BPTT conv (``snn_layers._conv2d``) keeps TF32 off in its
    backward too, whatever the global flags: with PyTorch's default
    ``cudnn.allow_tf32=True`` its output and both gradients sit within
    1e-4 of the largest float64 value, and two runs give the same bits
    (deterministic cuDNN).  The bound: cuDNN's deterministic float32
    weight gradient (FFT-based here) measured 1.6e-5 on the H100; TF32's
    10-bit mantissa puts a plain ``F.conv2d`` under the same global flags
    above it, which the control asserts, so the test can see TF32."""
    import torch.nn.functional as F

    from repro_torch.core import snn_layers

    gen = torch.Generator().manual_seed(stride)
    x = torch.rand((32, 32, 32, 64), generator=gen)
    w = torch.randn((3, 3, 64, 64), generator=gen) * 0.06
    gy = torch.randn((32, 32 // stride, 32 // stride, 64), generator=gen)

    def plain(xn, wn, stride):     # PyTorch's defaults, SAME pads
        y = F.conv2d(xn.permute(0, 3, 1, 2), wn.permute(3, 2, 0, 1),
                     stride=stride, padding=1 if stride == 1 else 0)
        return y.permute(0, 2, 3, 1)

    def run(conv, dev, dtype):
        xd = x.to(dev, dtype)
        if conv is plain and stride == 2:   # SAME at stride 2: pad (0, 1)
            xd = F.pad(xd, (0, 0, 0, 1, 0, 1))
        xd.requires_grad_(True)
        wd = w.to(dev, dtype).requires_grad_(True)
        y = conv(xd, wd, stride)
        gx, gw = torch.autograd.grad(y, (xd, wd), gy.to(dev, dtype))
        if conv is plain and stride == 2:
            gx = gx[:, :32, :32]
        return [t.detach().to("cpu", torch.float64) for t in (y, gx, gw)]

    def errs(got, want):
        return [float((g - r).abs().max() / r.abs().max())
                for g, r in zip(got, want)]

    exact = lambda a, b, s: snn_layers._conv2d(a, b, stride=s)  # noqa
    want = run(exact, "cpu", torch.float64)
    assert max(errs(run(plain, "cpu", torch.float64), want)) <= 1e-12
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got, again = (run(exact, cuda, torch.float32),
                      run(exact, cuda, torch.float32))
        control = errs(run(plain, cuda, torch.float32), want)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for name, err, g, a in zip(("out", "grad x", "grad w"), errs(got, want),
                               got, again):
        assert err <= 1e-4, (name, err)
        assert torch.equal(g, a), name
    assert max(control) > 1e-4, f"TF32 control within the bound: {control}"
