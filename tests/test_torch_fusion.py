"""Fusion groups in the port, held against ``repro`` (``jnp`` backend).

* Planner: ``plan_fusion_groups`` gives ``repro``'s member tuples for
  vgg9 and resnet18 at smoke and full geometry, the grouped topology
  matches, every illegal group raises ``ValueError`` naming the same rule,
  and a small ``budget=`` rejects a group.
* Plain kernel: ``fused_group_rollout_torch`` (and the wrapper on CPU
  tensors) against ``repro``'s ``fused_group_ops.fused_group_rollout`` over
  bits x reset x chain shape x T, with channels that are not multiples of
  32.  Tolerance: none, membranes and packed words bit-exact.
* Model: vgg9 and resnet18 ``fusion="auto"`` packages from ``repro``,
  loaded by the port: logits within rtol=atol=1e-5 of ``repro``'s
  (the float stem and readout may sum in another order), identical trace
  rows, and the port's grouped forward equal to its own ungrouped forward
  exactly.  Grouped packages written by either package load in the other.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import deploy as jdeploy
from repro.deploy import deploy_config as jdeploy_config
from repro.deploy import load as jload
from repro.graph import build_graph as jbuild_graph
from repro.graph import executors as jex
from repro.graph import plan_fusion_groups as jplan
from repro.graph import validate_group as jvalidate
from repro.graph.spec import FusionGroup as JFusionGroup
from repro.kernels import fused_group_ops as jgroup_ops
from repro.kernels import use_backend
from repro.quant.formats import PrecisionConfig as JPC
from repro.quant.ptq import quantize_conv as jquantize_conv
from repro_torch.core import packing
from repro_torch.deploy import deploy, deploy_config, load
from repro_torch.graph import (
    FusionGroup,
    apply_fusion,
    body_group,
    build_graph,
    executors,
    group_smem_bytes,
    plan_fusion_groups,
    validate_group,
)
from repro_torch.graph.spec import Residual
from repro_torch.kernels import smem
from repro_torch.kernels.fused_group import ops, ref
from repro_torch.quant.formats import PrecisionConfig, QuantizedConvTensor
from repro_torch.quant.ptq import quantize_conv


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["vgg9", "resnet18"])
@pytest.mark.parametrize("smoke", [True, False])
def test_plan_matches_repro(model, smoke):
    jg = jbuild_graph(jdeploy_config(model, 4, smoke=smoke))
    tg = build_graph(deploy_config(model, 4, smoke=smoke))
    assert tg.topology() == jg.topology()
    want = [g.members for g in jplan(jg)]
    got = [g.members for g in plan_fusion_groups(tg)]
    assert got == want and got
    jga = jbuild_graph(jdeploy_config(model, 4, smoke=smoke, fusion="auto"))
    tga = build_graph(deploy_config(model, 4, smoke=smoke, fusion="auto"))
    assert tga.topology() == jga.topology()
    assert tga.count_macs() == jga.count_macs()
    assert [g.members for g in tga.groups] == want
    for g in tga.groups:
        assert 0 < group_smem_bytes(tga, g) <= smem.SMEM_LIMIT
    if model == "resnet18":
        bodies = [body_group(tga, n) for n in tga.nodes
                  if isinstance(n, Residual)]
        assert [b.members for b in bodies if b is not None] == want


def test_summary_reports_membership_and_smem():
    g = build_graph(deploy_config("vgg9", 4, smoke=False, fusion="auto"))
    s = g.summary()
    assert "[fuse.0]" in s and "fusion fuse.0:" in s
    assert "shared memory" in s and "VMEM" not in s
    # full-width chain: two buffers of the 34x34x2-word input plane
    assert group_smem_bytes(g, g.groups[0]) == 2 * 4 * 34 * 34 * 2


@pytest.mark.parametrize("model,members,match", [
    ("vgg9", ("convs.1",), "fuses 2\\+ layers"),
    ("vgg9", ("convs.1", "convs.1"), "repeats a member"),
    ("vgg9", ("convs.1", "nope"), "not a layer of this graph"),
    ("vgg9", ("convs.0", "convs.1"), "stem"),
    ("vgg9", ("pool.0", "convs.2"), "starts at pool"),
    ("vgg9", ("convs.2", "convs.4"), "not contiguous"),
    ("vgg9", ("convs.1", "fc1"), "only conv/pool chains fuse"),
    ("resnet18", ("blocks.0.conv2", "blocks.1.conv1"),
     "crosses a residual boundary"),
    ("resnet18", ("blocks.0.conv1", "blocks.0.conv2", "blocks.1.conv1"),
     "crosses a residual boundary"),
    ("resnet18", ("blocks.2.conv1", "blocks.2.proj"), "PARALLEL"),
    ("resnet18", ("blocks.2.conv1", "blocks.2.conv2"), "stride 2"),
    ("resnet18", ("blocks.0.conv2", "blocks.0.conv1"), "full body in order"),
])
def test_illegal_groups_name_repros_rule(model, members, match):
    with pytest.raises(ValueError, match=match):
        jvalidate(jbuild_graph(jdeploy_config(model, 4)),
                  JFusionGroup("bad", members))
    with pytest.raises(ValueError, match=match):
        validate_group(build_graph(deploy_config(model, 4)),
                       FusionGroup("bad", members))


def test_precision_mixed_group_rejected():
    g = build_graph(deploy_config("vgg9", 4))
    with pytest.raises(ValueError, match="precision-mixed"):
        validate_group(g, FusionGroup("bad", ("convs.2", "convs.3"), bits=2))
    validate_group(g, FusionGroup("ok", ("convs.2", "convs.3"), bits=4))


def test_small_budget_rejects_group():
    g = build_graph(deploy_config("vgg9", 4, smoke=False))
    grp = FusionGroup("big", ("convs.2", "convs.3"))
    need = group_smem_bytes(g, grp)
    assert validate_group(g, grp) is grp
    with pytest.raises(ValueError, match="shared memory > budget"):
        validate_group(g, grp, budget=need - 1)
    assert plan_fusion_groups(g, budget=1024) == ()


def test_apply_fusion_rejects_overlap_and_unknown_request():
    g = build_graph(deploy_config("vgg9", 4))
    with pytest.raises(ValueError, match="disjoint"):
        apply_fusion(g, (("convs.2", "convs.3"), ("convs.3", "pool.1")))
    with pytest.raises(ValueError, match="unknown fusion request"):
        apply_fusion(g, "magic")
    assert apply_fusion(g, ()) is g


# ---------------------------------------------------------------------------
# plain kernel against repro's fused_group_ops
# ---------------------------------------------------------------------------

def _port_qct(jqct):
    return QuantizedConvTensor(
        data=torch.from_numpy(np.array(jqct.data)),
        scale=torch.from_numpy(np.array(jqct.scale)),
        shape=tuple(jqct.shape), bits=jqct.bits, c_in_pad=jqct.c_in_pad)


def _chain(spec, c_in, bits, seed):
    """(repro members, port members) for a chain spec like [48, "P", 24]."""
    g = np.random.default_rng(seed)
    qmax = (1 << (bits - 1)) - 1
    jm, tm, c = [], [], c_in
    for item in spec:
        if item == "P":
            jm.append(("pool", 2))
            tm.append(("pool", 2))
            continue
        wf = (g.standard_normal((3, 3, c, item)) * 0.2).astype(np.float32)
        theta = g.integers(1, 3 * qmax + 2, size=(item,)).astype(np.int32)
        jq = jquantize_conv(jnp.asarray(wf), JPC(bits=bits))
        jm.append(("conv", jq, jnp.asarray(theta)))
        tm.append(("conv", _port_qct(jq), torch.from_numpy(theta)))
        c = item
    return tuple(jm), tuple(tm)


CHAINS = {
    "conv_pool_conv": (8, 40, [48, "P", 24]),
    "conv_conv": (6, 32, [32, 70]),
    "ends_in_pool": (8, 20, [36, "P", 36, "P"]),
}


def _plain_case(chain, bits, soft, t_steps):
    hw, c_in, spec = CHAINS[chain]
    jm, tm = _chain(spec, c_in, bits, seed=bits * 10 + len(spec))
    s = (np.random.default_rng(t_steps + bits).random(
        (t_steps, 2, hw, hw, c_in)) < 0.3).astype(np.int32)
    planes = packing.pack_np(s, 1)
    kw = dict(leak_shift=2, v_reset_q=-1, soft_reset=soft)
    with use_backend("jnp"):
        jv, js = jgroup_ops.fused_group_rollout(jnp.asarray(planes), jm,
                                                **kw)
    tv, ts = ref.fused_group_rollout_torch(torch.from_numpy(planes), tm,
                                           **kw)
    wv, ws = ops.fused_group_rollout(torch.from_numpy(planes), tm, **kw)
    for v, sp in ((tv, ts), (wv, ws)):
        assert v.shape == jv.shape and sp.shape == js.shape
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(js))
    if t_steps:
        assert np.asarray(js).any(), "vacuous: the chain never fired"


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("soft", [True, False])
def test_plain_matches_repro(chain, bits, soft):
    _plain_case(chain, bits, soft, t_steps=3)


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("t_steps", [0, 1])
def test_plain_matches_repro_short_rollouts(chain, t_steps):
    _plain_case(chain, 4, True, t_steps)


def _port_member(c_in, c_out, bits, seed, theta=5):
    wf = torch.from_numpy((np.random.default_rng(seed).standard_normal(
        (3, 3, c_in, c_out)) * 0.2).astype(np.float32))
    return ("conv", quantize_conv(wf, PrecisionConfig(bits=bits)), theta)


def test_chain_contract_errors():
    m32_16 = _port_member(32, 16, 4, seed=0)
    m32_8 = _port_member(32, 8, 4, seed=1)
    m16_16_w2 = _port_member(16, 16, 2, seed=2)
    sp = torch.zeros((2, 1, 8, 8, 1), dtype=torch.int32)
    roll = ops.fused_group_rollout
    with pytest.raises(ValueError, match="2\\+ members"):
        roll(sp, (m32_16,), leak_shift=3)
    with pytest.raises(ValueError, match="start at a conv"):
        roll(sp, (("pool", 2), m32_16), leak_shift=3)
    with pytest.raises(ValueError, match="thread channels"):
        roll(sp, (m32_16, m32_8), leak_shift=3)
    with pytest.raises(ValueError, match="ONE datapath width"):
        roll(sp, (m32_16, m16_16_w2), leak_shift=3)
    with pytest.raises(ValueError, match="does not divide"):
        roll(sp, (m32_16, ("pool", 3)), leak_shift=3)
    with pytest.raises(ValueError, match="unknown group member kind"):
        roll(sp, (m32_16, ("dense", 4)), leak_shift=3)


def test_over_budget_chain_raises_not_falls_back(monkeypatch):
    """A chain whose planes do not fit one block's shared memory raises on
    every device; it never runs the per-layer plain chain instead."""
    tm = (_port_member(512, 512, 4, seed=3), _port_member(512, 512, 4,
                                                          seed=4))
    sp = torch.zeros((1, 1, 128, 128, 16), dtype=torch.int32)
    calls = []
    monkeypatch.setattr(ref, "fused_group_rollout_torch",
                        lambda *a, **k: calls.append(1))
    need = smem.group_rollout_smem_bytes(
        ops.geom_smem_dicts(ops._chain_geoms(tm, 128, 128)))
    assert need == 2 * 4 * 130 * 130 * 16 > smem.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory > budget"):
        ops.fused_group_rollout(sp, tm, leak_shift=3)
    assert calls == []


# ---------------------------------------------------------------------------
# model: repro deploys, the port loads and serves
# ---------------------------------------------------------------------------

def _images(cfg, n=2, seed=7):
    return np.random.default_rng(seed).random(
        (n, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


class _JaxRecorder(jex.PackagedExecutor):
    """Records every conv/dense and fused-group output."""

    def __init__(self, *a):
        super().__init__(*a)
        self.outs = {}

    def conv(self, spec, x):
        y = super().conv(spec, x)
        self.outs[spec.name] = np.asarray(y)
        return y

    def dense(self, spec, x):
        y = super().dense(spec, x)
        self.outs[spec.name] = np.asarray(y)
        return y

    def fused_group(self, group, specs, x):
        y = super().fused_group(group, specs, x)
        self.outs[group.name] = np.asarray(y)
        return y


class _TorchRecorder(executors.PackagedExecutor):
    def __init__(self, *a):
        super().__init__(*a)
        self.outs = {}

    def conv(self, spec, x):
        y = super().conv(spec, x)
        self.outs[spec.name] = y.numpy()
        return y

    def dense(self, spec, x):
        y = super().dense(spec, x)
        self.outs[spec.name] = y.numpy()
        return y

    def fused_group(self, group, specs, x):
        y = super().fused_group(group, specs, x)
        self.outs[group.name] = y.numpy()
        return y


def _run(rec_cls, graph, model, images, jax_side):
    rec = rec_cls(graph, model.float_params, model)
    if jax_side:
        with use_backend("jnp"):
            logits = np.asarray(jex.run_graph(graph, rec,
                                              jnp.asarray(images)))
    else:
        with torch.inference_mode():
            logits = executors.run_graph(graph, rec,
                                         torch.from_numpy(images)).numpy()
    return rec, logits


@pytest.fixture(scope="module", params=[
    (m, b) for m in ("vgg9", "resnet18") for b in (2, 4, 8)],
    ids=lambda p: f"{p[0]}-w{p[1]}")
def repro_packages(request, tmp_path_factory):
    """``repro.deploy`` of one set of weights, saved twice: with
    ``fusion="auto"`` and with ``fusion=()`` (the same packed layers)."""
    from repro_torch.models import snn_cnn

    model, bits = request.param
    cfg = jdeploy_config(model, bits, fusion="auto")
    params = _numpy_tree(snn_cnn.init(bits + 20, deploy_config(model, bits),
                                      device="cpu"))
    grouped = jdeploy(jax.tree.map(jnp.asarray, params), cfg)
    flat = dataclasses.replace(grouped,
                               cfg=dataclasses.replace(cfg, fusion=()))
    d = tmp_path_factory.mktemp("pkg")
    return (grouped, grouped.save(str(d / "auto.npz")),
            flat, flat.save(str(d / "flat.npz")))


def test_ungrouped_npz_forward_bit_exact(repro_packages):
    """fusion=(): every packed layer bit-exact (resnet18's residual bodies
    and projections included), logits within rtol=atol=1e-5."""
    _, _, jflat, path = repro_packages
    tmodel = load(path, device="cpu")
    assert tmodel.cfg.fusion == ()
    images = _images(tmodel.cfg)
    jrec, jlogits = _run(_JaxRecorder, jbuild_graph(jflat.cfg), jflat,
                         images, True)
    trec, tlogits = _run(_TorchRecorder, build_graph(tmodel.cfg), tmodel,
                         images, False)
    assert trec.trace == jrec.trace
    assert set(trec.outs) == set(jrec.outs) == \
        {s.name for s in build_graph(tmodel.cfg).param_specs()} - {"head"}
    for name in jrec.outs:
        np.testing.assert_array_equal(trec.outs[name], jrec.outs[name],
                                      err_msg=f"layer {name}")
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)
    assert sum(o.any() for o in jrec.outs.values()) >= 3, "vacuous"


def test_grouped_forward_matches_repro_and_ungrouped(repro_packages,
                                                     monkeypatch):
    """fusion="auto": the fused groups' outputs bit-exact, identical trace
    rows, logits within rtol=atol=1e-5 of repro's and exactly equal to the
    port's own layer-by-layer forward of the same package."""
    jgrouped, path, _, flat_path = repro_packages
    tmodel = load(path, device="cpu")
    assert tmodel.cfg.fusion == "auto"
    graph = build_graph(tmodel.cfg)
    images = _images(tmodel.cfg)
    jrec, jlogits = _run(_JaxRecorder, jbuild_graph(jgrouped.cfg), jgrouped,
                         images, True)
    calls = []
    plain = ref.fused_group_rollout_torch
    monkeypatch.setattr(ref, "fused_group_rollout_torch",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    trec, tlogits = _run(_TorchRecorder, graph, tmodel, images, False)
    assert len(calls) == len(graph.groups) > 0
    assert trec.trace == jrec.trace
    for g in graph.groups:
        np.testing.assert_array_equal(trec.outs[g.name], jrec.outs[g.name],
                                      err_msg=f"group {g.name}")
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)

    flat = load(flat_path, device="cpu")
    frec, flogits = _run(_TorchRecorder, build_graph(flat.cfg), flat,
                         images, False)
    assert frec.trace == trec.trace
    np.testing.assert_array_equal(flogits, tlogits)
    # the chains did real work: some member layer fired
    assert any(frec.outs[m].any() for g in graph.groups for m in g.members
               if m in frec.outs), "vacuous: no group member fired"


@pytest.mark.parametrize("model", ["vgg9", "resnet18"])
def test_port_grouped_save_loads_in_repro(model, tmp_path):
    from repro_torch.models import snn_cnn

    cfg = deploy_config(model, 4, fusion="auto")
    tmodel = deploy(snn_cnn.init(5, cfg, device="cpu"), cfg, device="cpu")
    path = tmodel.save(str(tmp_path / f"{model}.npz"))
    with np.load(path) as z:
        manifest = json.loads(str(z["__manifest__"][()]))
    graph = build_graph(cfg)
    assert [g["members"] for g in manifest["groups"]] \
        == [list(g.members) for g in graph.groups]
    for g in manifest["groups"]:
        assert g["bits"] == 4 and g["packed_bytes"] > 0
        assert 0 < g["smem_bytes"] <= smem.SMEM_LIMIT
        assert "vmem_bytes" not in g
    jmodel = jload(path)
    assert jmodel.cfg.fusion == "auto"
    assert [g.members for g in jbuild_graph(jmodel.cfg).groups] \
        == [g.members for g in graph.groups]
    images = _images(cfg, n=2, seed=3)
    with use_backend("jnp"):
        jlogits = np.asarray(jmodel.apply(jnp.asarray(images)))
    with torch.inference_mode():
        tlogits = tmodel.apply(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)
    # and back: the port reads its own grouped package
    back = load(path, device="cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(
            back.apply(torch.from_numpy(images)).numpy(), tlogits)


def test_rates_lower_top_level_groups_per_member(monkeypatch):
    """With ``rates`` the top-level chain lowers member by member (each
    conv's rate needs its plane), bit-exact with the fused chain and with
    the ungrouped forward's rates."""
    from repro_torch.models import snn_cnn

    cfg = deploy_config("vgg9", 4, fusion="auto")
    tmodel = deploy(snn_cnn.init(2, cfg, device="cpu"), cfg, device="cpu")
    flat = dataclasses.replace(tmodel, cfg=dataclasses.replace(cfg,
                                                               fusion=()))
    images = torch.from_numpy(_images(cfg, n=2, seed=9))
    calls = []
    plain = ref.fused_group_rollout_torch
    monkeypatch.setattr(ref, "fused_group_rollout_torch",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    with torch.inference_mode():
        fused = tmodel.apply(images)
        assert len(calls) == 1
        logits, rates = tmodel.apply_with_rates(images)
        flat_logits, flat_rates = flat.apply_with_rates(images)
    assert len(calls) == 1
    assert torch.equal(logits, fused) and torch.equal(flat_logits, fused)
    # convs.0-4 and fc1, as repro's run_graph records them
    assert rates == flat_rates and len(rates) == 6
    assert all(r > 0 for r in rates[:5])
