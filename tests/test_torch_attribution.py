"""The port's time attribution (``repro_torch.obs.attribution``) against
``repro.obs.attribution`` (``jnp`` backend).

* ``predict_node_us``: the ``flops`` and ``bytes`` of every node of the
  vgg9, vgg16 and resnet18 graphs (smoke and full geometry, bits 2/4/8)
  equal ``repro``'s; a fusion group's terms are the sum of its members',
  as ``repro``'s ``_predict`` sums them.  ``predicted_us`` is
  max(flops / peak, bytes / HBM_BW) with the H100 constants, the peak
  ``PEAK_INT8_OPS`` for the packed layers and ``PEAK_FP32_FLOPS`` for the
  float stem and the float/BPTT lowering (``repro`` holds every node to
  one peak: a documented divergence).  Tolerance: none on flops/bytes.
* ``timed_forward``: its (layer, kind) rows come in ``repro``'s order
  (vgg9 ``fusion`` off and auto, resnet18 auto), one per executed node,
  each with ``wall_us > 0``; the ``snn_layer_time_us`` gauges and
  ``predicted_vs_measured`` spans carry ``repro``'s labels and keys; the
  logits and trace equal the unwrapped forward's.
* ``attribution_summary`` equals ``repro``'s on the same records; a
  prediction that rounds to 0 gives ``ratio`` None, as in ``repro``.
* The blocking sync follows the node's output (a CUDA-tensor stand-in).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.deploy import deploy_config as jdeploy_config
from repro.deploy import load as jload
from repro.graph import build_graph as jbuild_graph
from repro.kernels import use_backend
from repro_torch import obs
from repro_torch.deploy import deploy, deploy_config, load
from repro_torch.graph import build_graph, executor_for, run_graph
from repro_torch.graph.spec import Conv, Dense, Encode, Readout, Residual
from repro_torch.models import snn_cnn
from repro_torch.perfmodel.roofline import (
    HBM_BW,
    PEAK_FP32_FLOPS,
    PEAK_INT8_OPS,
    pick_bottleneck,
)


def _images(cfg, n=2, seed=5):
    return np.random.default_rng(seed).random(
        (n, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("name", ["vgg9", "vgg16", "resnet18"])
def test_predict_node_us_terms_match_repro(name, bits, smoke):
    from repro.obs.attribution import predict_node_us as jpredict

    cfg = deploy_config(name, bits, smoke=smoke, fusion="auto")
    jcfg = jdeploy_config(name, bits, smoke=smoke, fusion="auto")
    graph, jgraph = build_graph(cfg), jbuild_graph(jcfg)
    assert [n.name for n in graph.nodes] == [n.name for n in jgraph.nodes]
    batch, T = 8, cfg.timesteps
    seen = 0
    for node, jnode in zip(graph.nodes, jgraph.nodes):
        for int_path in (True, False):
            p = obs.predict_node_us(node, T, batch, bits, int_path)
            q = jpredict(jnode, T, batch, bits)
            if q is None:
                assert p is None
                continue
            assert (p["flops"], p["bytes"]) == (q["flops"], q["bytes"])
            stem = isinstance(node, Conv) and node.stem
            peak = PEAK_INT8_OPS if int_path and not stem \
                else PEAK_FP32_FLOPS
            t_c, t_m = p["flops"] / peak, p["bytes"] / HBM_BW
            assert p["predicted_us"] == round(max(t_c, t_m) * 1e6, 4)
            assert p["compute_us"] == round(t_c * 1e6, 4)
            assert p["memory_us"] == round(t_m * 1e6, 4)
            assert p["bottleneck"] == pick_bottleneck(t_c, t_m, 0.0)
            seen += 1
        if isinstance(node, (Conv, Dense, Residual)):
            assert p is not None and p["predicted_us"] > 0
        if isinstance(node, (Encode, Readout)):
            assert p is None
    assert seen >= 2 * 6

    # a fusion group (the port's plan; the shared-memory budget may group
    # otherwise than repro's): the members' terms summed, as repro's
    # _predict sums the same members
    flat = {n.name: n for n in graph.iter_flat()}
    jflat = {n.name: n for n in jgraph.iter_flat()}
    assert graph.groups
    for g in graph.groups:
        specs = [flat[m] for m in g.members]
        jspecs = [jflat[m] for m in g.members]
        mine = obs.AttributionExecutor(types.SimpleNamespace(cfg=cfg))
        theirs = jobs.AttributionExecutor(types.SimpleNamespace(cfg=jcfg))
        mine._batch = theirs._batch = batch
        p, q = mine._predict(specs), theirs._predict(jspecs)
        assert (p["flops"], p["bytes"]) == (q["flops"], q["bytes"])
        t_c, t_m = p["flops"] / PEAK_INT8_OPS, p["bytes"] / HBM_BW
        assert p["predicted_us"] == round(max(t_c, t_m) * 1e6, 4)


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """vgg9 and resnet18 at 4 bits, deployed by the port, loaded by both."""
    out = {}
    for name in ("vgg9", "resnet18"):
        cfg = deploy_config(name, 4, fusion="auto")
        path = deploy(snn_cnn.init(6, cfg, device="cpu"), cfg,
                      device="cpu").save(
            str(tmp_path_factory.mktemp("pkg") / f"{name}.npz"))
        out[name] = load(path, device="cpu"), jload(path)
    return out


def _with_fusion(model, fusion):
    return dataclasses.replace(
        model, cfg=dataclasses.replace(model.cfg, fusion=fusion))


@pytest.mark.parametrize("name,fusion", [("vgg9", ()), ("vgg9", "auto"),
                                         ("resnet18", "auto")],
                         ids=["vgg9-off", "vgg9-auto", "resnet18-auto"])
def test_timed_forward_rows_match_repro(packages, name, fusion):
    tmodel, jmodel = (_with_fusion(m, fusion) for m in packages[name])
    images = _images(tmodel.cfg)
    x = torch.from_numpy(images)
    treg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    logits, rows = obs.timed_forward(tmodel.cfg, tmodel.float_params, x,
                                     package=tmodel, registry=treg)
    with use_backend("jnp"):
        _, jrows = jobs.timed_forward(jmodel.cfg, jmodel.float_params,
                                      jnp.asarray(images), package=jmodel,
                                      registry=jreg)
    assert [(r["layer"], r["kind"]) for r in rows] == \
        [(r["layer"], r["kind"]) for r in jrows]
    assert all(r["wall_us"] > 0 for r in rows)
    assert [r["predicted_us"] is None for r in rows] == \
        [r["predicted_us"] is None for r in jrows]
    assert [r["bottleneck"] for r in rows if r["bottleneck"]]
    graph = build_graph(tmodel.cfg)
    top = {n.name for n in graph.nodes}
    grouped = [g for g in graph.groups if g.members[0] in top]
    assert len(rows) == len(graph.nodes) - sum(len(g.members) - 1
                                               for g in grouped)

    def labels(reg):
        return sorted(tuple(sorted(g.labels))
                      for g in reg.find_all("snn_layer_time_us"))

    assert labels(treg) == labels(jreg)
    spans = [s for s in treg.spans() if s["event"] == "predicted_vs_measured"]
    jspans = [s for s in jreg.spans()
              if s["event"] == "predicted_vs_measured"]
    assert [sorted(s) for s in spans] == [sorted(s) for s in jspans]
    assert all("node" in s and "kind" not in s for s in spans)

    inner = executor_for(graph, tmodel.float_params, package=tmodel)
    with torch.inference_mode():
        want = run_graph(graph, inner, x)
    assert torch.equal(logits, want)
    wrapped = obs.AttributionExecutor(
        executor_for(graph, tmodel.float_params, package=tmodel),
        registry=obs.MetricsRegistry(False))
    with torch.inference_mode():
        run_graph(graph, wrapped, x)
    assert wrapped.trace == inner.trace


def _records():
    rng = np.random.default_rng(3)
    rows = []
    for i in range(7):
        pred = None if i % 3 == 0 else round(float(rng.random()), 4)
        rows.append({"layer": f"l{i}", "kind": "conv",
                     "wall_us": round(float(rng.random() * 100), 2),
                     "predicted_us": pred, "bottleneck": None,
                     "ratio": None})
    return rows


@pytest.mark.parametrize("records", [
    _records(), [], [{"layer": "a", "kind": "pool", "wall_us": 3.0,
                      "predicted_us": None, "bottleneck": None,
                      "ratio": None}],
    [{"layer": "a", "kind": "conv", "wall_us": 2.5, "predicted_us": 0.0,
      "bottleneck": "compute", "ratio": None}]],
    ids=["mixed", "empty", "unpredicted", "zero-prediction"])
def test_attribution_summary_matches_repro(records):
    assert obs.attribution_summary(records) == \
        jobs.attribution_summary(records)


def test_prediction_rounding_to_zero_gives_no_ratio():
    """At H100 rates a tiny node's prediction rounds to 0.0 us at 4
    decimals; the ratio is then None, as ``repro`` guards it."""
    cfg = deploy_config("vgg9", 4)
    spec = Dense("tiny", d_in=1, d_out=1)
    ex = obs.AttributionExecutor(types.SimpleNamespace(cfg=cfg, kind="x"),
                                 registry=obs.MetricsRegistry())
    ex._batch = 1
    out = ex._timed("dense", "tiny", spec, lambda: torch.zeros(1))
    assert out.shape == (1,)
    (row,) = ex.records
    assert row["predicted_us"] == 0.0 and row["ratio"] is None
    assert row["wall_us"] >= 0 and row["bottleneck"] in ("compute", "memory")


class _CudaStandIn:
    """A node output that claims to lie on a card."""
    is_cuda = True
    device = torch.device("cuda", 0)


def test_sync_follows_the_nodes_output(monkeypatch):
    """``_timed`` blocks with ``torch.cuda.synchronize`` on the output's
    device once the node has returned, and not at all for CPU output."""
    events = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: events.append(("sync", device)))
    cfg = deploy_config("vgg9", 4)
    ex = obs.AttributionExecutor(types.SimpleNamespace(cfg=cfg, kind="x"),
                                 registry=obs.MetricsRegistry(False))

    def node():
        events.append(("node", None))
        return _CudaStandIn()

    ex._timed("pool", "p", None, node)
    assert events == [("node", None), ("sync", torch.device("cuda", 0))]
    events.clear()
    ex._timed("pool", "p", None, lambda: torch.zeros(2))
    assert events == []
