"""The port's SNN telemetry (``repro_torch.obs.telemetry``) against
``repro.obs.telemetry`` (``jnp`` backend), and the serve launcher's
sampled passes.

* ``spike_stats`` on ``repro``'s hand example, and on random planes
  equal to ``repro``'s to the bit (float32 means).
* ``instrumented_forward``: vgg9 and resnet18 at smoke geometry, bits
  2/4/8, ``fusion`` off and auto, through the packaged executor: the
  same (layer, node, executor, rate, saturation, silent, resets) records
  as ``repro``'s, exactly; the per-call integer executor records the
  same rows (held against ``repro``'s for vgg9 at 4 bits).  One package serves both
  sides: the port deploys and saves it, ``repro`` loads the npz.  The
  metrics JSONL of the pass plus ``package_code_utilization`` is
  identical apart from timestamps, and the code histograms are equal.
  Tolerance: none.
* Wrapping changes nothing: the logits equal the unwrapped forward's bit
  for bit, the trace rows are the inner executor's, and a vgg9
  ``fusion="auto"`` forward still runs its chain as one ``fused_group``.
* ``serve_snn.main([... --device cpu --metrics PATH])`` emits the
  ``layer_telemetry``, ``predicted_vs_measured`` and ``code_utilization``
  spans and hands the telemetry rates to the watchdog as its
  calibration; ``--model vgg16`` serves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.deploy import load as jload
from repro.kernels import use_backend
from repro_torch import obs
from repro_torch.deploy import deploy, deploy_config, load
from repro_torch.graph import build_graph, executor_for, run_graph
from repro_torch.kernels.fused_group import ref as group_ref
from repro_torch.models import snn_cnn

# (model, bits) cases whose per-call integer executor also runs on the
# JAX side (~2 s a vgg9 forward, ~10 s a resnet18 one: repro's eager
# scans compile on every call); every case holds the port's integer
# records equal to its packaged ones
JAX_INT_CASES = {("vgg9", 4)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _images(cfg, n=2, seed=7):
    return np.random.default_rng(seed).random(
        (n, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)


def _strip_times(rows):
    return [{k: v for k, v in r.items() if k not in ("ts_us",
                                                     "emitted_unix")}
            for r in rows]


@pytest.fixture(scope="module", params=[
    (m, b) for m in ("vgg9", "resnet18") for b in (2, 4, 8)],
    ids=lambda p: f"{p[0]}-w{p[1]}")
def packages(request, tmp_path_factory):
    """One deploy of one set of float params (grouped, ``fusion="auto"``),
    saved by the port and loaded by both packages; the float params on
    both sides for the per-call integer path.  The params are balanced by
    ``calibrate`` first, so every layer fires (uncalibrated, vgg9 at W2
    goes silent before its last conv and the group's row would compare
    zeros)."""
    name, bits = request.param
    cfg = deploy_config(name, bits, fusion="auto")
    params = snn_cnn.calibrate(
        snn_cnn.init(bits + 20, cfg, device="cpu"),
        dataclasses.replace(cfg, int_deploy=False),
        torch.from_numpy(_images(cfg, n=8, seed=1)))
    path = deploy(params, cfg, device="cpu").save(
        str(tmp_path_factory.mktemp("pkg") / f"{name}_w{bits}.npz"))
    jparams = jax.tree.map(jnp.asarray, _numpy_tree(params))
    return name, bits, params, jparams, load(path, device="cpu"), jload(path)


def _with_fusion(model, fusion):
    return dataclasses.replace(
        model, cfg=dataclasses.replace(model.cfg, fusion=fusion))


def test_spike_stats_hand_example():
    # (T=2, B=1, 3 units): unit0 fires both steps (saturated), unit1
    # never (silent), unit2 once
    s = torch.tensor([[[1, 0, 1]], [[1, 0, 0]]], dtype=torch.int32)
    st = obs.spike_stats(s)
    assert st == jobs.spike_stats(jnp.asarray(s.numpy()))
    assert st["rate"] == pytest.approx(3 / 6)
    assert st["saturation"] == pytest.approx(1 / 3)
    assert st["silent"] == pytest.approx(1 / 3)
    assert st["resets"] == 3


@pytest.mark.parametrize("shape", [(3, 2, 7, 5, 19), (4, 3, 1000),
                                   (3, 2, 4, 4, 76)])
def test_spike_stats_equal_repro_to_the_bit(shape):
    """float32 means over counts that torch.mean would round the other
    way now and then; int32 and float planes alike."""
    rng = np.random.default_rng(sum(shape))
    for p in (0.03, 0.3, 0.9):
        s = (rng.random(shape) < p).astype(np.int32)
        assert obs.spike_stats(torch.from_numpy(s)) == \
            jobs.spike_stats(jnp.asarray(s))
        assert obs.spike_stats(torch.from_numpy(s.astype(np.float32))) == \
            jobs.spike_stats(jnp.asarray(s, jnp.float32))


@pytest.mark.parametrize("fusion", ["auto", ()], ids=["auto", "off"])
def test_instrumented_forward_matches_repro(packages, fusion, tmp_path):
    name, bits, params, jparams, tmodel, jmodel = packages
    tmodel, jmodel = _with_fusion(tmodel, fusion), _with_fusion(jmodel,
                                                                fusion)
    images = _images(tmodel.cfg)
    x = torch.from_numpy(images)
    assert bool(build_graph(tmodel.cfg).groups) == bool(fusion)

    treg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    logits, records = obs.instrumented_forward(
        tmodel.cfg, tmodel.float_params, x, package=tmodel, registry=treg)
    with use_backend("jnp"):
        jlogits, jrecords = jobs.instrumented_forward(
            jmodel.cfg, jmodel.float_params, jnp.asarray(images),
            package=jmodel, registry=jreg)
    assert records == jrecords
    assert [r["executor"] for r in records] == ["packaged"] * len(records)
    assert all(0 < r["rate"] < 1 for r in records), "vacuous"
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)

    util = obs.package_code_utilization(tmodel, registry=treg)
    assert util == jobs.package_code_utilization(jmodel, registry=jreg)
    assert set(util) == set(tmodel.layers)
    meta = {"entry": "test", "model": name}
    mine = obs.read_jsonl(obs.write_jsonl(treg, str(tmp_path / "t.jsonl"),
                                          meta=meta))
    theirs = jobs.read_jsonl(jobs.write_jsonl(
        jreg, str(tmp_path / "j.jsonl"), meta=meta))
    assert _strip_times(mine["metrics"]) == _strip_times(theirs["metrics"])
    assert _strip_times(mine["spans"]) == _strip_times(theirs["spans"])
    assert {s["event"] for s in mine["spans"]} == {"layer_telemetry",
                                                   "code_utilization"}

    _, irecords = obs.instrumented_forward(
        tmodel.cfg, params, x, registry=obs.MetricsRegistry(False))
    assert [r["executor"] for r in irecords] == ["int"] * len(records)
    assert [{**r, "executor": "packaged"} for r in irecords] == records
    if (name, bits) in JAX_INT_CASES:
        with use_backend("jnp"):
            _, jirecords = jobs.instrumented_forward(
                jmodel.cfg, jparams, jnp.asarray(images),
                registry=jobs.MetricsRegistry(False))
        assert irecords == jirecords


@pytest.mark.parametrize("fusion", ["auto", ()], ids=["auto", "off"])
@pytest.mark.parametrize("name", ["vgg9", "resnet18"])
def test_wrapper_changes_nothing(name, fusion, monkeypatch):
    """The wrapped forward's logits equal the unwrapped one's bit for bit,
    the trace rows are the inner executor's, the top-level chain (vgg9)
    and the residual bodies (resnet18) still run as one ``fused_group``
    each, and the recorded rows are the graph's instrumentation points
    (a top-level group as one row)."""
    cfg = deploy_config(name, 4, fusion=fusion)
    params = snn_cnn.init(3, cfg, device="cpu")
    model = deploy(params, cfg, device="cpu")
    graph = build_graph(cfg)
    x = torch.from_numpy(_images(cfg, seed=11))
    calls = []
    plain = group_ref.fused_group_rollout_torch
    monkeypatch.setattr(group_ref, "fused_group_rollout_torch",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    for package in (model, None):
        p = model.float_params if package is not None else params
        inner = executor_for(graph, p, package=package)
        with torch.inference_mode():
            want = run_graph(graph, inner, x)
        n_groups = len(calls)
        assert n_groups == len(graph.groups)
        wrapped = obs.TelemetryExecutor(executor_for(graph, p,
                                                     package=package),
                                        registry=obs.MetricsRegistry(False))
        assert wrapped.supports_groups == inner.supports_groups is True
        with torch.inference_mode():
            got = run_graph(graph, wrapped, x)
        assert len(calls) == 2 * n_groups
        calls.clear()
        assert torch.equal(got, want)
        assert wrapped.trace == inner.trace and wrapped.trace
        top = {n.name for n in graph.nodes}
        grouped = [g for g in graph.groups if g.members[0] in top]
        members = {m for g in grouped for m in g.members}
        points = [n.name for n in graph.nodes
                  if type(n).__name__ in ("Conv", "Residual", "Dense")
                  and n.name not in members]
        assert sorted(r["layer"] for r in wrapped.records) == \
            sorted(points + [g.name for g in grouped])


def test_code_histogram_excludes_conv_padding():
    """Padded input channels are structural zeros, not weights: a conv
    with c_in = 5 counts 3*3*5*8 codes, as ``repro`` does."""
    from repro.quant.formats import PrecisionConfig as JPC
    from repro.quant.ptq import quantize_conv as jquantize_conv
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize, quantize_conv

    rng = np.random.default_rng(0)
    wc = rng.normal(size=(3, 3, 5, 8)).astype(np.float32)
    h = obs.code_histogram(quantize_conv(torch.from_numpy(wc),
                                         PrecisionConfig(bits=4)))
    assert h == jobs.code_histogram(jquantize_conv(jnp.asarray(wc),
                                                   JPC(bits=4)))
    assert h["total"] == 3 * 3 * 5 * 8 and len(h["counts"]) == 16
    w = torch.from_numpy(rng.normal(size=(24, 16)).astype(np.float32))
    h = obs.code_histogram(quantize(w, PrecisionConfig(bits=2)))
    assert h["total"] == 24 * 16 and sum(h["counts"]) == h["total"]


class _RecordingWatchdog(obs.Watchdog):
    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.made.append(self)


def test_launcher_sampled_passes_calibrate_the_watchdog(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    from repro_torch.launch import serve_snn
    from repro_torch.obs import validate

    _RecordingWatchdog.made = []
    monkeypatch.setattr(obs, "Watchdog", _RecordingWatchdog)
    path = tmp_path / "serve_snn.jsonl"
    try:
        stats = serve_snn.main(["--device", "cpu", "--fusion", "auto",
                                "--requests", "4", "--max-batch", "2",
                                "--metrics", str(path)])
    finally:
        obs.disable_default()
    assert stats["requests"] == 4
    spans = "layer_telemetry,predicted_vs_measured,code_utilization"
    assert validate.main([str(path), "--require-spans", spans]) == 0
    doc = obs.read_jsonl(str(path))
    rates = {s["layer"]: s["rate"] for s in doc["spans"]
             if s["event"] == "layer_telemetry"}
    assert list(rates) == ["convs.0", "fuse.0", "fc1"]
    (wd,) = _RecordingWatchdog.made
    assert wd.calibration == rates
    timed = [s for s in doc["spans"] if s["event"] == "predicted_vs_measured"]
    assert [s["layer"] for s in timed] == ["encode", "convs.0", "fuse.0",
                                          "fc1", "head"]
    assert {s["layer"] for s in doc["spans"]
            if s["event"] == "code_utilization"} == \
        {"convs.1", "convs.2", "convs.3", "convs.4", "fc1"}
    out = capsys.readouterr().out
    assert "[obs] attribution: 5 nodes" in out and "code util" in out


def test_launcher_serves_vgg16(capsys):
    from repro_torch.launch import serve_snn

    stats = serve_snn.main(["--device", "cpu", "--model", "vgg16",
                            "--requests", "3", "--max-batch", "2"])
    assert stats["requests"] == 3
    assert "packed vgg16 W4" in capsys.readouterr().out
