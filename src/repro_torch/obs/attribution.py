"""Per-layer / per-group time attribution for the graph executors.

Port of ``repro.obs.attribution``.  ``snn_serve_compute_us`` says what a
whole forward costs; this module says where it goes.
:class:`AttributionExecutor` wraps any graph executor (float / int /
packaged, the delegation contract of ``TelemetryExecutor``) in a timed
mode: after every node it blocks (``torch.cuda.synchronize`` when the
node's output lies on a card; a CPU node is done when it returns) and
records the blocked wall time per ``(kind, name)``.  Blocking per node
serializes the host's launches with the device's work, so a timed pass
measures attribution, not end-to-end latency: like the telemetry pass it
is sampled (one forward per ``--metrics`` run), never inline on the
serving path.

Each node also gets a roofline prediction on the NVIDIA H100
(``perfmodel.roofline``): the compute term from the node's MACs (2 ops a
MAC) over the peak of the arithmetic its kernel runs, the memory term
from packed-weight bytes + 1-bit spike-plane traffic over ``HBM_BW``.
The packed layers (post-stem convs, the dense layer, residual bodies and
fusion groups) run ``mma.sync`` s8 and are held to ``PEAK_INT8_OPS``; the
float stem, and every layer of the float/BPTT lowering, run float32 with
TF32 off and are held to ``PEAK_FP32_FLOPS``.  ``repro`` holds every node
to one peak; the ``flops`` and ``bytes`` fields are its formulas
unchanged.  Every node emits:

  * ``snn_layer_time_us{layer=...,kind=...}``: the measured blocked wall
    time (gauge);
  * a ``predicted_vs_measured`` span: ``wall_us``, ``predicted_us``,
    ``ratio`` (host over roofline) and the roofline ``bottleneck``
    label, drawn as a duration event on the *layers* track by
    obs/chrometrace.py.

Fusion groups are attributed at the chain boundary (one row per group,
the prediction summed over members): interior planes never leave the
kernel, so finer timing does not exist.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch.graph.executors import WrappedExecutor as _WrappedExecutor
from repro_torch.graph.spec import Conv, Dense, Residual
from repro_torch.obs.registry import MetricsRegistry, default_registry
from repro_torch.perfmodel.roofline import (
    HBM_BW,
    PEAK_FP32_FLOPS,
    PEAK_INT8_OPS,
    pick_bottleneck,
)


def _roofline(flops: float, bytes_: float, peak: float) -> Dict:
    t_comp, t_mem = flops / peak, bytes_ / HBM_BW
    return {
        "predicted_us": round(max(t_comp, t_mem) * 1e6, 4),
        "compute_us": round(t_comp * 1e6, 4),
        "memory_us": round(t_mem * 1e6, 4),
        "bottleneck": pick_bottleneck(t_comp, t_mem, 0.0),
        "flops": flops,
        "bytes": bytes_,
    }


def predict_node_us(spec, timesteps: int, batch: int, bits: int,
                    int_path: bool = True) -> Optional[Dict]:
    """Roofline prediction for one node's full T-step rollout at batch
    ``batch``: compute term from the MACs (2 ops a MAC), memory term from
    packed-weight bytes + 1-bit spike-plane traffic (the fused kernels'
    accounting).  ``int_path`` says whether the node's non-stem convs and
    dense layer run the packed int8 kernels (else float32, as the
    float/BPTT lowering runs them).  Returns ``None`` for nodes the model
    has nothing to say about (encode / pool / readout)."""
    T, B = timesteps, batch

    def _conv_terms(c: Conv):
        w_bits = 32 if c.stem else bits      # the stem stays float
        weight_bytes = c.k * c.k * c.c_in * c.c_out * w_bits / 8
        in_hw = c.out_hw * c.stride
        plane_bits = 32 if c.stem else 1     # analog currents in, else 1-bit
        act_bytes = T * B * (in_hw * in_hw * c.c_in * plane_bits
                             + c.out_hw * c.out_hw * c.c_out) / 8
        return 2.0 * c.macs * T * B, weight_bytes + act_bytes

    packed = PEAK_INT8_OPS if int_path else PEAK_FP32_FLOPS
    if isinstance(spec, Conv):
        flops, bytes_ = _conv_terms(spec)
        peak = PEAK_FP32_FLOPS if spec.stem else packed
    elif isinstance(spec, Dense):
        flops = 2.0 * spec.macs * T * B
        bytes_ = spec.d_in * spec.d_out * bits / 8 \
            + T * B * (spec.d_in + spec.d_out) / 8
        peak = packed
    elif isinstance(spec, Residual):
        flops, bytes_ = 0.0, 0.0
        for c in (*spec.body, *((spec.proj,) if spec.proj else ())):
            f, b = _conv_terms(c)
            flops += f
            bytes_ += b
        peak = packed
    else:
        return None
    return _roofline(flops, bytes_, peak)


class AttributionExecutor(_WrappedExecutor):
    """Timed wrapper: blocked wall time per node, roofline prediction
    beside it.  ``records`` rows: ``{"layer", "kind", "wall_us",
    "predicted_us", "bottleneck", "ratio"}`` in execution order."""

    kind = "attribution"

    def __init__(self, inner, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "snn_layer"):
        super().__init__(inner)
        self.obs = registry if registry is not None else default_registry()
        self.prefix = prefix
        self.records: List[Dict] = []
        self._batch = 0                     # set from the Encode input

    def encode(self, spec, images):
        self._batch = int(images.shape[0])
        return self._timed("encode", spec.name, spec,
                           lambda: self.inner.encode(spec, images))

    def conv(self, spec, x):
        return self._timed("conv", spec.name, spec,
                           lambda: self.inner.conv(spec, x))

    def pool(self, spec, x):
        return self._timed("pool", spec.name, spec,
                           lambda: self.inner.pool(spec, x))

    def residual(self, spec, x):
        return self._timed("residual", spec.name, spec,
                           lambda: self.inner.residual(spec, x))

    def fused_group(self, group, specs, x):
        return self._timed("fusion_group", group.name, list(specs),
                           lambda: self.inner.fused_group(group, specs, x))

    def dense(self, spec, x):
        return self._timed("dense", spec.name, spec,
                           lambda: self.inner.dense(spec, x))

    def readout(self, spec, x):
        return self._timed("readout", spec.name, spec,
                           lambda: self.inner.readout(spec, x))

    # -- the timed mode ------------------------------------------------------

    def _predict(self, spec_or_list) -> Optional[Dict]:
        cfg = self.inner.cfg
        bits = cfg.precision.bits if cfg.precision.quantized else 32
        int_path = cfg.int_path

        def one(s):
            return predict_node_us(s, cfg.timesteps, self._batch, bits,
                                   int_path)

        if not isinstance(spec_or_list, list):
            return one(spec_or_list)
        # a fusion group: the members' terms summed
        preds = [p for p in map(one, spec_or_list) if p is not None]
        if not preds:
            return None
        return _roofline(sum(p["flops"] for p in preds),
                         sum(p["bytes"] for p in preds),
                         PEAK_INT8_OPS if int_path else PEAK_FP32_FLOPS)

    def _timed(self, kind: str, name: str, spec, fn):
        t0 = time.perf_counter()
        out = fn()
        # block HERE, once the node's output exists: the wall below is
        # this node's device + host share, not whenever the queue drains
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        wall_us = (time.perf_counter() - t0) * 1e6
        pred = self._predict(spec)
        row = {"layer": name, "kind": kind,
               "wall_us": round(wall_us, 2),
               "predicted_us": pred["predicted_us"] if pred else None,
               "bottleneck": pred["bottleneck"] if pred else None,
               "ratio": round(wall_us / pred["predicted_us"], 2)
               if pred and pred["predicted_us"] > 0 else None}
        self.records.append(row)
        labels = {"layer": name, "kind": kind}
        self.obs.gauge(f"{self.prefix}_time_us",
                       "blocked wall time of one timed forward, per node",
                       labels).set(wall_us)
        # "kind" is the JSONL line discriminator (exporters schema), so
        # the span carries the node kind as "node", as the
        # layer_telemetry spans do
        span = {("node" if k == "kind" else k): v
                for k, v in row.items() if v is not None}
        self.obs.event("predicted_vs_measured", **span)
        return out


def timed_forward(cfg, params, images, package=None,
                  registry: Optional[MetricsRegistry] = None):
    """One timed forward of the model ``cfg`` describes, the attribution
    twin of ``instrumented_forward``: builds the graph, picks the
    float/int/packaged lowering, wraps it in :class:`AttributionExecutor`
    and runs it (no autograd; the card's queue drained first, so the
    first node is charged its own work only).  Returns ``(logits,
    records)`` and emits ``snn_layer_time_us`` + ``predicted_vs_measured``
    into ``registry`` (default: the process default)."""
    from repro_torch.graph import build_graph, executor_for, run_graph

    graph = build_graph(cfg)
    ex = AttributionExecutor(executor_for(graph, params, package=package),
                             registry=registry)
    if images.is_cuda:
        torch.cuda.synchronize(images.device)
    with torch.inference_mode():
        logits = run_graph(graph, ex, images)
    return logits, ex.records


def attribution_summary(records: List[Dict]) -> Dict:
    """Roll a timed pass up: total measured wall, total predicted, the
    host-over-roofline ratio, and the heaviest node."""
    timed = [r for r in records if r["wall_us"] is not None]
    wall = sum(r["wall_us"] for r in timed)
    pred = sum(r["predicted_us"] or 0.0 for r in timed)
    top = max(timed, key=lambda r: r["wall_us"], default=None)
    return {
        "wall_us": round(wall, 1),
        "predicted_us": round(pred, 1),
        "host_over_roofline_x": round(wall / pred, 1) if pred else None,
        "hottest_layer": top["layer"] if top else None,
        "hottest_wall_us": round(top["wall_us"], 1) if top else None,
        "nodes": len(timed),
    }
