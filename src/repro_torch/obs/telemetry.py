"""SNN model telemetry through the graph layer, with no kernel changes.

Port of ``repro.obs.telemetry``.  Spike activity is the quantity SNN
energy models are built on (every spike is a synaptic-memory access),
and L-SPINE's INT2/4/8 analysis also cares how much of each precision's
code space the packed weights use.  Both are observable from outside
the kernels:

* :class:`TelemetryExecutor` wraps any graph executor (float / int /
  packaged) and records, after every top-level Conv, every Residual
  merge and every Dense (``apply_with_rates``'s points):

    ``rate``        mean firing probability over (T, B, units)
    ``saturation``  fraction of units firing in EVERY timestep: the
                    rate-code ceiling, where a unit carries no more
                    information and switches the most
    ``silent``      fraction of units that never fire (dead capacity)
    ``resets``      total threshold crossings in the batch: every output
                    spike triggers exactly one reset in both reset modes,
                    so the spike count is the reset count.

  Every statistic reads the spike plane back to the host, so the serve
  path samples: one instrumented forward per ``--metrics`` run, never
  one per request.

* :func:`code_histogram` / :func:`package_code_utilization` read the
  packed weights of a layer / a whole ``DeployedModel`` and histogram
  the integer codes over the 2^bits code space: ``utilization``
  (fraction of codes used) and ``clip_frac`` (mass at the extreme codes)
  are the first health checks of the MSE clip search at 2 bits.

Metric names, help strings, labels and the ``layer_telemetry`` /
``code_utilization`` spans are ``repro``'s.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.graph.executors import WrappedExecutor as _WrappedExecutor
from repro_torch.graph.executors import mean_f32
from repro_torch.obs.registry import (
    FRACTION_EDGES,
    MetricsRegistry,
    default_registry,
)


# ---------------------------------------------------------------------------
# spike statistics
# ---------------------------------------------------------------------------

def spike_stats(spikes_t) -> Dict[str, float]:
    """Activity statistics of one layer's (T, B, ...) spike train.
    Works on the float twin's {0.0, 1.0} spikes and the integer path's
    {0, 1} int32 spikes alike.  The means are ``repro``'s float32 means
    (:func:`~repro_torch.graph.executors.mean_f32`), equal to the bit."""
    fired = torch.as_tensor(spikes_t) > 0
    per_unit = mean_f32(fired, dim=0)                   # (B, units...)
    return {
        "rate": float(mean_f32(fired)),
        "saturation": float(mean_f32(per_unit >= 1.0)),
        "silent": float(mean_f32(per_unit <= 0.0)),
        "resets": int(torch.sum(fired)),
    }


class TelemetryExecutor(_WrappedExecutor):
    """Instrumenting wrapper over any graph executor (see
    :class:`repro_torch.graph.executors.WrappedExecutor` for the
    delegation contract): records spike statistics after the spiking
    layers.

    Residual body convs are recorded once, at the merge; the non-spiking
    readout and the pools are pass-through.
    """

    kind = "telemetry"

    def __init__(self, inner, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "snn_layer"):
        super().__init__(inner)
        self.obs = registry if registry is not None else default_registry()
        self.prefix = prefix
        self.records: List[Dict] = []

    def conv(self, spec, x):
        return self._record("conv", spec.name, self.inner.conv(spec, x))

    def residual(self, spec, x):
        return self._record("residual", spec.name,
                            self.inner.residual(spec, x))

    def dense(self, spec, x):
        return self._record("dense", spec.name, self.inner.dense(spec, x))

    def fused_group(self, group, specs, x):
        """A fused chain's interior planes never leave the kernel, so its
        interior members cannot be sampled one by one: the group is
        recorded as ONE aggregate row at its boundary (its final spike
        planes), named after the group.  Ungroup (``fusion=()``) to
        sample per layer again."""
        return self._record("fusion_group", group.name,
                            self.inner.fused_group(group, specs, x))

    def _record(self, kind: str, name: str, spikes_t):
        stats = spike_stats(spikes_t)
        row = {"layer": name, "node": kind, "executor": self.inner.kind}
        row.update(stats)
        self.records.append(row)
        labels = {"layer": name}
        self.obs.gauge(f"{self.prefix}_spike_rate",
                       "mean firing probability", labels).set(stats["rate"])
        self.obs.gauge(f"{self.prefix}_saturation",
                       "fraction of units firing every timestep",
                       labels).set(stats["saturation"])
        self.obs.gauge(f"{self.prefix}_silent",
                       "fraction of units that never fire",
                       labels).set(stats["silent"])
        self.obs.counter(f"{self.prefix}_resets_total",
                         "threshold crossings observed",
                         labels).inc(stats["resets"])
        self.obs.histogram(f"{self.prefix}_rates", FRACTION_EDGES,
                           "per-layer spike-rate distribution"
                           ).observe(stats["rate"])
        self.obs.event("layer_telemetry", layer=name, node=kind, **stats)
        return spikes_t


def instrumented_forward(cfg, params, images, package=None,
                         registry: Optional[MetricsRegistry] = None):
    """One instrumented forward of the model ``cfg`` describes: builds
    the graph, picks the float/int/packaged lowering as ``snn_cnn.apply``
    does, wraps it in :class:`TelemetryExecutor` and runs it (no
    autograd).  Returns ``(logits, records)`` and emits the per-layer
    metrics into ``registry`` (default: the process default)."""
    from repro_torch.graph import build_graph, executor_for, run_graph

    graph = build_graph(cfg)
    ex = TelemetryExecutor(executor_for(graph, params, package=package),
                           registry=registry)
    with torch.inference_mode():
        logits = run_graph(graph, ex, images)
    return logits, ex.records


# ---------------------------------------------------------------------------
# quantization code utilization
# ---------------------------------------------------------------------------

def code_histogram(qt) -> Dict:
    """Histogram a packed layer's integer weight codes over the full
    [qmin, qmax] code space.  ``qt`` is a ``QuantizedTensor`` (dense) or
    ``QuantizedConvTensor`` (conv: the padded input channels are
    excluded, they are structural zeros, not weights)."""
    from repro_torch.core import packing
    from repro_torch.quant.formats import QuantizedConvTensor
    from repro_torch.quant.ptq import unpack_conv_codes

    if isinstance(qt, QuantizedConvTensor):
        codes = unpack_conv_codes(qt)
    else:
        codes = packing.unpack(qt.data, qt.bits, qt.n)
    codes = codes.cpu().numpy()
    n_codes = 1 << qt.bits
    qmin = -(n_codes // 2)
    counts = np.bincount((codes.reshape(-1) - qmin).astype(np.int64),
                         minlength=n_codes)
    total = int(counts.sum())
    return {
        "bits": qt.bits,
        "qmin": qmin,
        "counts": counts.tolist(),
        "total": total,
        "utilization": float(np.count_nonzero(counts)) / n_codes,
        "clip_frac": float(counts[0] + counts[-1]) / max(total, 1),
        "zero_frac": float(counts[-qmin]) / max(total, 1),
    }


def package_code_utilization(model, registry: Optional[MetricsRegistry]
                             = None) -> Dict[str, Dict]:
    """Per-layer code histograms for a ``DeployedModel``, emitted as
    gauges (``snn_weight_code_utilization{layer=...}``, ``..._clip_frac``)
    plus one aggregate utilization histogram.  Returns the per-layer
    dicts keyed by layer name."""
    obs = registry if registry is not None else default_registry()
    out: Dict[str, Dict] = {}
    util_h = obs.histogram("snn_weight_code_utilization_hist",
                           FRACTION_EDGES,
                           "per-layer code-space utilization")
    for name, lp in model.layers.items():
        h = code_histogram(lp.qt)
        out[name] = h
        labels = {"layer": name}
        obs.gauge("snn_weight_code_utilization",
                  "fraction of the 2^bits code space used",
                  labels).set(h["utilization"])
        obs.gauge("snn_weight_code_clip_frac",
                  "weight mass at the extreme codes", labels
                  ).set(h["clip_frac"])
        util_h.observe(h["utilization"])
        obs.event("code_utilization", layer=name, bits=h["bits"],
                  utilization=h["utilization"], clip_frac=h["clip_frac"])
    return out
