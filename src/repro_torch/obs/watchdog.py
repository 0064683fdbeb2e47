"""SLO / drift watchdogs: EWMA-baselined monitors over the live registry.

The failure mode that dominates real SNN deployments is SILENT: spike
sparsity drifts away from the calibration the energy/latency case was
built on, and nothing in a post-mortem JSONL dump notices until the run
is over.  The
watchdog watches the live registry instead — it never creates the
instruments it reads (``find``/``find_all`` only), so it observes
exactly what the engine/telemetry already record.

Four rules, each an EWMA over its signal so one noisy sample cannot
flap the alarm (the EWMA seeds at the first observation, so a genuine
10x step change still trips on the very next check):

``spike_rate_drift``  per-layer ``snn_layer_spike_rate{layer=...}`` vs
                      the calibration snapshot taken before serving;
                      trips when the EWMA'd ratio leaves
                      ``[1/drift_x, drift_x]``.
``latency_slo``       p95 of ``snn_serve_latency_us`` (conservative
                      upper-bucket-edge quantile) vs ``slo_p95_ms``.
``queue_growth``      EWMA of ``snn_serve_queue_depth`` vs
                      ``queue_depth_limit`` — a backlog that keeps
                      growing is an arrival rate the engine cannot
                      drain.
``padding_waste``     EWMA of ``snn_serve_padding_waste`` vs
                      ``padding_ceiling`` — sustained waste means the
                      bucket ladder no longer matches the traffic.

A rule is LATCHED once tripped: it fires exactly one trip (span
``watchdog{rule=...}``, ``snn_watchdog_trips_total{rule=...}`` bump,
flight-recorder dump) and stays quiet until the signal recovers below
``clear_fraction`` of its threshold, which emits a ``watchdog_clear``
span and re-arms it — a sustained breach cannot spam one artifact per
check.

In the port, nothing records ``snn_layer_spike_rate`` yet (the
telemetry executor is not ported), so ``spike_rate_drift`` finds no
series and stays quiet; the other three rules read the serve engine's
instruments.

The flight recorder writes the full registry snapshot
(``flight_<n>_<rule>.jsonl``, validates with ``python -m
repro_torch.obs.validate``) plus the Chrome trace of the span ring
(``flight_<n>_<rule>.trace.json``) — everything needed to reconstruct
what the engine was doing when the rule fired.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Dict, List, Optional

from repro_torch.obs.registry import Gauge, Histogram, MetricsRegistry

RULES = ("spike_rate_drift", "latency_slo", "queue_growth",
         "padding_waste")


def histogram_quantile(hist, q: float) -> float:
    """Conservative quantile from a fixed-bucket histogram (instrument
    or snapshot dict): the UPPER edge of the bucket containing the
    q-quantile observation — never an underestimate, which is the safe
    direction for an SLO alarm.  Observations in the +Inf overflow
    bucket report the last finite edge (a lower bound; the alarm
    already fired by then)."""
    snap = hist.snapshot() if isinstance(hist, Histogram) else hist
    total = snap["count"]
    if not total:
        return 0.0
    target = max(1, math.ceil(q * total))
    cum = 0
    for edge, c in zip(snap["edges"], snap["counts"]):
        cum += c
        if cum >= target:
            return float(edge)
    return float(snap["edges"][-1])


@dataclasses.dataclass
class WatchdogConfig:
    #: p95 request-latency SLO (snn_serve_latency_us histogram)
    slo_p95_ms: float = 250.0
    #: per-layer spike-rate ratio band vs calibration: [1/x, x]
    spike_drift_x: float = 3.0
    #: queue-depth EWMA ceiling
    queue_depth_limit: float = 512.0
    #: padding-waste EWMA ceiling (fraction of bucket slots padded)
    padding_ceiling: float = 0.75
    #: EWMA smoothing (weight of the newest sample)
    ewma_alpha: float = 0.4
    #: a tripped rule re-arms once its signal recovers below this
    #: fraction of the threshold (hysteresis)
    clear_fraction: float = 0.8
    #: calibration rates below this are too quiet to ratio against
    min_calibration_rate: float = 1e-4
    #: where flight-recorder artifacts land (None = no artifacts)
    artifact_dir: Optional[str] = None


class Watchdog:
    """Monitor the live registry; see the module docstring for the rule
    set.  ``check()`` is cheap (a handful of snapshot reads) — the serve
    engine calls it once per microbatch (``attach_watchdog``)."""

    def __init__(self, registry: MetricsRegistry,
                 calibration: Optional[Dict[str, float]] = None,
                 cfg: Optional[WatchdogConfig] = None):
        self.obs = registry
        self.cfg = cfg or WatchdogConfig()
        #: layer -> calibrated spike rate (the snapshot drift is judged
        #: against; empty disables the drift rule)
        self.calibration = dict(calibration or {})
        self._lock = threading.Lock()
        # per-signal EWMA + latch state, keyed "rule" or "rule/layer"
        self._ewma: Dict[str, float] = {}
        self._tripped: Dict[str, bool] = {}
        self.trips: List[Dict] = []
        self.artifacts: List[str] = []
        self._flight_n = 0
        # construction-bound instruments, like every other obs surface —
        # all rules visible (at 0) on /metrics before anything fires
        self._m_checks = registry.counter("snn_watchdog_checks_total",
                                          "watchdog evaluations")
        self._m_trips = {
            rule: registry.counter("snn_watchdog_trips_total",
                                   "watchdog rules tripped",
                                   labels={"rule": rule})
            for rule in RULES
        }

    # -- public surface ------------------------------------------------------

    @property
    def trips_total(self) -> int:
        return len(self.trips)

    def health(self) -> Dict:
        """The /healthz contribution: trip totals + per-rule state."""
        with self._lock:
            return {
                "trips_total": len(self.trips),
                "checks": int(self._m_checks.value)
                if hasattr(self._m_checks, "value") else 0,
                "tripped_rules": sorted(
                    {t["rule"] for t in self.trips
                     if self._tripped.get(t["key"], False)}),
                "last_trip": dict(self.trips[-1]) if self.trips else None,
                "artifacts": list(self.artifacts),
            }

    def check(self) -> List[Dict]:
        """Evaluate every rule once; returns the trips FIRED by this
        check (transitions only — latched rules stay quiet)."""
        self._m_checks.inc()
        fired: List[Dict] = []
        fired += self._check_drift()
        fired += self._check_latency()
        fired += self._check_gauge_rule(
            "queue_growth", "snn_serve_queue_depth",
            self.cfg.queue_depth_limit, unit="requests")
        fired += self._check_gauge_rule(
            "padding_waste", "snn_serve_padding_waste",
            self.cfg.padding_ceiling, unit="fraction")
        return fired

    # -- rules ---------------------------------------------------------------

    def _check_drift(self) -> List[Dict]:
        fired = []
        if not self.calibration:
            return fired
        for g in self.obs.find_all("snn_layer_spike_rate"):
            layer = dict(g.labels).get("layer")
            cal = self.calibration.get(layer)
            if cal is None or cal < self.cfg.min_calibration_rate:
                continue
            ratio = float(g.value) / cal
            key = f"spike_rate_drift/{layer}"
            ew = self._update_ewma(key, ratio)
            hi, lo = self.cfg.spike_drift_x, 1.0 / self.cfg.spike_drift_x
            breach = ew > hi or ew < lo
            # recovery band: back inside the thresholds shrunk/grown by
            # clear_fraction
            clear = (lo / self.cfg.clear_fraction) <= ew \
                <= hi * self.cfg.clear_fraction
            trip = self._latch(key, breach, clear)
            if trip:
                fired.append(self._fire(
                    "spike_rate_drift", key, layer=layer,
                    calibrated_rate=cal, live_rate=float(g.value),
                    ratio_ewma=round(ew, 4),
                    threshold_x=self.cfg.spike_drift_x))
        return fired

    def _check_latency(self) -> List[Dict]:
        h = self.obs.find("snn_serve_latency_us")
        if not isinstance(h, Histogram) or h.count == 0:
            return []
        p95_ms = histogram_quantile(h, 0.95) / 1e3
        ew = self._update_ewma("latency_slo", p95_ms)
        breach = ew > self.cfg.slo_p95_ms
        clear = ew <= self.cfg.slo_p95_ms * self.cfg.clear_fraction
        if self._latch("latency_slo", breach, clear):
            return [self._fire("latency_slo", "latency_slo",
                               p95_ms=round(p95_ms, 3),
                               p95_ewma_ms=round(ew, 3),
                               slo_p95_ms=self.cfg.slo_p95_ms)]
        return []

    def _check_gauge_rule(self, rule: str, metric: str, limit: float,
                          unit: str) -> List[Dict]:
        g = self.obs.find(metric)
        if not isinstance(g, Gauge):
            return []
        ew = self._update_ewma(rule, float(g.value))
        breach = ew > limit
        clear = ew <= limit * self.cfg.clear_fraction
        if self._latch(rule, breach, clear):
            return [self._fire(rule, rule, value=float(g.value),
                               ewma=round(ew, 4), limit=limit, unit=unit)]
        return []

    # -- machinery -----------------------------------------------------------

    def _update_ewma(self, key: str, x: float) -> float:
        with self._lock:
            prev = self._ewma.get(key)
            ew = x if prev is None else \
                self.cfg.ewma_alpha * x + (1 - self.cfg.ewma_alpha) * prev
            self._ewma[key] = ew
            return ew

    def _latch(self, key: str, breach: bool, clear: bool) -> bool:
        """True exactly when this check TRANSITIONS the rule into the
        tripped state; recovery through the hysteresis band re-arms."""
        with self._lock:
            tripped = self._tripped.get(key, False)
            if breach and not tripped:
                self._tripped[key] = True
                return True
            if tripped and clear:
                self._tripped[key] = False
                self.obs.event("watchdog_clear", rule=key.split("/")[0],
                               key=key)
            return False

    def _fire(self, rule: str, key: str, **detail) -> Dict:
        trip = {"rule": rule, "key": key, "trip_index": len(self.trips)}
        trip.update(detail)
        # counter + span land BEFORE the flight-recorder dump, so the
        # artifact's snapshot proves the trip it was written for
        self._m_trips[rule].inc()
        self.obs.event("watchdog", **trip)
        paths = self._flight_record(rule, detail)
        if paths:
            trip["artifacts"] = paths
        with self._lock:
            self.trips.append(trip)
        return trip

    def _flight_record(self, rule: str, detail: Dict) -> List[str]:
        """Dump the full registry snapshot + Chrome trace on trip."""
        if not self.cfg.artifact_dir:
            return []
        from repro_torch.obs.chrometrace import export_chrome_trace
        from repro_torch.obs.exporters import write_jsonl

        with self._lock:
            self._flight_n += 1
            n = self._flight_n
        stem = os.path.join(self.cfg.artifact_dir,
                            f"flight_{n:03d}_{rule}")
        meta = {"flight_recorder": rule}
        meta.update({k: v for k, v in detail.items()
                     if isinstance(v, (int, float, str))})
        paths = [
            write_jsonl(self.obs, stem + ".jsonl", meta=meta),
            export_chrome_trace(self.obs, stem + ".trace.json", meta=meta),
        ]
        with self._lock:
            self.artifacts.extend(paths)
        return paths
