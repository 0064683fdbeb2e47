"""Thread-safe metrics registry — the process-wide instrument store.

Three instrument kinds, Prometheus-shaped so the exporters are trivial:

``Counter``    monotonically increasing float (requests served, compile
               misses).  ``inc(n)``.
``Gauge``      last-write-wins float (queue depth, batch occupancy).
               ``set(v)``.
``Histogram``  fixed ascending bucket edges chosen at creation; every
               ``observe(v)`` lands in the first bucket with
               ``v <= edge`` (plus a +Inf overflow bucket) and updates
               running sum/count.  Edges are part of the metric's
               identity — re-registering with different edges raises.

Instruments are registered by ``(name, labels)`` and cached: asking the
registry for the same counter twice returns the same object, so call
sites hold instrument handles instead of doing dict lookups on the hot
path.  All mutation is lock-protected (one lock per instrument; the
registry lock only guards registration), so concurrent engine/trainer
threads can hammer the same counter safely.

Disabled mode is the overhead contract: a registry constructed with
``enabled=False`` (the process-global default — see
:func:`default_registry`) hands out a shared no-op instrument whose
``inc``/``set``/``observe`` are empty methods, and ``event()`` returns
after one attribute check.  Nothing is allocated, nothing is recorded, and
the serving hot path pays only an empty method call.

Port of ``repro.obs.registry`` (framework-free, kept as the port's own
copy): the same instruments, names, edges and span ring.

Span events (``event(name, **fields)``) land in a bounded ring buffer
(``max_spans``, oldest dropped first) with a monotonic microsecond
timestamp — a long-lived server cannot leak memory through its trace.
Every span also carries a monotonically increasing ``seq``, so the HTTP
span endpoint (obs/server.py) can drain incrementally
(``spans_since(seq)``) and ``span_stats()`` can report how many events
the ring has already dropped — a scraper that falls behind sees the gap
instead of a silently truncated trace.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

# Shared default edges for request-latency-scale histograms (microseconds,
# ~2.5x geometric steps from scheduler noise to a stuck second).
LATENCY_EDGES_US: Tuple[float, ...] = (
    50.0, 100.0, 250.0, 500.0, 1_000.0, 2_500.0, 5_000.0, 10_000.0,
    25_000.0, 50_000.0, 100_000.0, 250_000.0, 500_000.0, 1_000_000.0,
)

# Shared default edges for unit-interval fractions (spike rates, padding
# waste, code utilization).
FRACTION_EDGES: Tuple[float, ...] = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
)

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, str]]) -> LabelsKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _NullInstrument:
    """The shared do-nothing instrument a disabled registry hands out.
    One instance serves every metric kind — its mutators are empty
    methods, so a disabled call site costs one attribute lookup and an
    argument-less-body call."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NULL_INSTRUMENT = _NullInstrument()


class Counter:
    kind = "counter"

    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels: LabelsKey, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def zero(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self) -> dict:
        return {"kind": self.kind, "name": self.name,
                "labels": dict(self.labels), "value": self._value}


class Gauge:
    kind = "gauge"

    __slots__ = ("name", "labels", "help", "_lock", "_value")

    def __init__(self, name: str, labels: LabelsKey, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def zero(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self) -> dict:
        return {"kind": self.kind, "name": self.name,
                "labels": dict(self.labels), "value": self._value}


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` counts observations with
    ``v <= edges[i]`` exclusive of earlier buckets; ``counts[-1]`` is the
    +Inf overflow.  Cumulative (Prometheus ``le``) form is derived at
    export time, so ``observe`` is one bisect + one increment."""

    kind = "histogram"

    __slots__ = ("name", "labels", "help", "edges", "_lock", "_counts",
                 "_sum", "_count")

    def __init__(self, name: str, labels: LabelsKey,
                 edges: Iterable[float], help: str = ""):
        edges = tuple(float(e) for e in edges)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram {name}: edges must be non-empty and strictly "
                f"ascending, got {edges}")
        self.name = name
        self.labels = labels
        self.help = help
        self.edges = edges
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        import bisect

        i = bisect.bisect_left(self.edges, float(v))
        with self._lock:
            self._counts[i] += 1
            self._sum += float(v)
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def counts(self) -> List[int]:
        return list(self._counts)

    def zero(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.edges) + 1)
            self._sum = 0.0
            self._count = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "name": self.name,
                    "labels": dict(self.labels), "edges": list(self.edges),
                    "counts": list(self._counts), "sum": self._sum,
                    "count": self._count}


class MetricsRegistry:
    """Instrument store + span ring buffer.  See module docstring.

    ``enabled=False`` makes every registration return the shared no-op
    instrument and every ``event()`` a near-free early return — the
    disabled-mode overhead policy call sites rely on.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 20_000):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelsKey], object] = {}
        self._spans: deque = deque(maxlen=max_spans)
        self._span_seq = 0
        # monotonic epoch for span timestamps (perf_counter, never
        # time.time(): span deltas must survive NTP/DST wall-clock steps)
        self._t0 = time.perf_counter()

    # -- registration --------------------------------------------------------

    def _register(self, cls, name: str, labels, help: str, **kw):
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (name, _labels_key(labels))
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = cls(name, key[1], help=help, **kw)
                self._metrics[key] = inst
            elif not isinstance(inst, cls) or (
                    kw.get("edges") is not None
                    and tuple(float(e) for e in kw["edges"]) != inst.edges):
                raise ValueError(
                    f"metric {name!r}{dict(key[1])} already registered as "
                    f"{inst.kind} with different identity")
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._register(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._register(Gauge, name, labels, help)

    def histogram(self, name: str, edges: Iterable[float] = LATENCY_EDGES_US,
                  help: str = "",
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._register(Histogram, name, labels, help, edges=edges)

    # -- spans ---------------------------------------------------------------

    def event(self, name: str, **fields) -> None:
        """Append one span event to the ring buffer (no-op when
        disabled).  ``ts_us`` is microseconds since registry creation on
        the monotonic clock; ``seq`` is the monotonically increasing
        event number (1-based), the cursor ``spans_since`` drains by."""
        if not self.enabled:
            return
        ev = {"event": name,
              "ts_us": (time.perf_counter() - self._t0) * 1e6}
        ev.update(fields)
        with self._lock:
            self._span_seq += 1
            ev["seq"] = self._span_seq
            self._spans.append(ev)

    # -- introspection -------------------------------------------------------

    def metrics(self) -> List[object]:
        with self._lock:
            return list(self._metrics.values())

    def find(self, name: str,
             labels: Optional[Dict[str, str]] = None) -> Optional[object]:
        """Look up an instrument WITHOUT registering it (``counter()``
        et al. create on miss; monitors like the watchdog must not)."""
        with self._lock:
            return self._metrics.get((name, _labels_key(labels)))

    def find_all(self, name: str) -> List[object]:
        """Every label series registered under ``name`` (e.g. all the
        per-layer ``snn_layer_spike_rate{layer=...}`` gauges)."""
        with self._lock:
            return [m for (n, _), m in self._metrics.items() if n == name]

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans)

    def spans_since(self, seq: int) -> List[dict]:
        """Spans with ``seq`` strictly greater than the cursor — the
        incremental drain behind ``GET /spans?since=`` (obs/server.py).
        A cursor older than the ring simply yields everything retained;
        ``span_stats()['dropped']`` tells the caller about the gap."""
        with self._lock:
            return [dict(ev) for ev in self._spans if ev["seq"] > seq]

    def span_stats(self) -> Dict[str, int]:
        """``{"appended", "retained", "dropped"}`` — dropped is how many
        events the bounded ring has already evicted."""
        with self._lock:
            return {"appended": self._span_seq,
                    "retained": len(self._spans),
                    "dropped": self._span_seq - len(self._spans)}

    def snapshot(self) -> dict:
        """Point-in-time dump: ``{"metrics": [...], "spans": [...]}`` —
        the structure the exporters serialize."""
        return {"metrics": [m.snapshot() for m in self.metrics()],
                "spans": self.spans()}

    def reset(self) -> None:
        """Zero every instrument IN PLACE and clear the span ring.

        Call sites bind instrument handles at construction time (the
        engine/trainer overhead contract), so reset must NOT clear
        ``_metrics``: that would leave those handles recording into
        detached objects that no exporter or scrape would ever see
        again.  Instead each instrument is zeroed through its own lock —
        held references stay attached and keep recording, and the next
        snapshot starts from a clean slate."""
        with self._lock:
            for inst in self._metrics.values():
                inst.zero()
            self._spans.clear()
            self._span_seq = 0
            self._t0 = time.perf_counter()


# ---------------------------------------------------------------------------
# the process-global default
# ---------------------------------------------------------------------------

# Disabled until something opts in (a --metrics flag, a test): every
# call site that doesn't get an explicit registry records nothing and
# pays the no-op cost only.
_DEFAULT = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def enable_default(max_spans: int = 20_000) -> MetricsRegistry:
    """Swap in an enabled default registry (what ``--metrics`` does).
    Returns it.  Instruments are bound at call-site construction time, so
    enable BEFORE building engines/trainers that should record."""
    global _DEFAULT
    _DEFAULT = MetricsRegistry(enabled=True, max_spans=max_spans)
    return _DEFAULT


def disable_default() -> MetricsRegistry:
    """Restore the disabled default (tests use this to isolate)."""
    global _DEFAULT
    _DEFAULT = MetricsRegistry(enabled=False)
    return _DEFAULT
