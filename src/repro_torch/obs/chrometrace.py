"""Chrome/Perfetto ``trace_event`` export of the span ring buffer.

The span ring (obs/registry.py) already records the whole request
lifecycle — ``enqueue -> admit -> compile -> step -> drain`` — as point
events with monotonic microsecond timestamps and carried durations
(``queue_us``, ``compute_us``, ``latency_us``...).  This module turns
that into the Chrome trace-event JSON format, so one
``chrome://tracing`` / Perfetto load shows the request lanes.

Port of ``repro.obs.chrometrace``: the same mapping, track ids and
event names, so a trace of the port and one of the JAX package read
alike (the process keeps the name ``repro.obs``, the schema's name;
``otherData.producer`` names this module).

Mapping (one track per surface, constant across exports so goldens pin
it):

  * per-request lifecycle on the **requests** track: each ``drain``
    becomes a duration event ``request/<uid>`` spanning
    ``[ts - latency_us, ts]``, flow-connected (``ph: s`` at ``enqueue``,
    ``ph: f`` at ``drain``, ``id = uid``) so Chrome draws the arrow from
    the enqueue instant to the served request even across tracks.
  * batch machinery on the **batch** track: ``admit`` instants,
    ``compile/b<bucket>`` and ``step/b<bucket>`` duration events
    reconstructed from their carried ``compile_us`` / ``compute_us``
    (span timestamps are taken at completion, so the duration event
    starts at ``ts - dur``).
  * trainer steps on the **train** track, per-layer attribution
    (``predicted_vs_measured``) and sampled telemetry on the **layers**
    track, watchdog trips/clears on the **watchdog** track.
  * async-tier slot lifetimes on the **slots** track: each ``recycle``
    becomes a duration event ``slot/<n>`` spanning its carried
    ``held_us``, so continuous-batching occupancy reads as recurring
    per-slot lanes; ``evict`` instants land on the requests track and
    terminate the evicted request's enqueue flow arrow.
  * anything unrecognized lands on the **misc** track as an instant with
    its fields preserved in ``args`` — new span producers degrade to
    visible, never to dropped.

``ts`` stays the registry's monotonic ``ts_us`` verbatim (trace-event
timestamps are microseconds), clamped only so reconstructed starts never
go negative.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Union

from repro_torch.obs.registry import MetricsRegistry

# pid/tid layout — one process, one thread ("track") per surface
PID = 1
TRACKS = {
    "requests": 1,
    "batch": 2,
    "train": 3,
    "layers": 4,
    "watchdog": 5,
    "misc": 6,
    "slots": 7,
}

_FLOW_CAT = "request"


def _meta_events() -> List[dict]:
    evs = [{"ph": "M", "pid": PID, "name": "process_name",
            "args": {"name": "repro.obs"}}]
    for name, tid in TRACKS.items():
        evs.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_name", "args": {"name": name}})
        evs.append({"ph": "M", "pid": PID, "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": tid}})
    return evs


def _base(ph: str, name: str, ts: float, tid: int, **kw) -> dict:
    ev = {"ph": ph, "name": name, "ts": round(float(ts), 3),
          "pid": PID, "tid": tid, "cat": kw.pop("cat", "span")}
    ev.update(kw)
    return ev


def _duration(name: str, end_ts: float, dur_us, tid: int,
              args: Optional[Dict] = None, cat: str = "span") -> dict:
    """Complete ("X") event ending at ``end_ts`` — span events are
    recorded at completion, so the start is reconstructed from the
    carried duration (clamped at the registry epoch)."""
    dur = max(float(dur_us or 0.0), 0.0)
    ts = max(float(end_ts) - dur, 0.0)
    return _base("X", name, ts, tid, dur=round(dur, 3), cat=cat,
                 args=args or {})


def _args(ev: dict, *skip: str) -> Dict:
    drop = {"event", "ts_us", "seq", *skip}
    return {k: v for k, v in ev.items() if k not in drop}


def span_to_events(ev: dict) -> List[dict]:
    """Trace events for ONE span-ring entry (see module docstring for
    the mapping).  Exposed for tests; most callers want
    :func:`to_chrome_trace`."""
    kind, ts = ev.get("event"), ev.get("ts_us", 0.0)
    if kind == "enqueue":
        uid = ev.get("uid", -1)
        return [
            _base("i", "enqueue", ts, TRACKS["requests"], s="t",
                  args=_args(ev)),
            _base("s", f"req/{uid}", ts, TRACKS["requests"],
                  cat=_FLOW_CAT, id=uid),
        ]
    if kind == "admit":
        return [_base("i", "admit", ts, TRACKS["batch"], s="t",
                      args=_args(ev))]
    if kind == "compile":
        return [_duration(f"compile/b{ev.get('bucket', '?')}", ts,
                          ev.get("compile_us"), TRACKS["batch"],
                          args=_args(ev, "compile_us"))]
    if kind == "step":
        return [_duration(f"step/b{ev.get('bucket', '?')}", ts,
                          ev.get("compute_us"), TRACKS["batch"],
                          args=_args(ev, "compute_us"))]
    if kind == "drain":
        uid = ev.get("uid", -1)
        return [
            _duration(f"request/{uid}", ts, ev.get("latency_us"),
                      TRACKS["requests"], args=_args(ev, "latency_us")),
            _base("f", f"req/{uid}", ts, TRACKS["requests"],
                  cat=_FLOW_CAT, id=uid, bp="e"),
        ]
    if kind == "evict":
        # deadline-expired request: terminate its enqueue flow arrow and
        # mark the eviction where the request lane would have drained
        uid = ev.get("uid", -1)
        return [
            _base("i", f"evict/{uid}", ts, TRACKS["requests"], s="t",
                  args=_args(ev)),
            _base("f", f"req/{uid}", ts, TRACKS["requests"],
                  cat=_FLOW_CAT, id=uid, bp="e"),
        ]
    if kind == "recycle":
        # slot-lifetime row: one duration event per occupancy interval,
        # named by slot so each slot renders as its own recurring lane
        return [_duration(f"slot/{ev.get('slot', '?')}", ts,
                          ev.get("held_us"), TRACKS["slots"],
                          args=_args(ev, "held_us"), cat="slot")]
    if kind == "train_step":
        return [_duration(f"train_step/{ev.get('step', '?')}", ts,
                          ev.get("dt_us"), TRACKS["train"],
                          args=_args(ev, "dt_us"))]
    if kind == "predicted_vs_measured":
        return [_duration(f"{ev.get('layer', '?')}", ts,
                          ev.get("wall_us"), TRACKS["layers"],
                          args=_args(ev, "wall_us"), cat="attribution")]
    if kind in ("layer_telemetry", "code_utilization"):
        return [_base("i", f"{kind}/{ev.get('layer', '?')}", ts,
                      TRACKS["layers"], s="t", args=_args(ev))]
    if kind in ("watchdog", "watchdog_clear"):
        return [_base("i", f"{kind}:{ev.get('rule', '?')}", ts,
                      TRACKS["watchdog"], s="g", cat="watchdog",
                      args=_args(ev))]
    # unknown producers stay visible
    return [_base("i", str(kind), ts, TRACKS["misc"], s="t",
                  args=_args(ev))]


def to_chrome_trace(source: Union[MetricsRegistry, Iterable[dict]],
                    meta: Optional[Dict] = None) -> dict:
    """Convert a registry (or a raw span list) into a Chrome trace-event
    document: ``{"traceEvents": [...], "displayTimeUnit": "ms"}``."""
    spans = source.spans() if isinstance(source, MetricsRegistry) \
        else list(source)
    events = _meta_events()
    for ev in spans:
        events.extend(span_to_events(ev))
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"producer": "repro_torch.obs.chrometrace",
                         "spans": len(spans)}}
    if meta:
        doc["otherData"].update(meta)
    return doc


def export_chrome_trace(source: Union[MetricsRegistry, Iterable[dict]],
                        path: str, meta: Optional[Dict] = None) -> str:
    """Write the trace JSON to ``path`` (dirs created).  Returns the
    path (the launchers print it)."""
    doc = to_chrome_trace(source, meta=meta)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True)
    return path


def validate_chrome_trace(path: str) -> List[str]:
    """Schema-check an exported trace (what ``python -m
    repro_torch.obs.validate --trace`` runs).  Returns
    human-readable problems (empty = valid): well-formed JSON object,
    a ``traceEvents`` list, every event carries ``ph``/``pid``, duration
    events carry non-negative ``ts``+``dur``, and every flow finish has
    a matching flow start (the enqueue->drain connection the export
    promises)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        return [f"cannot read {path}: {e}"]
    except json.JSONDecodeError as e:
        return [f"{path}: not JSON ({e})"]
    problems: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return [f"{path}: expected an object with a traceEvents list"]
    starts, finishes = set(), set()
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict) or "ph" not in ev:
            problems.append(f"event {i}: missing ph")
            continue
        ph = ev["ph"]
        if "pid" not in ev:
            problems.append(f"event {i}: missing pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({ev.get('name')}): X event "
                                f"needs non-negative dur, got {dur!r}")
        elif ph == "s":
            starts.add(ev.get("id"))
        elif ph == "f":
            finishes.add(ev.get("id"))
    for fid in sorted(finishes - starts, key=str):
        problems.append(f"flow finish id={fid!r} has no matching start")
    return problems
