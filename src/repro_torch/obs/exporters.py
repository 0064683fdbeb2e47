"""Registry serialization: JSONL (machine-readable) + Prometheus text.

JSONL is the artifact contract (one self-describing JSON object per
line) the ``--metrics PATH`` launcher flag emits:

    {"kind": "meta", "schema": 1, "emitted_unix": ..., ...}     line 1
    {"kind": "counter", "name": ..., "labels": {...}, "value": ...}
    {"kind": "gauge", ...}
    {"kind": "histogram", "name": ..., "edges": [...],
     "counts": [...], "sum": ..., "count": ...}
    {"kind": "span", "event": ..., "ts_us": ..., <fields>}

``read_jsonl`` is the exact inverse of ``write_jsonl`` (round-trip
asserted in tests/test_obs.py); :func:`validate_jsonl` checks an emitted
file against this schema without needing the registry that produced it
(what ``python -m repro_torch.obs.validate`` runs).

Port of ``repro.obs.exporters``: the same schema and the same text, line
for line.

The Prometheus exposition (``to_prometheus``) is the pull-scrape twin of
the same snapshot — HELP/TYPE headers, ``{label="v"}`` selectors, and
cumulative ``_bucket{le=...}`` series for histograms — so pointing a
scraper at a future HTTP endpoint needs no new serialization code.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from repro_torch.obs.registry import MetricsRegistry

SCHEMA_VERSION = 1

_METRIC_KINDS = ("counter", "gauge", "histogram")


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------

def write_jsonl(registry: MetricsRegistry, path: str,
                meta: Optional[Dict] = None) -> str:
    """Dump a registry snapshot as JSONL (meta line first).  Returns the
    path written."""
    import os

    snap = registry.snapshot()
    head = {"kind": "meta", "schema": SCHEMA_VERSION,
            # wall time is for log correlation only — every latency
            # number in the file is a monotonic-clock delta
            "emitted_unix": time.time()}
    head.update(meta or {})
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(head, sort_keys=True) + "\n")
        for m in snap["metrics"]:
            f.write(json.dumps(m, sort_keys=True) + "\n")
        for ev in snap["spans"]:
            row = {"kind": "span"}
            row.update(ev)
            f.write(json.dumps(row, sort_keys=True) + "\n")
    return path


def read_jsonl(path: str) -> dict:
    """Inverse of :func:`write_jsonl`:
    ``{"meta": {...}, "metrics": [...], "spans": [...]}``."""
    meta: Dict = {}
    metrics: List[dict] = []
    spans: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            kind = row.get("kind")
            if kind == "meta":
                meta = {k: v for k, v in row.items() if k != "kind"}
            elif kind == "span":
                spans.append({k: v for k, v in row.items() if k != "kind"})
            else:
                metrics.append(row)
    return {"meta": meta, "metrics": metrics, "spans": spans}


def validate_jsonl(path: str) -> List[str]:
    """Schema-check an emitted metrics file.  Returns a list of human-
    readable problems (empty = valid).  Used by ``python -m
    repro_torch.obs.validate``."""
    errors: List[str] = []
    try:
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    except OSError as e:
        return [f"cannot read {path}: {e}"]
    if not lines:
        return [f"{path}: empty file"]
    rows = []
    for i, line in enumerate(lines, start=1):
        try:
            rows.append((i, json.loads(line)))
        except json.JSONDecodeError as e:
            errors.append(f"line {i}: not JSON ({e})")
    if errors:
        return errors

    i0, head = rows[0]
    if head.get("kind") != "meta":
        errors.append(f"line {i0}: first line must be kind=meta, "
                      f"got {head.get('kind')!r}")
    elif head.get("schema") != SCHEMA_VERSION:
        errors.append(f"line {i0}: schema {head.get('schema')!r} != "
                      f"{SCHEMA_VERSION}")

    for i, row in rows[1:]:
        kind = row.get("kind")
        if kind == "meta":
            errors.append(f"line {i}: duplicate meta line")
        elif kind == "span":
            if "event" not in row or not isinstance(row.get("ts_us"),
                                                    (int, float)):
                errors.append(f"line {i}: span needs event + numeric ts_us")
        elif kind in _METRIC_KINDS:
            if not isinstance(row.get("name"), str) or not row.get("name"):
                errors.append(f"line {i}: {kind} needs a name")
                continue
            if not isinstance(row.get("labels"), dict):
                errors.append(f"line {i}: {row['name']}: labels must be a "
                              f"dict")
            if kind == "histogram":
                edges, counts = row.get("edges"), row.get("counts")
                if (not isinstance(edges, list) or not isinstance(counts,
                                                                  list)
                        or len(counts) != len(edges) + 1):
                    errors.append(
                        f"line {i}: {row['name']}: histogram needs "
                        f"len(counts) == len(edges) + 1")
                elif sum(counts) != row.get("count"):
                    errors.append(
                        f"line {i}: {row['name']}: sum(counts)="
                        f"{sum(counts)} != count={row.get('count')}")
            elif not isinstance(row.get("value"), (int, float)):
                errors.append(f"line {i}: {row['name']}: {kind} needs a "
                              f"numeric value")
        else:
            errors.append(f"line {i}: unknown kind {kind!r}")
    return errors


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _escape_label_value(v) -> str:
    """Label-value escaping per exposition format 0.0.4: backslash,
    double-quote, and line-feed must be escaped (in that order —
    escaping the backslash last would corrupt the other two)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-text escaping per exposition format 0.0.4: backslash and
    line-feed only (double quotes are legal in HELP)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: Dict[str, str], extra: Optional[Dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format (0.0.4).
    Spans are trace data, not time series — they stay JSONL-only."""
    lines: List[str] = []
    seen_header = set()
    for m in registry.metrics():
        snap = m.snapshot()
        name, kind = snap["name"], snap["kind"]
        if name not in seen_header:
            seen_header.add(name)
            if getattr(m, "help", ""):
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {kind}")
        labels = snap["labels"]
        if kind == "histogram":
            cum = 0
            for edge, c in zip(snap["edges"], snap["counts"]):
                cum += c
                lines.append(f"{name}_bucket"
                             f"{_label_str(labels, {'le': f'{edge:g}'})} "
                             f"{cum}")
            lines.append(f"{name}_bucket{_label_str(labels, {'le': '+Inf'})}"
                         f" {snap['count']}")
            lines.append(f"{name}_sum{_label_str(labels)} {snap['sum']}")
            lines.append(f"{name}_count{_label_str(labels)} {snap['count']}")
        else:
            lines.append(f"{name}{_label_str(labels)} {snap['value']}")
    return "\n".join(lines) + ("\n" if lines else "")
