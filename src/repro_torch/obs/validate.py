"""CLI schema validator for emitted obs artifacts.

    PYTHONPATH=src python -m repro_torch.obs.validate out.jsonl \
        --require-spans enqueue,admit,step,drain \
        --require-metrics snn_serve_requests_total,snn_layer_spike_rate

    PYTHONPATH=src python -m repro_torch.obs.validate out.trace.json --trace

Default mode checks a ``--metrics`` JSONL snapshot (schema in
obs/exporters.py); ``--trace`` checks a Chrome trace_event export
(schema in obs/chrometrace.py) instead — flight-recorder pairs are
validated with one invocation each.  Exit 0 when the file parses and
every required span event / metric name is present; 1 otherwise, with
one line per problem on stderr.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.obs.exporters import read_jsonl, validate_jsonl


def _csv(arg: Optional[str]) -> List[str]:
    return [s for s in (arg or "").split(",") if s]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a --metrics JSONL artifact (or, with "
                    "--trace, a Chrome trace export) against the obs "
                    "schema")
    ap.add_argument("path", help="JSONL file written by --metrics, or a "
                                 ".trace.json written by --trace/the "
                                 "flight recorder")
    ap.add_argument("--trace", action="store_true",
                    help="validate a Chrome trace_event JSON export "
                         "instead of a metrics JSONL snapshot")
    ap.add_argument("--require-spans", default="",
                    help="comma-separated span event names that must occur")
    ap.add_argument("--require-metrics", default="",
                    help="comma-separated metric names that must occur")
    args = ap.parse_args(argv)

    if args.trace:
        from repro_torch.obs.chrometrace import validate_chrome_trace
        problems = validate_chrome_trace(args.path)
        if not problems:
            print(f"[obs] {args.path}: OK — valid Chrome trace")
            return 0
        for p in problems:
            print(f"[obs] {args.path}: {p}", file=sys.stderr)
        return 1

    problems = validate_jsonl(args.path)
    if not problems:
        doc = read_jsonl(args.path)
        events = {ev.get("event") for ev in doc["spans"]}
        names = {m.get("name") for m in doc["metrics"]}
        for want in _csv(args.require_spans):
            if want not in events:
                problems.append(f"required span event {want!r} missing "
                                f"(have: {sorted(e for e in events if e)})")
        for want in _csv(args.require_metrics):
            if want not in names:
                problems.append(f"required metric {want!r} missing "
                                f"(have: {sorted(n for n in names if n)})")
        if not problems:
            print(f"[obs] {args.path}: OK — {len(doc['metrics'])} metrics, "
                  f"{len(doc['spans'])} spans")
            return 0
    for p in problems:
        print(f"[obs] {args.path}: {p}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
