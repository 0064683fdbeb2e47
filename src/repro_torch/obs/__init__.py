"""Runtime observability: metrics registry, request tracing, watchdogs.

Port of ``repro.obs``.  One registry serves
the runtime surfaces:

  * the serve engine (deploy/engine.py) traces requests through
    enqueue -> admit -> compile hit/miss -> step -> drain and keeps
    queue-depth / batch-occupancy / padding-waste gauges current;
  * the async tier (serve_async/) adds ``evict`` / ``recycle`` spans,
    slot-occupancy and in-flight gauges and submit/evict/cancel counters;
  * the graph layer yields per-layer spike rates, saturation/reset
    counts and weight code-utilization histograms for any executor via
    :class:`~repro_torch.obs.telemetry.TelemetryExecutor`, with no
    kernel changes.

The live plane sits on top of the same registry:

  * :class:`~repro_torch.obs.server.ObsServer` — an in-process HTTP
    thread exposing ``/metrics`` (Prometheus text), ``/healthz``
    (liveness + watchdog state) and ``/spans?since=`` (incremental span
    drain);
  * :mod:`~repro_torch.obs.chrometrace` — the span ring exported as a
    Chrome/Perfetto ``trace_event`` JSON, requests flow-connected
    enqueue -> drain;
  * :class:`~repro_torch.obs.attribution.AttributionExecutor` — per-layer
    blocked-wall-time attribution joined against the H100 roofline
    prediction (``snn_layer_time_us``, ``predicted_vs_measured``);
  * :class:`~repro_torch.obs.watchdog.Watchdog` — EWMA-baselined SLO and
    spike-rate drift monitors that dump a flight-recorder artifact on
    trip.

The process default registry is DISABLED until something opts in
(``--metrics`` on a launcher, :func:`enable_default` in code); disabled,
every instrument is a shared no-op and the hot paths pay only an empty
method call.  ``python -m repro_torch.obs.validate`` schema-checks
emitted JSONL artifacts (``--trace`` for Chrome trace exports).
"""

from pathlib import Path

from repro_torch.obs.attribution import (  # noqa: F401
    AttributionExecutor,
    attribution_summary,
    predict_node_us,
    timed_forward,
)
from repro_torch.obs.chrometrace import (  # noqa: F401
    export_chrome_trace,
    span_to_events,
    to_chrome_trace,
    validate_chrome_trace,
)
from repro_torch.obs.exporters import (    # noqa: F401
    SCHEMA_VERSION,
    read_jsonl,
    to_prometheus,
    validate_jsonl,
    write_jsonl,
)
from repro_torch.obs.registry import (     # noqa: F401
    FRACTION_EDGES,
    LATENCY_EDGES_US,
    NULL_INSTRUMENT,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    disable_default,
    enable_default,
)
from repro_torch.obs.server import (       # noqa: F401
    PROMETHEUS_CONTENT_TYPE,
    ObsServer,
    add_server_flag,
)
from repro_torch.obs.telemetry import (    # noqa: F401
    TelemetryExecutor,
    code_histogram,
    instrumented_forward,
    package_code_utilization,
    spike_stats,
)
from repro_torch.obs.watchdog import (     # noqa: F401
    Watchdog,
    WatchdogConfig,
    histogram_quantile,
)


#: where the launchers' ``--metrics`` / ``--trace`` write by default:
#: ``build/obs/`` at the repository root (git-ignored)
ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "obs"


def add_metrics_flag(ap, default_path: str) -> None:
    """The shared ``--metrics [PATH]`` launcher flag: bare ``--metrics``
    emits JSONL to ``default_path``, an explicit argument overrides the
    destination, omitted entirely leaves the default registry
    disabled."""
    ap.add_argument("--metrics", nargs="?", const=default_path, default=None,
                    metavar="PATH",
                    help="enable the metrics registry and write a JSONL "
                         f"snapshot to PATH (default {default_path}) on "
                         "exit; validate with python -m "
                         "repro_torch.obs.validate")
