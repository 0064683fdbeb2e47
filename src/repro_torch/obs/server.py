"""Live metrics endpoint: a stdlib HTTP thread over the registry.

Post-mortem JSONL (``--metrics PATH``) cannot watch a long-running serve
loop; this module is the pull side of the same registry — a background
``ThreadingHTTPServer`` (no new dependencies) the launchers start with
``--metrics-port``:

  ``GET /metrics``        Prometheus text exposition (``to_prometheus``)
                          of every instrument, scrape-ready.
  ``GET /healthz``        JSON liveness: server uptime, registry span
                          stats, plus whatever the attached ``health_fn``
                          reports (the serve engine contributes queue
                          depth, compile-cache state, and watchdog trip
                          counts — see ``SNNServeEngine.health``).
  ``GET /spans?since=N``  incremental JSON span drain: events with
                          ``seq > N`` plus the next cursor, so a tailer
                          polls without re-reading the whole ring.
                          ``dropped`` reports ring evictions — a slow
                          tailer sees the gap, never a silent hole.

Every read path goes through the registry's own snapshot methods (each
instrument snapshots under its per-instrument lock), so a concurrent
scrape during a serving step can interleave with writes but never
deadlock or tear a histogram — tests hammer /metrics while the engine
steps.

Port 0 binds an ephemeral port (tests); ``start()`` returns the real
one.  The server thread is a daemon: a crashed main loop never hangs on
observability.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlsplit

from repro_torch.obs.exporters import to_prometheus
from repro_torch.obs.registry import MetricsRegistry, default_registry

#: content type Prometheus scrapers expect for exposition format 0.0.4
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: cap on one /spans response, so a huge ring cannot OOM a tailer
SPANS_PAGE_LIMIT = 5_000


class ObsServer:
    """Background HTTP server exposing one registry.  ``health_fn`` is an
    optional zero-arg callable returning a JSON-serializable dict merged
    into /healthz (the engine passes its ``health`` method)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], Dict]] = None):
        self.registry = registry if registry is not None else \
            default_registry()
        self.host = host
        self.port = port
        self.health_fn = health_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t_start = 0.0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        """Bind + serve on a daemon thread.  Returns the bound port
        (meaningful when constructed with port=0)."""
        if self._httpd is not None:
            return self.port
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        # daemon threads per request too: a stuck client never pins exit
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._t_start = time.perf_counter()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-server", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # -- endpoint bodies (handler delegates here; also unit-testable) --------

    def render_metrics(self) -> str:
        return to_prometheus(self.registry)

    def render_healthz(self) -> Dict:
        body: Dict = {
            "status": "ok",
            "uptime_s": round(time.perf_counter() - self._t_start, 3),
            "registry_enabled": self.registry.enabled,
            "spans": self.registry.span_stats(),
        }
        if self.health_fn is not None:
            try:
                body.update(self.health_fn())
            except Exception as e:  # health must never take the server down
                body["status"] = "degraded"
                body["health_error"] = f"{type(e).__name__}: {e}"
        wd = body.get("watchdog")
        if isinstance(wd, dict) and wd.get("trips_total", 0) > 0:
            body["status"] = "tripped"
        return body

    def render_spans(self, since: int, limit: int = SPANS_PAGE_LIMIT) -> Dict:
        spans = self.registry.spans_since(since)[:max(limit, 0)]
        stats = self.registry.span_stats()
        return {
            "spans": spans,
            # resume cursor: last seq served, or the caller's own cursor
            # when nothing new arrived
            "next_since": spans[-1]["seq"] if spans else since,
            "appended_total": stats["appended"],
            "dropped_total": stats["dropped"],
        }


def _make_handler(server: ObsServer):
    class Handler(BaseHTTPRequestHandler):
        # keep scrapes quiet — one log line per scrape would drown the
        # launcher's own output
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, obj, code: int = 200) -> None:
            self._reply(code, (json.dumps(obj, sort_keys=True) + "\n")
                        .encode(), "application/json")

        def do_GET(self):  # noqa: N802 — http.server API
            try:
                url = urlsplit(self.path)
                if url.path == "/metrics":
                    self._reply(200, server.render_metrics().encode(),
                                PROMETHEUS_CONTENT_TYPE)
                elif url.path == "/healthz":
                    self._reply_json(server.render_healthz())
                elif url.path == "/spans":
                    q = parse_qs(url.query)
                    try:
                        since = int(q.get("since", ["0"])[0])
                        limit = int(q.get("limit",
                                          [str(SPANS_PAGE_LIMIT)])[0])
                    except ValueError:
                        self._reply_json(
                            {"error": "since/limit must be integers"}, 400)
                        return
                    self._reply_json(server.render_spans(since, limit))
                elif url.path == "/":
                    self._reply(200, b"repro_torch.obs: /metrics /healthz "
                                b"/spans?since=N\n", "text/plain")
                else:
                    self._reply(404, f"no route {url.path}\n".encode(),
                                "text/plain")
            except BrokenPipeError:     # client went away mid-write
                pass
            except Exception as e:      # never take the server thread down
                try:
                    self._reply(500, f"{type(e).__name__}: {e}\n".encode(),
                                "text/plain")
                except Exception:
                    pass

    return Handler


def add_server_flag(ap) -> None:
    """The shared ``--metrics-port`` launcher flag: start an
    :class:`ObsServer` on this port (0 = ephemeral, printed at startup)
    for live /metrics, /healthz and /spans.  Implies an enabled
    registry even without ``--metrics PATH``."""
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live /metrics (Prometheus), /healthz and "
                         "/spans?since= on PORT (0 = ephemeral); implies "
                         "an enabled metrics registry")
