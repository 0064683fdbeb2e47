"""Open-loop Poisson load generation for the serving tiers.

Closed-loop drivers (serve_bench's burst loop, serve_snn's enqueue-all
stream) measure the engine at its own pace: a new request only arrives
when the previous one is out of the way, so queueing delay hides.  An
**open-loop** generator schedules arrivals from a Poisson process and
submits at those times NO MATTER how far behind the engine is — the
only honest way to measure tail latency at a fixed offered load, and
the reason ``offered_rps`` (what the schedule asked for) and
``achieved_rps`` (what the engine sustained) are reported separately:
when achieved < offered the system is saturated and p99 is meaningless
except as "growing".

Two drivers share one schedule:

* :func:`run_open_loop_async` — the real thing: the caller's thread
  submits into :class:`~repro_torch.serve_async.engine.AsyncSNNServeEngine`
  at each arrival time (submit never blocks on inference), then
  collects the futures.
* :func:`run_open_loop_sync` — the baseline: a submitter thread feeds
  ``add_request`` at the SAME arrival times (true open-loop stamps)
  while the main thread drives ``step()`` greedily.  The queue_avg_ms
  gap between the two at equal offered load is the number the async
  tier exists to shrink.

Arrival schedules are seeded (``poisson_schedule``) so sync/async runs
— and bench re-runs — see identical arrival processes.

Port of ``repro.serve_async.loadgen``: ``poisson_schedule`` is numpy
and gives the JAX package's schedule for a seed.

CLI (``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given):
  PYTHONPATH=src python -m repro_torch.serve_async.loadgen \
      --rate 8 --requests 24 --mode both --metrics out.jsonl
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import List, Optional, Tuple

import numpy as np


def poisson_schedule(rate_rps: float, n: int, seed: int = 0) -> np.ndarray:
    """Arrival offsets (seconds from t0) of a Poisson process at
    ``rate_rps``: cumulative sum of iid exponential inter-arrivals.
    Seeded so every tier under comparison replays the same arrivals."""
    if rate_rps <= 0:
        raise ValueError(f"rate must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return np.cumsum(gaps)


@dataclasses.dataclass
class LoadGenReport:
    """One open-loop run's outcome.  ``offered_rps`` comes from the
    schedule (n / last arrival), ``achieved_rps`` from the wall clock
    (completed / span to last completion) — equal only when the engine
    kept up."""

    mode: str                    # "sync" | "async"
    requests: int
    completed: int
    timeouts: int
    cancelled: int
    offered_rps: float
    achieved_rps: float
    wall_s: float
    latency_p50_ms: float
    latency_p95_ms: float
    latency_p99_ms: float
    latency_max_ms: float
    queue_avg_ms: float
    compute_avg_ms: float

    def summary(self) -> str:
        return (f"[{self.mode}] offered={self.offered_rps:.1f}rps "
                f"achieved={self.achieved_rps:.1f}rps "
                f"({self.completed}/{self.requests} ok, "
                f"{self.timeouts} timeout, {self.cancelled} cancelled) "
                f"p50={self.latency_p50_ms:.1f}ms "
                f"p95={self.latency_p95_ms:.1f}ms "
                f"p99={self.latency_p99_ms:.1f}ms "
                f"queue_avg={self.queue_avg_ms:.1f}ms "
                f"compute_avg={self.compute_avg_ms:.1f}ms")


def _pctl(sorted_vals: List[float], q: float) -> float:
    # nearest-rank, matching SNNServeEngine._pctl
    if not sorted_vals:
        return 0.0
    return sorted_vals[max(0, math.ceil(q * len(sorted_vals)) - 1)]


def _report(mode: str, n: int, offered_rps: float, wall_s: float,
            stats: List[Tuple[float, float, float]],
            timeouts: int, cancelled: int) -> LoadGenReport:
    """``stats`` = (latency_s, queue_s, compute_s) per COMPLETED req."""
    lats = sorted(s[0] for s in stats)
    completed = len(stats)
    return LoadGenReport(
        mode=mode, requests=n, completed=completed, timeouts=timeouts,
        cancelled=cancelled, offered_rps=offered_rps,
        achieved_rps=completed / wall_s if wall_s > 0 else 0.0,
        wall_s=wall_s,
        latency_p50_ms=1e3 * _pctl(lats, 0.5),
        latency_p95_ms=1e3 * _pctl(lats, 0.95),
        latency_p99_ms=1e3 * _pctl(lats, 0.99),
        latency_max_ms=1e3 * (lats[-1] if lats else 0.0),
        queue_avg_ms=(1e3 * sum(s[1] for s in stats) / completed
                      if completed else 0.0),
        compute_avg_ms=(1e3 * sum(s[2] for s in stats) / completed
                        if completed else 0.0))


def _offered(schedule: np.ndarray) -> float:
    span = float(schedule[-1]) if len(schedule) else 0.0
    return len(schedule) / span if span > 0 else float("inf")


def run_open_loop_async(aeng, images: np.ndarray, schedule: np.ndarray,
                        deadline_ms: Optional[float] = None,
                        result_timeout_s: float = 120.0) -> LoadGenReport:
    """Submit at the scheduled arrival times into a STARTED async
    engine; collect every future.  The submit loop never waits on a
    result — that's what makes it open-loop."""
    n = len(schedule)
    futures = []
    t_start = time.perf_counter()
    for i in range(n):
        wait = t_start + float(schedule[i]) - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futures.append(aeng.submit(images[i % len(images)],
                                   deadline_ms=deadline_ms))
    results = [f.result(timeout=result_timeout_s) for f in futures]
    wall = time.perf_counter() - t_start
    stats = [(r.latency_s, r.queue_s, r.compute_s) for r in results if r.ok]
    return _report("async", n, _offered(schedule), wall, stats,
                   timeouts=sum(r.status == "timeout" for r in results),
                   cancelled=sum(r.status == "cancelled" for r in results))


def run_open_loop_sync(eng, images: np.ndarray,
                       schedule: np.ndarray) -> LoadGenReport:
    """Same arrival process against the synchronous engine: a submitter
    thread calls ``add_request`` at the scheduled times (so queue
    delays are stamped honestly) while this thread drives ``step()``
    greedily.  No deadlines — the sync engine has no eviction path, so
    every request completes."""
    from repro_torch.deploy.engine import SNNRequest

    n = len(schedule)
    t_start = time.perf_counter()

    def _submit():
        for i in range(n):
            wait = t_start + float(schedule[i]) - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            eng.add_request(SNNRequest(uid=i,
                                       image=images[i % len(images)]))

    th = threading.Thread(target=_submit, name="loadgen-submitter",
                          daemon=True)
    th.start()
    served = 0
    while served < n:
        if eng.queue:
            served += eng.step()
        else:
            time.sleep(0.0005)
    th.join()
    wall = time.perf_counter() - t_start
    stats = []
    for i in range(n):
        req = eng.pop_result(i)
        stats.append((req.latency_s, req.queue_s, req.compute_s))
    return _report("sync", n, _offered(schedule), wall, stats,
                   timeouts=0, cancelled=0)


def main(argv=None):
    import argparse

    from repro_torch import obs

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="vgg9", choices=("vgg9", "resnet18"))
    ap.add_argument("--bits", type=int, default=4, choices=(2, 4, 8))
    ap.add_argument("--smoke", dest="smoke", action="store_true",
                    default=True, help="reduced model geometry (default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="paper-size model geometry")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="offered load (requests/s) of the Poisson "
                         "arrival process")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--mode", default="both",
                    choices=("sync", "async", "both"))
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="admission deadline for async requests; "
                         "expired requests resolve as explicit timeouts")
    ap.add_argument("--seed", type=int, default=0,
                    help="arrival-process seed (sync and async replay "
                         "the same schedule)")
    ap.add_argument("--device", default="cuda")
    obs.add_metrics_flag(ap, str(obs.ARTIFACT_DIR / "loadgen.jsonl"))
    obs.add_server_flag(ap)
    ap.add_argument("--trace", nargs="?",
                    const=str(obs.ARTIFACT_DIR / "loadgen.trace.json"),
                    default=None, metavar="PATH",
                    help="export the span ring as a Chrome trace on exit")
    args = ap.parse_args(argv)

    from repro_torch.deploy import (
        SNNEngineConfig, SNNServeEngine, deploy, deploy_config,
    )
    from repro_torch.device import resolve_device
    from repro_torch.models import snn_cnn
    from repro_torch.serve_async import (
        AsyncEngineConfig, AsyncSNNServeEngine,
    )

    device = resolve_device(args.device)
    metrics_on = bool(args.metrics or args.trace
                      or args.metrics_port is not None)
    registry = obs.enable_default() if metrics_on else None

    cfg = deploy_config(args.model, args.bits, smoke=args.smoke)
    params = snn_cnn.init(0, cfg, device=device)
    model = deploy(params, cfg, device=device)
    rng = np.random.default_rng(args.seed)
    images = rng.random((8, cfg.img_size, cfg.img_size,
                         cfg.in_channels)).astype(np.float32)
    schedule = poisson_schedule(args.rate, args.requests, seed=args.seed)
    print(f"open-loop: {args.requests} arrivals at {args.rate:.1f} rps "
          f"(span {float(schedule[-1]):.2f}s), {cfg.model} W{args.bits} "
          f"on {device}")

    reports = []
    if args.mode in ("sync", "both"):
        eng = SNNServeEngine(model, SNNEngineConfig(max_batch=args.max_batch),
                             device=device)
        eng.warmup()
        rep = run_open_loop_sync(eng, images, schedule)
        eng.close()
        reports.append(rep)
        print(rep.summary())
    if args.mode in ("async", "both"):
        eng = SNNServeEngine(model, SNNEngineConfig(max_batch=args.max_batch),
                             device=device)
        server = None
        aeng = AsyncSNNServeEngine(
            eng, AsyncEngineConfig(workers=args.workers,
                                   default_deadline_ms=args.deadline_ms))
        if args.metrics_port is not None:
            server = obs.ObsServer(registry, port=args.metrics_port,
                                   health_fn=aeng.health)
            print(f"[obs] http://127.0.0.1:{server.start()}/metrics")
        try:
            aeng.warmup()
            aeng.start()
            rep = run_open_loop_async(aeng, images, schedule,
                                      deadline_ms=args.deadline_ms)
        finally:
            aeng.close()
            if server is not None:
                server.stop()
        reports.append(rep)
        print(rep.summary())
    if len(reports) == 2:
        dq = reports[0].queue_avg_ms - reports[1].queue_avg_ms
        print(f"async queue_avg is {dq:+.1f}ms vs sync at "
              f"{reports[0].offered_rps:.1f} rps offered")

    meta = {"entry": "loadgen", "model": args.model, "bits": args.bits,
            "device": str(device)}
    if args.metrics:
        out = obs.write_jsonl(registry, args.metrics, meta=meta)
        print(f"[obs] metrics written to {out}")
    if args.trace:
        out = obs.export_chrome_trace(registry, args.trace, meta=meta)
        print(f"[obs] Chrome trace written to {out}")
    return reports


if __name__ == "__main__":
    main()
