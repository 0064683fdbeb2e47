"""Batched serve engine for packed spiking models.

Port of ``repro.deploy.engine.SNNServeEngine``.  Requests are single
inferences (one image in, one logit vector out after T timesteps).  The
engine pulls up to ``max_batch`` queued requests per step, pads them to
the smallest configured batch bucket, and runs the packaged forward of
the :class:`DeployedModel` on the engine's device.

PyTorch runs eagerly, so nothing is compiled per bucket.
``compile_count`` keeps the JAX engine's contract all the same: it counts
buckets warmed (one forward each, in ``warmup()`` or on first use), so
after warmup it stays at the bucket count.

``step()`` is ``begin_step`` (stage the padded batch, enqueue the forward
on the device without waiting, record a CUDA event) followed by
``finish_step`` (wait on that event, copy the logits to the host,
account).  Every request records its latency split: ``queue_s`` (enqueue
-> bucket admit) and ``compute_s`` (the batched forward's share).

The lifecycle is the JAX engine's: ``pop_result`` drains ``done``
(counts, throughput and avg/max latency survive it, from running
totals), ``close`` flushes or abandons the queue, the engine is a
context manager that drains on a clean exit only, and ``health()`` is
the liveness payload.

``begin_step``/``finish_step`` may be driven from the async tier's
worker threads (``repro_torch.serve_async``): the bucket warmup and the
running totals each take a lock.  Each worker enqueues on its thread's
current stream (the device's default stream unless the caller set
another), and ``finish_step`` waits on the event ``begin_step`` recorded
there.

Observability: the engine binds the JAX engine's instruments, by the
same names, from a :class:`repro_torch.obs.MetricsRegistry` (the process
default unless one is passed): request/batch/compile-hit/miss counters,
queue-depth / batch-occupancy / padding-waste gauges, queue/compute/
latency histograms, and the ``compile``, ``enqueue``, ``admit``,
``step``, ``drain`` and ``close`` span events.  With the default
registry disabled (the default) every instrument is a shared no-op.
``attach_watchdog`` adds an SLO watchdog checked once a microbatch and
reported by ``health()["watchdog"]``.

``data_parallel=True`` is JAX's ``shard_map`` over the local devices'
``data`` axis, done by hand: the engine keeps one replica of the package
on every local device of its device's type (:func:`local_devices`),
rounds every bucket up to a multiple of their count, splits each padded
bucket into equal slices, runs slice ``i`` on device ``i``'s kernels and
concatenates the logits in order on the engine's device.  On a host
with one card that is one replica, the engine's own forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _tprof
from torch.profiler import record_function

from repro_torch import obs
from repro_torch.deploy.package import DeployedModel
from repro_torch.device import resolve_device


@dataclasses.dataclass
class SNNRequest:
    uid: int
    image: Optional[np.ndarray]      # (H, W, C) float in [0, 1]; dropped
                                     # (set to None) once served
    logits: Optional[np.ndarray] = None
    pred: Optional[int] = None
    latency_s: float = 0.0           # enqueue -> result
    queue_s: float = 0.0             # enqueue -> bucket admit
    compute_s: float = 0.0           # the batched forward's share


@dataclasses.dataclass
class InflightStep:
    """One dispatched-but-not-collected microbatch.  ``logits`` is the
    device tensor of the enqueued forward and ``done`` the CUDA event
    recorded after it (None on the CPU, where the forward is synchronous)."""

    batch: List[SNNRequest]
    bucket: int
    n: int
    logits: torch.Tensor
    done: Optional[torch.cuda.Event]
    t0: float                       # perf_counter at dispatch
    pad_frac: float


@dataclasses.dataclass
class SNNEngineConfig:
    max_batch: int = 8
    # batch-size buckets; () = powers of two up to max_batch.  A partial
    # microbatch pads up to the next bucket.
    buckets: Tuple[int, ...] = ()
    # one package replica per local device, the batch split over them
    data_parallel: bool = False

    def resolved_buckets(self, n_dev: int = 1) -> Tuple[int, ...]:
        bks = self.buckets
        if not bks:
            bks, b = [], 1
            while b < self.max_batch:
                bks.append(b)
                b *= 2
            bks.append(self.max_batch)
        up = lambda b: -(-b // n_dev) * n_dev  # ceil to a device multiple
        return tuple(sorted({up(b) for b in bks}))


def local_devices(device: torch.device) -> List[torch.device]:
    """Every local device of ``device``'s type: the replicas of a
    data-parallel engine (one for the CPU)."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


class SNNServeEngine:
    """Micro-batching serve loop over a packed SNN on one device.

    ``model`` is moved to ``device`` (default ``"cuda"``; raises without
    a card unless ``device="cpu"``).  ``registry`` is the metrics
    registry the instruments bind to (default: the process default)."""

    def __init__(self, model: DeployedModel, ecfg: SNNEngineConfig,
                 device="cuda",
                 registry: Optional[obs.MetricsRegistry] = None):
        cfg = model.cfg
        if not cfg.int_path:
            raise ValueError("SNNServeEngine serves the packed integer "
                             "path (cfg needs int_deploy + quantized)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.devices = (local_devices(self.device) if ecfg.data_parallel
                        else [self.device])
        self._replicas = ([self.model] if len(self.devices) == 1
                          else [model.to(d) for d in self.devices])
        self.ecfg = ecfg
        self.cfg = cfg
        self.queue: deque = deque()
        self.done: Dict[int, SNNRequest] = {}
        self._closed = False
        # begin_step/finish_step may run on the async tier's worker
        # threads: the warm set and the running totals each take a lock
        self._compile_lock = threading.Lock()
        self._acct_lock = threading.Lock()
        self.buckets = ecfg.resolved_buckets(len(self.devices))
        self._warm: set = set()
        self.compile_count = 0
        # O(1) accounting (a long-lived server keeps no per-batch records)
        self.per_bucket: Dict[int, int] = {}
        self.total_batches = 0
        self.total_compute_s = 0.0
        self.total_padded_slots = 0
        self.total_slots = 0
        self.total_requests = 0
        self.total_latency_s = 0.0
        self.total_queue_s = 0.0
        self.total_request_compute_s = 0.0
        self.max_latency_s = 0.0

        # instruments bind once, here: with a disabled registry every
        # handle is the shared no-op
        self.obs = registry if registry is not None else \
            obs.default_registry()
        m = self.obs
        self._m_requests = m.counter("snn_serve_requests_total",
                                     "requests completed")
        self._m_batches = m.counter("snn_serve_batches_total",
                                    "microbatches served")
        self._m_compile_miss = m.counter("snn_serve_compile_total",
                                         "bucket executable builds",
                                         labels={"result": "miss"})
        self._m_compile_hit = m.counter("snn_serve_compile_total",
                                        "bucket executable cache hits",
                                        labels={"result": "hit"})
        self._m_queue_depth = m.gauge("snn_serve_queue_depth",
                                      "requests waiting for a batch")
        self._m_occupancy = m.gauge("snn_serve_batch_occupancy",
                                    "real requests / bucket slots, last "
                                    "batch")
        self._m_pad_waste = m.gauge("snn_serve_padding_waste",
                                    "padded slots / bucket slots, last "
                                    "batch")
        self._m_queue_us = m.histogram("snn_serve_queue_us",
                                       obs.LATENCY_EDGES_US,
                                       "enqueue -> bucket admit")
        self._m_compute_us = m.histogram("snn_serve_compute_us",
                                         obs.LATENCY_EDGES_US,
                                         "batched forward share")
        self._m_latency_us = m.histogram("snn_serve_latency_us",
                                         obs.LATENCY_EDGES_US,
                                         "enqueue -> drain")
        self._watchdog = None

    def attach_watchdog(self, watchdog) -> None:
        """Attach an :class:`repro_torch.obs.Watchdog`: ``finish_step``
        evaluates its rules once per microbatch and ``health()`` folds
        its state in."""
        self._watchdog = watchdog

    # -- warmup ----------------------------------------------------------------

    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if len(self._replicas) == 1:
                return self.model.apply(images)
            outs = []
            for rep, dev, x in zip(self._replicas, self.devices,
                                   images.chunk(len(self._replicas))):
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    y = rep.apply(x.to(dev))
                outs.append(y.to(self.device))
            return torch.cat(outs)

    def _ensure_warm(self, bucket: int) -> None:
        """The JAX engine's compile-cache step: the first use of a bucket
        runs one forward (counted as a compile miss, with a ``compile``
        span), every later use is a hit."""
        if bucket in self._warm:
            self._m_compile_hit.inc()
            return
        with self._compile_lock:     # concurrent workers warm once
            if bucket in self._warm:
                self._m_compile_hit.inc()
                return
            self._m_compile_miss.inc()
            t0 = time.perf_counter()
            cfg = self.cfg
            x = torch.zeros((bucket, cfg.img_size, cfg.img_size,
                             cfg.in_channels), dtype=torch.float32,
                            device=self.device)
            self._forward(x)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._warm.add(bucket)
            self.compile_count += 1
            self.obs.event("compile", bucket=bucket, result="miss",
                           compile_us=(time.perf_counter() - t0) * 1e6)

    def warmup(self) -> int:
        """Run one forward per bucket (builds the kernels, allocates).
        Returns the number of buckets warmed."""
        for b in self.buckets:
            self._ensure_warm(b)
        return len(self._warm)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # -- request plumbing ------------------------------------------------------

    def validate_request(self, req: SNNRequest) -> None:
        """Reject an image that does not match the served geometry before
        it can poison a formed microbatch."""
        cfg = self.cfg
        want = (cfg.img_size, cfg.img_size, cfg.in_channels)
        if tuple(req.image.shape) != want:
            raise ValueError(f"request {req.uid}: image shape "
                             f"{tuple(req.image.shape)} != model {want}")

    def add_request(self, req: SNNRequest) -> None:
        if self._closed:
            raise RuntimeError("engine is closed: close() drained the "
                               "queue; build a new engine")
        self.validate_request(req)
        req._t0 = time.perf_counter()
        self.queue.append(req)
        self._m_queue_depth.set(len(self.queue))
        self.obs.event("enqueue", uid=req.uid, queue_depth=len(self.queue))

    # -- main loop -------------------------------------------------------------

    def begin_step(self, batch: List[SNNRequest],
                   bucket: Optional[int] = None,
                   queue_depth: Optional[int] = None) -> InflightStep:
        """Dispatch one formed microbatch without waiting for its result.
        ``batch`` requests must already carry ``queue_s`` and ``_t0``;
        ``queue_depth`` is what the ``admit`` span reports as still
        waiting (default: the engine's own queue; the async tier passes
        its queue's depth)."""
        n = len(batch)
        if n == 0:
            raise ValueError("begin_step needs a non-empty batch")
        if bucket is None:
            bucket = self.bucket_for(n)
        if queue_depth is None:
            queue_depth = len(self.queue)
        pad_frac = (bucket - n) / bucket
        self._m_occupancy.set(n / bucket)
        self._m_pad_waste.set(pad_frac)
        self.obs.event("admit", n=n, bucket=bucket, pad_frac=pad_frac,
                       queue_depth=queue_depth)
        self._ensure_warm(bucket)
        cfg = self.cfg
        images = np.zeros((bucket, cfg.img_size, cfg.img_size,
                           cfg.in_channels), np.float32)
        for i, req in enumerate(batch):
            images[i] = req.image
        t0 = time.perf_counter()
        x = torch.from_numpy(images).to(self.device)
        # names this dispatch in --profile traces (snn_serve_step/b<bucket>);
        # a record_function costs ~15 us of host time, so it is entered
        # only while a profiler runs (the flag is process-wide: the async
        # tier's workers see it too)
        with (record_function(f"snn_serve_step/b{bucket}")
              if _tprof._is_profiler_enabled else contextlib.nullcontext()):
            logits = self._forward(x)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return InflightStep(batch=batch, bucket=bucket, n=n, logits=logits,
                            done=done, t0=t0, pad_frac=pad_frac)

    def finish_step(self, st: InflightStep,
                    sink: Optional[Callable[[SNNRequest], None]] = None
                    ) -> int:
        """Wait for a dispatched microbatch, account it, and hand every
        completed request to ``sink`` (default: the ``done`` dict).
        Returns the number of requests completed."""
        if st.done is not None:
            st.done.synchronize()
        logits = st.logits.cpu().numpy()
        dt = time.perf_counter() - st.t0
        bucket, n = st.bucket, st.n
        self._m_batches.inc()
        self._m_compute_us.observe(dt * 1e6)
        self.obs.event("step", bucket=bucket, n=n, pad_frac=st.pad_frac,
                       compute_us=dt * 1e6)
        now = time.perf_counter()
        latency_s = queue_s = max_latency_s = 0.0
        for i, req in enumerate(st.batch):
            req.image = None
            req.logits = logits[i]
            req.pred = int(np.argmax(logits[i]))
            req.compute_s = dt
            req.latency_s = now - req._t0
            latency_s += req.latency_s
            queue_s += req.queue_s
            max_latency_s = max(max_latency_s, req.latency_s)
        # the totals take the lock once a batch, before any request is
        # handed on: a sink's caller may read them as soon as it resolves
        with self._acct_lock:
            self.per_bucket[bucket] = self.per_bucket.get(bucket, 0) + 1
            self.total_batches += 1
            self.total_compute_s += dt
            self.total_padded_slots += bucket - n
            self.total_slots += bucket
            self.total_requests += n
            self.total_latency_s += latency_s
            self.total_queue_s += queue_s
            self.total_request_compute_s += dt * n
            self.max_latency_s = max(self.max_latency_s, max_latency_s)
        # a disabled registry's instruments and events are no-ops: skip
        # building their arguments (a few microseconds a batch)
        per_request_obs = self.obs.enabled
        for req in st.batch:
            if per_request_obs:
                self._m_requests.inc()
                self._m_queue_us.observe(req.queue_s * 1e6)
                self._m_latency_us.observe(req.latency_s * 1e6)
                self.obs.event("drain", uid=req.uid,
                               queue_us=req.queue_s * 1e6,
                               compute_us=req.compute_s * 1e6,
                               latency_us=req.latency_s * 1e6)
            if sink is None:
                self.done[req.uid] = req
            else:
                sink(req)
        if self._watchdog is not None:
            # after the drain loop: the instruments the rules read hold
            # this microbatch
            self._watchdog.check()
        return n

    def step(self) -> int:
        """Serve one microbatch (up to max_batch queued requests, padded
        to the next bucket).  Returns the number of requests completed."""
        if not self.queue:
            return 0
        batch: List[SNNRequest] = []
        cap = min(self.ecfg.max_batch, self.buckets[-1])
        t_admit = time.perf_counter()
        while self.queue and len(batch) < cap:
            req = self.queue.popleft()
            req.queue_s = t_admit - req._t0
            batch.append(req)
        self._m_queue_depth.set(len(self.queue))
        return self.finish_step(self.begin_step(batch))

    def run_until_done(self, max_steps: int = 10_000) -> dict:
        for _ in range(max_steps):
            if not self.queue:
                break
            self.step()
        if self.queue:
            raise RuntimeError(
                f"run_until_done: {len(self.queue)} requests still queued "
                f"after max_steps={max_steps}; raise max_steps or drain "
                f"with step()")
        return self.stats()

    def pop_result(self, uid: int) -> SNNRequest:
        """Remove and return a completed request.  A long-lived server
        drains ``done`` through here: the engine never evicts on its own.
        Counts, throughput and avg/max latency in :meth:`stats` come from
        running totals and survive draining; only the percentiles are
        limited to the results still held."""
        return self.done.pop(uid)

    def close(self, drain: bool = True) -> dict:
        """Flush the queue (``drain=True``) or abandon it, then refuse new
        requests.  Idempotent; returns the final :meth:`stats`.  As a
        context manager the engine drains on a clean exit and abandons
        the queue when the block raises.  The ``close`` span counts the
        requests drained and the ones abandoned."""
        if self._closed:
            return self.stats()
        drained = stranded = 0
        if drain:
            while self.queue:
                drained += self.step()
        else:
            stranded = len(self.queue)
            self.queue.clear()
        self._closed = True
        self._m_queue_depth.set(0)
        self.obs.event("close", drained=drained, stranded=stranded)
        return self.stats()

    def __enter__(self) -> "SNNServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    def health(self) -> dict:
        """Liveness payload for ``/healthz`` (the JAX engine's keys):
        queue depth, closed flag, results not yet drained, running
        totals, the warmed buckets, the model, and the attached
        watchdog's state."""
        body = {
            "queue_depth": len(self.queue),
            "closed": self._closed,
            "undrained_results": len(self.done),
            "requests_total": self.total_requests,
            "batches_total": self.total_batches,
            "compile_cache": {
                "buckets": [int(b) for b in self.buckets],
                "compiled": sorted(int(b) for b in self._warm),
                "compiles": self.compile_count,
            },
            "model": {
                "name": self.cfg.model, "bits": self.cfg.precision.bits,
                "timesteps": self.cfg.timesteps,
            },
        }
        if self._watchdog is not None:
            body["watchdog"] = self._watchdog.health()
        return body

    def graph_summary(self) -> str:
        """The served model's graph, one line per node, with fusion-group
        membership and each group's shared memory when the cfg asks for
        fusion (those chains run the ``fused_group`` kernel)."""
        from repro_torch.graph import build_graph

        return build_graph(self.cfg).summary()

    # -- accounting ------------------------------------------------------------

    @staticmethod
    def _pctl(vals: List[float], q: float) -> float:
        # nearest-rank percentile: ceil(q n) - 1
        return vals[max(0, math.ceil(q * len(vals)) - 1)] if vals else 0.0

    def stats(self, wall_s: Optional[float] = None) -> dict:
        """Aggregate serving stats (the JAX engine's keys).  Counts,
        throughput and avg/max latency come from running totals; the
        percentiles are over the results still held in ``done``.
        Throughput is requests per second of batched compute unless
        ``wall_s`` is given."""
        lats = sorted(r.latency_s for r in self.done.values())
        queues = sorted(r.queue_s for r in self.done.values())
        wall = wall_s if wall_s is not None else self.total_compute_s
        n = self.total_requests
        return {
            "requests": n,
            "batches": self.total_batches,
            "compiles": self.compile_count,
            "buckets": {str(k): v
                        for k, v in sorted(self.per_bucket.items())},
            "wall_s": wall,
            "images_per_s": n / max(wall, 1e-9),
            "latency_avg_ms": 1e3 * self.total_latency_s / n if n else 0.0,
            "queue_avg_ms": 1e3 * self.total_queue_s / n if n else 0.0,
            "compute_avg_ms":
                1e3 * self.total_request_compute_s / n if n else 0.0,
            "queue_p95_ms": 1e3 * self._pctl(queues, 0.95),
            "latency_p50_ms": 1e3 * self._pctl(lats, 0.5),
            "latency_p95_ms": 1e3 * self._pctl(lats, 0.95),
            "latency_max_ms": 1e3 * self.max_latency_s,
            "padding_waste":
                self.total_padded_slots / max(self.total_slots, 1),
            "packed_mbytes": self.model.nbytes_packed() / 1e6,
            "compression_x": round(self.model.compression_ratio(), 2),
        }
