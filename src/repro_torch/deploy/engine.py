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

Not ported yet: the metrics registry and spans, the watchdog, and
``data_parallel`` (which raises).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

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


@dataclasses.dataclass
class SNNEngineConfig:
    max_batch: int = 8
    # batch-size buckets; () = powers of two up to max_batch.  A partial
    # microbatch pads up to the next bucket.
    buckets: Tuple[int, ...] = ()
    # data-parallel serving is not ported yet (raises)
    data_parallel: bool = False

    def resolved_buckets(self) -> Tuple[int, ...]:
        bks = self.buckets
        if not bks:
            bks, b = [], 1
            while b < self.max_batch:
                bks.append(b)
                b *= 2
            bks.append(self.max_batch)
        return tuple(sorted(set(bks)))


class SNNServeEngine:
    """Micro-batching serve loop over a packed SNN on one device.

    ``model`` is moved to ``device`` (default ``"cuda"``; raises without
    a card unless ``device="cpu"``)."""

    def __init__(self, model: DeployedModel, ecfg: SNNEngineConfig,
                 device="cuda"):
        cfg = model.cfg
        if not cfg.int_path:
            raise ValueError("SNNServeEngine serves the packed integer "
                             "path (cfg needs int_deploy + quantized)")
        if ecfg.data_parallel:
            raise NotImplementedError("data_parallel serving is not yet "
                                      "ported to repro_torch")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.ecfg = ecfg
        self.cfg = cfg
        self.queue: deque = deque()
        self.done: Dict[int, SNNRequest] = {}
        self._closed = False
        self.buckets = ecfg.resolved_buckets()
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

    # -- warmup ----------------------------------------------------------------

    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model.apply(images)

    def _ensure_warm(self, bucket: int) -> None:
        if bucket in self._warm:
            return
        cfg = self.cfg
        x = torch.zeros((bucket, cfg.img_size, cfg.img_size,
                         cfg.in_channels), dtype=torch.float32,
                        device=self.device)
        self._forward(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm.add(bucket)
        self.compile_count += 1

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

    # -- main loop -------------------------------------------------------------

    def begin_step(self, batch: List[SNNRequest],
                   bucket: Optional[int] = None) -> InflightStep:
        """Dispatch one formed microbatch without waiting for its result.
        ``batch`` requests must already carry ``queue_s`` and ``_t0``."""
        n = len(batch)
        if n == 0:
            raise ValueError("begin_step needs a non-empty batch")
        if bucket is None:
            bucket = self.bucket_for(n)
        self._ensure_warm(bucket)
        cfg = self.cfg
        images = np.zeros((bucket, cfg.img_size, cfg.img_size,
                           cfg.in_channels), np.float32)
        for i, req in enumerate(batch):
            images[i] = req.image
        t0 = time.perf_counter()
        x = torch.from_numpy(images).to(self.device)
        logits = self._forward(x)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return InflightStep(batch=batch, bucket=bucket, n=n, logits=logits,
                            done=done, t0=t0)

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
        self.per_bucket[bucket] = self.per_bucket.get(bucket, 0) + 1
        self.total_batches += 1
        self.total_compute_s += dt
        self.total_padded_slots += bucket - n
        self.total_slots += bucket
        now = time.perf_counter()
        for i, req in enumerate(st.batch):
            req.image = None
            req.logits = logits[i]
            req.pred = int(np.argmax(logits[i]))
            req.compute_s = dt
            req.latency_s = now - req._t0
            self.total_requests += 1
            self.total_latency_s += req.latency_s
            self.total_queue_s += req.queue_s
            self.total_request_compute_s += dt
            self.max_latency_s = max(self.max_latency_s, req.latency_s)
            if sink is None:
                self.done[req.uid] = req
            else:
                sink(req)
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

    def close(self, drain: bool = True) -> dict:
        """Flush the queue (``drain=True``) or abandon it, then refuse new
        requests.  Idempotent; returns the final :meth:`stats`."""
        if not self._closed:
            if drain:
                while self.queue:
                    self.step()
            else:
                self.queue.clear()
            self._closed = True
        return self.stats()

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
