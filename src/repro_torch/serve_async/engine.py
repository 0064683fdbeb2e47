"""Asynchronous continuous-batching front-end over ``SNNServeEngine``.

Port of ``repro.serve_async.engine`` over the port's engine
(``repro_torch.deploy.engine``): the same scheduling, deadlines, drain,
spans and instruments.

The synchronous engine's ``step()`` loop is batch-formation-bound: a
request that arrives while a rollout is on the device waits for the
rollout to drain, for the host to form the next batch, and for the
transfer — all serialized on one thread.  This tier splits those onto
a request path and a worker path:

  * ``submit(image)`` is **emplace-on-arrival**: the request is
    validated against the served model, stamped, queued, and its
    :class:`~repro_torch.serve_async.futures.SNNFuture` returned — all
    on the caller's thread, waking an idle worker immediately.
  * Each **worker thread** drives the engine's slot-level hooks
    (``begin_step`` / ``finish_step``) with a short in-flight pipeline:
    while rollout k runs its T timesteps on the device, the worker
    seats newly arrived requests into slots freed by rollout k-1,
    builds and DISPATCHES rollout k+1 (CUDA launches return before the
    device finishes — the host->device transfer and launches of k+1
    queue behind rollout k's compute on the device), and only then
    blocks on rollout k (the CUDA event ``begin_step`` recorded).
    Slots recycle at rollout boundaries — with a
    layer-major full-T datapath the rollout is the atomic scheduling
    quantum, so "admitting into a partially-drained rollout" means a
    new arrival is transferred and queued behind the in-flight rollout
    mid-T-loop instead of waiting for it to drain; per-timestep
    preemption would need state-carrying kernels.
  * **Deadlines** are admission deadlines: an entry whose deadline
    passes before a worker seats it resolves as an explicit ``timeout``
    result (span ``evict``) — never a hung future.  Once seated, a
    request always completes its rollout.
  * ``close(drain=True)`` is **graceful drain**: admission stops
    (queue closes), workers flush everything queued plus their
    pipelines, then join.  ``drain=False`` cancels the backlog with
    explicit ``cancelled`` results.
  * **Failures** are per rollout: a ``begin_step`` or ``finish_step``
    that raises resolves that rollout's requests with an explicit
    ``error`` result (the exception in ``detail``; counter
    ``snn_serve_errors_total``, span ``error``) and frees their slots;
    the worker goes on serving.  ``repro``'s tier has no handler there:
    the worker thread dies and its futures never resolve.

Bit-exactness: the tier runs the SAME packaged forward as the
synchronous engine and the forward is batch-row independent, so a
request's logits are identical whichever tier (and whichever cohort)
served it at one bucket size — the parity test pins this per request
with the bucket pinned (the float stem's convolution may pick another
algorithm at another batch size).

Device and threads: every worker enqueues on its thread's current
stream (the device's default stream unless the caller set another), and
the kernel wrappers release the interpreter lock inside their launches,
so two workers really do enqueue at once.  Build the kernels and warm
every bucket (``warmup()``) before ``start()``.

Observability rides the engine's registry: shared spans (``enqueue``,
``admit``, ``step``, ``drain``) come from the engine hooks; the tier
adds ``evict`` / ``recycle`` spans, the ``snn_serve_slot_occupancy``
and ``snn_serve_inflight`` gauges, and submit/evict/cancel counters.
The ``queue_growth`` watchdog rule works unchanged — the tier keeps
``snn_serve_queue_depth`` current from ITS queue.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.deploy.engine import (
    InflightStep,
    SNNRequest,
    SNNServeEngine,
)
from repro_torch.device import resolve_device
from repro_torch.serve_async.futures import (
    STATUS_CANCELLED,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_TIMEOUT,
    AsyncResult,
    SNNFuture,
)
from repro_torch.serve_async.queue import (
    Closed,
    Full,
    QueueEntry,
    RequestQueue,
)
from repro_torch.serve_async.slots import SlotManager


@dataclasses.dataclass
class AsyncEngineConfig:
    #: worker threads driving the engine hooks.  One saturates a single
    #: device; more help when per-request host work (image fill, drain
    #: bookkeeping) is the bottleneck.
    workers: int = 1
    #: dispatched-but-uncollected rollouts each worker keeps in flight
    #: (2 = classic double buffering: form/transfer k+1 under k).
    max_inflight: int = 2
    #: bounded admission; 0 = unbounded.  A full queue resolves the
    #: future as ``cancelled`` (detail "queue full") at submit time.
    queue_limit: int = 0
    #: admission deadline applied when ``submit`` gets none; None = no
    #: deadline.
    default_deadline_ms: Optional[float] = None
    #: how long an idle worker sleeps in ``take`` before rechecking
    #: shutdown (arrivals interrupt the wait immediately regardless).
    idle_wait_s: float = 0.05
    #: per-request latencies retained for the percentile estimates in
    #: ``stats()`` (futures carry exact per-request numbers; running
    #: totals in the engine stay exact regardless).
    reservoir: int = 8192


class AsyncSNNServeEngine:
    """Continuous-batching async tier (see module docstring).

    Composes rather than subclasses: ``engine`` is a fully-constructed
    synchronous :class:`SNNServeEngine` whose compile cache, accounting
    totals, instruments, and watchdog the tier reuses — the datapath
    and its contracts stay fixed while the scheduling layer grows.
    """

    def __init__(self, engine: SNNServeEngine,
                 acfg: Optional[AsyncEngineConfig] = None):
        # the engine's device must still be usable here: no card, no
        # tier (the engine itself ran on the CPU only if asked to)
        resolve_device(engine.device)
        self.engine = engine
        self.acfg = acfg or AsyncEngineConfig()
        if self.acfg.workers < 1:
            raise ValueError("need at least one worker")
        if self.acfg.max_inflight < 1:
            raise ValueError("need at least one in-flight rollout")
        self.obs = engine.obs
        self.queue = RequestQueue(maxsize=self.acfg.queue_limit)
        cap_per_worker = min(engine.ecfg.max_batch, engine.buckets[-1])
        self._cohort_cap = cap_per_worker
        self.slots = SlotManager(
            cap_per_worker * self.acfg.max_inflight * self.acfg.workers)

        self._lock = threading.Lock()     # uid counter, pending, totals
        self._uid = 0
        self._pending: Dict[int, QueueEntry] = {}
        self._reservoir: deque = deque(maxlen=self.acfg.reservoir)
        self.submitted = 0
        self.completed = 0
        self.timeouts = 0
        self.cancelled = 0
        self.errors = 0

        self._threads: List[threading.Thread] = []
        self._closed = False

        m = self.obs
        self._m_queue_depth = m.gauge("snn_serve_queue_depth",
                                      "requests waiting for a batch")
        self._m_slot_occ = m.gauge("snn_serve_slot_occupancy",
                                   "held slots / slot capacity")
        self._m_inflight = m.gauge("snn_serve_inflight",
                                   "dispatched, uncollected rollouts")
        self._m_submitted = m.counter("snn_serve_submitted_total",
                                      "requests accepted at submit")
        self._m_evictions = m.counter("snn_serve_evictions_total",
                                      "deadline-expired requests evicted")
        self._m_cancelled = m.counter("snn_serve_cancelled_total",
                                      "requests cancelled at shutdown or "
                                      "admission")
        self._m_errors = m.counter("snn_serve_errors_total",
                                   "requests failed by a raising rollout")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AsyncSNNServeEngine":
        """Spawn the worker threads (idempotent).  Call ``warmup()``
        first if compile time must stay off the serving path."""
        if self._threads:
            return self
        for wid in range(self.acfg.workers):
            t = threading.Thread(target=self._worker, args=(wid,),
                                 name=f"snn-serve-worker-{wid}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def warmup(self) -> int:
        return self.engine.warmup()

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> dict:
        """Graceful shutdown: stop admission, then either flush the
        backlog through the engine (``drain=True``) or resolve it with
        explicit ``cancelled`` results.  Joins the workers.  Idempotent;
        returns the final :meth:`stats`.  (A second call returns the
        stats outside ``_lock``: :meth:`stats` takes that lock, which is
        not reentrant.)"""
        with self._lock:
            closed_before = self._closed
            self._closed = True
        if closed_before:
            return self.stats()
        if not drain:
            for entry in self.queue.drain_all():
                self._cancel(entry, "engine shut down without draining")
        self.queue.close()
        for t in self._threads:
            t.join(timeout=timeout)
        # never-started (or join-timed-out) workers leave a backlog; a
        # graceful close still owes those requests an answer
        leftovers = self.queue.drain_all()
        if leftovers and drain and not any(t.is_alive()
                                           for t in self._threads):
            self._serve_inline(leftovers)
        else:
            for entry in leftovers:
                self._cancel(entry, "engine closed before admission")
        self._m_queue_depth.set(0)
        self.engine.close(drain=True)
        return self.stats()

    def __enter__(self) -> "AsyncSNNServeEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # -- request path --------------------------------------------------------

    def submit(self, image: np.ndarray,
               deadline_ms: Optional[float] = None) -> SNNFuture:
        """Emplace-on-arrival admission: validate, stamp, queue, return
        the future — all on the caller's thread.  Thread-safe; uids are
        assigned internally and returned on the future."""
        if self._closed:
            raise Closed("async engine is closed")
        with self._lock:
            uid = self._uid
            self._uid += 1
            self.submitted += 1
        req = SNNRequest(uid=uid, image=np.asarray(image, np.float32))
        self.engine.validate_request(req)
        fut = SNNFuture(uid)
        req._t0 = time.perf_counter()
        if deadline_ms is None:
            deadline_ms = self.acfg.default_deadline_ms
        deadline = None if deadline_ms is None \
            else req._t0 + deadline_ms / 1e3
        entry = QueueEntry(req=req, future=fut, deadline=deadline)
        try:
            self.queue.put(entry)
        except (Full, Closed) as e:
            self._cancel(entry, str(e))
            return fut
        self._m_submitted.inc()
        depth = len(self.queue)
        self._m_queue_depth.set(depth)
        self.obs.event("enqueue", uid=uid, queue_depth=depth)
        return fut

    # -- worker path ---------------------------------------------------------

    def _worker(self, wid: int) -> None:
        inflight: deque = deque()
        while True:
            want = min(self._cohort_cap, self.slots.free_count())
            ready: List[QueueEntry] = []
            if want > 0:
                # poll when a rollout is in flight (its compute is the
                # batching window); otherwise sleep until an arrival or
                # shutdown wakes us
                timeout = 0.0 if inflight else self.acfg.idle_wait_s
                ready, expired = self.queue.take(want, timeout=timeout)
                for entry in expired:
                    self._evict(entry)
            if ready:
                st = self._dispatch(ready)
                if st is not None:
                    inflight.append(st)
                    self._m_inflight.set(len(inflight))
                    if len(inflight) < self.acfg.max_inflight:
                        continue        # keep the transfer pipe full
            if inflight:
                self._collect(inflight.popleft())
                self._m_inflight.set(len(inflight))
                continue
            if self.queue.closed and len(self.queue) == 0:
                return
            if want == 0:
                # every slot is held by a peer's in-flight rollout;
                # yield until one drains
                time.sleep(0.0005)

    def _dispatch(self, ready: List[QueueEntry]
                  ) -> Optional[InflightStep]:
        t_admit = time.perf_counter()
        batch: List[SNNRequest] = []
        for entry in ready:
            slot = self.slots.acquire(entry.req.uid)
            if slot is None:            # lost a race to a peer worker
                self.queue.requeue(entry)
                continue
            entry.slot = slot
            entry.req.queue_s = t_admit - entry.req._t0
            with self._lock:
                self._pending[entry.req.uid] = entry
            batch.append(entry.req)
        self._m_queue_depth.set(len(self.queue))
        self._m_slot_occ.set(self.slots.occupancy())
        if not batch:                   # whole cohort lost the race
            return None
        try:
            return self.engine.begin_step(batch,
                                          queue_depth=len(self.queue))
        except Exception as exc:
            self._fail(batch, exc)
            return None

    def _collect(self, st: InflightStep) -> None:
        try:
            self.engine.finish_step(st, sink=self._sink)
        except Exception as exc:
            self._fail(st.batch, exc)

    def _fail(self, batch: List[SNNRequest], exc: Exception) -> None:
        """Resolve every request of a raising rollout that the sink has
        not resolved yet as ``error`` and free its slot."""
        detail = f"{type(exc).__name__}: {exc}"
        with self._lock:
            entries = [e for e in (self._pending.pop(r.uid, None)
                                   for r in batch) if e is not None]
            self.errors += len(entries)
        self.obs.event("error", n=len(entries), detail=detail)
        for entry in entries:
            self._m_errors.inc()
            self.slots.release(entry.slot)
            entry.future.resolve(AsyncResult(
                uid=entry.req.uid, status=STATUS_ERROR,
                latency_s=time.perf_counter() - entry.req._t0,
                queue_s=entry.req.queue_s, detail=detail))
        self._m_slot_occ.set(self.slots.occupancy())

    def _sink(self, req: SNNRequest) -> None:
        """finish_step's per-request drain hook: resolve the future and
        recycle the slot — results never pile up in ``engine.done``."""
        with self._lock:
            entry = self._pending.pop(req.uid)
            self.completed += 1
            self._reservoir.append((req.latency_s, req.queue_s))
        uid, held_s = self.slots.release(entry.slot)
        self.obs.event("recycle", slot=entry.slot, uid=uid,
                       held_us=held_s * 1e6)
        self._m_slot_occ.set(self.slots.occupancy())
        entry.future.resolve(AsyncResult(
            uid=req.uid, status=STATUS_OK, logits=req.logits,
            pred=req.pred, latency_s=req.latency_s, queue_s=req.queue_s,
            compute_s=req.compute_s))

    def _evict(self, entry: QueueEntry) -> None:
        waited = time.perf_counter() - entry.req._t0
        self._m_evictions.inc()
        self.obs.event("evict", uid=entry.req.uid,
                       waited_us=waited * 1e6)
        with self._lock:
            self.timeouts += 1
        entry.future.resolve(AsyncResult(
            uid=entry.req.uid, status=STATUS_TIMEOUT, latency_s=waited,
            queue_s=waited,
            detail=f"admission deadline expired after {waited * 1e3:.1f}ms"))

    def _cancel(self, entry: QueueEntry, detail: str) -> None:
        self._m_cancelled.inc()
        with self._lock:
            self.cancelled += 1
        entry.future.resolve(AsyncResult(
            uid=entry.req.uid, status=STATUS_CANCELLED, detail=detail))

    def _serve_inline(self, entries: List[QueueEntry]) -> None:
        """Drain a leftover backlog on the closing thread (workers never
        started): cohort at a time through the same hooks."""
        now = time.perf_counter()
        live: List[QueueEntry] = []
        for entry in entries:
            if entry.expired(now):
                self._evict(entry)
            else:
                live.append(entry)
        for i in range(0, len(live), self._cohort_cap):
            st = self._dispatch(live[i:i + self._cohort_cap])
            if st is not None:
                self._collect(st)

    # -- introspection -------------------------------------------------------

    def stats(self, wall_s: Optional[float] = None) -> dict:
        """Engine running totals + async-tier accounting.  Latency
        percentiles come from the tier's bounded reservoir (async
        results bypass ``engine.done``); ``latency_p99_ms`` joins the
        p50/p95 pair because tail latency under offered load is the
        number the open-loop benchmark exists to watch."""
        s = self.engine.stats(wall_s=wall_s)
        with self._lock:
            pairs = list(self._reservoir)
            submitted, completed = self.submitted, self.completed
            timeouts, cancelled = self.timeouts, self.cancelled
            errors = self.errors
        lats = sorted(l for l, _ in pairs)
        queues = sorted(q for _, q in pairs)
        pctl = self.engine._pctl
        s["latency_p50_ms"] = 1e3 * pctl(lats, 0.5)
        s["latency_p95_ms"] = 1e3 * pctl(lats, 0.95)
        s["latency_p99_ms"] = 1e3 * pctl(lats, 0.99)
        s["queue_p95_ms"] = 1e3 * pctl(queues, 0.95)
        s["async"] = {
            "workers": self.acfg.workers,
            "max_inflight": self.acfg.max_inflight,
            "queue_depth": len(self.queue),
            "slot_capacity": self.slots.capacity,
            "slots_held": self.slots.occupied(),
            "slots_recycled": self.slots.total_recycled,
            "submitted": submitted,
            "completed": completed,
            "timeouts": timeouts,
            "cancelled": cancelled,
            "errors": errors,
            "closed": self._closed,
        }
        return s

    def health(self) -> dict:
        """/healthz payload: the engine section plus the tier's queue /
        slot / worker state (``ObsServer(health_fn=async_engine.health)``)."""
        body = self.engine.health()
        body["async"] = {
            "queue_depth": len(self.queue),
            "queue_closed": self.queue.closed,
            "slots_held": self.slots.occupied(),
            "slot_capacity": self.slots.capacity,
            "workers_alive": sum(t.is_alive() for t in self._threads),
            "submitted": self.submitted,
            "completed": self.completed,
            "timeouts": self.timeouts,
            "cancelled": self.cancelled,
            "errors": self.errors,
        }
        return body

    def attach_watchdog(self, watchdog) -> None:
        self.engine.attach_watchdog(watchdog)

    def graph_summary(self) -> str:
        return self.engine.graph_summary()
