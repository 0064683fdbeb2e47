"""Thread-safe request queue with emplace-on-arrival and deadlines.

The admission edge of the async tier: producers (any thread) ``put()``
entries, worker threads ``take()`` up to a cohort's worth.  Design
points, in the order they matter:

* **Emplace on arrival** — ``put`` appends under the lock and signals
  the condition variable; an idle worker wakes immediately instead of
  polling, so a request arriving into an empty system reaches the
  device after one scheduling hop (the JetStream ``OfflineInference``
  idiom: the queue IS the handoff, there is no separate batching
  window).
* **Bounded admission** — an optional ``maxsize`` rejects at submit
  time (``Full``) rather than buffering unboundedly; an open-loop
  arrival process that outruns the engine then fails fast instead of
  growing a latency cliff.
* **Deadlines at the edge** — entries carry an absolute monotonic
  deadline; ``take`` splits expired entries out of the cohort so the
  worker can resolve them as explicit timeouts without spending a
  rollout slot on them.
* **Closeable** — ``close()`` wakes every waiter; a closed queue
  rejects new work but still hands out what it holds, which is exactly
  the graceful-drain order (stop admission, then flush).

Port of ``repro.serve_async.queue`` (framework-free; the port's own copy).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

from repro_torch.deploy.engine import SNNRequest
from repro_torch.serve_async.futures import SNNFuture


class Full(RuntimeError):
    """Raised by ``put`` when a bounded queue is at capacity."""


class Closed(RuntimeError):
    """Raised by ``put`` after ``close()`` — admission has stopped."""


@dataclasses.dataclass
class QueueEntry:
    """One queued request: the engine-shaped request, the caller's
    future, and the absolute (perf_counter) deadline, if any."""

    req: SNNRequest
    future: SNNFuture
    deadline: Optional[float] = None     # absolute, monotonic seconds
    slot: Optional[int] = None           # filled at admission

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline


class RequestQueue:
    """FIFO of :class:`QueueEntry` (see module docstring)."""

    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self._dq: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)

    @property
    def closed(self) -> bool:
        return self._closed

    def put(self, entry: QueueEntry) -> None:
        with self._cv:
            if self._closed:
                raise Closed("request queue is closed")
            if self.maxsize and len(self._dq) >= self.maxsize:
                raise Full(f"request queue at capacity ({self.maxsize})")
            self._dq.append(entry)
            self._cv.notify()

    def take(self, max_n: int, timeout: Optional[float] = None
             ) -> Tuple[List[QueueEntry], List[QueueEntry]]:
        """Pop up to ``max_n`` entries, waiting up to ``timeout``
        seconds for the FIRST one (``timeout=0`` polls; ``None`` waits
        until work arrives or the queue closes).  Returns
        ``(ready, expired)`` — entries whose deadline has already passed
        are split out so the caller resolves them as timeouts instead of
        admitting them."""
        with self._cv:
            if not self._dq and not self._closed and timeout != 0:
                self._cv.wait_for(lambda: self._dq or self._closed,
                                  timeout=timeout)
            now = time.perf_counter()
            ready: List[QueueEntry] = []
            expired: List[QueueEntry] = []
            while self._dq and len(ready) < max_n:
                entry = self._dq.popleft()
                (expired if entry.expired(now) else ready).append(entry)
            return ready, expired

    def requeue(self, entry: QueueEntry) -> None:
        """Put an already-admitted entry back at the FRONT (a worker
        lost a slot race).  Allowed even on a closed queue — the entry
        was accepted before admission stopped and is still owed a
        result."""
        with self._cv:
            self._dq.appendleft(entry)
            self._cv.notify()

    def drain_all(self) -> List[QueueEntry]:
        """Remove and return everything still queued (shutdown path —
        the caller decides between serving and cancelling them)."""
        with self._cv:
            out = list(self._dq)
            self._dq.clear()
            return out

    def close(self) -> None:
        """Stop admission and wake every waiting worker.  Queued entries
        stay takeable — close-then-flush is the graceful-drain order."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
