"""Per-request futures for the async serving tier.

A :class:`SNNFuture` is the caller's handle on one submitted inference:
``submit()`` returns it immediately (emplace-on-arrival — the request
is already queued when the call returns) and the worker thread resolves
it exactly once with an :class:`AsyncResult`.  Four terminal statuses:

``ok``         served — logits / pred / latency split filled in.
``timeout``    the request's deadline expired before a rollout admitted
               it.  An EXPLICIT result, not a hung future: deadline
               enforcement happens at admission time, so an expired
               request resolves as soon as a worker next touches the
               queue.
``cancelled``  the engine shut down without draining it
               (``close(drain=False)``), or the queue rejected it.
``error``      the rollout that carried it raised (a kernel launch or
               the device failed); ``detail`` holds the exception.  The
               port's addition: ``repro``'s tier has no such status, and
               there a raising step kills its worker and leaves its
               requests' futures unresolved.

``result(timeout=...)`` blocks the caller (never the worker); a caller
that outwaits its own patience gets ``TimeoutError`` while the future
stays valid and may still resolve later.  Resolution is first-write-wins
under a lock, so a racing evict/serve pair cannot double-resolve.

Port of ``repro.serve_async.futures`` (framework-free; the port's own copy).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

STATUS_OK = "ok"
STATUS_TIMEOUT = "timeout"
STATUS_CANCELLED = "cancelled"
STATUS_ERROR = "error"


@dataclasses.dataclass
class AsyncResult:
    """Terminal outcome of one async request (see module docstring)."""

    uid: int
    status: str                          # ok | timeout | cancelled | error
    logits: Optional[np.ndarray] = None
    pred: Optional[int] = None
    latency_s: float = 0.0               # submit -> resolve
    queue_s: float = 0.0                 # submit -> rollout admit
    compute_s: float = 0.0               # the batched forward's share
    detail: str = ""                     # human-readable cause for
                                         # timeout / cancelled / error

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


class SNNFuture:
    """One-shot, thread-safe future (see module docstring)."""

    __slots__ = ("uid", "_event", "_lock", "_result")

    def __init__(self, uid: int):
        self.uid = uid
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[AsyncResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> AsyncResult:
        """Block until resolved (up to ``timeout`` seconds).  Raises
        ``TimeoutError`` if the CALLER ran out of patience — distinct
        from the request's own deadline expiring, which resolves the
        future with ``status == "timeout"``."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.uid}: no result within {timeout}s "
                f"(the request itself may still complete)")
        return self._result

    def resolve(self, result: AsyncResult) -> bool:
        """First write wins; returns whether THIS call resolved it."""
        with self._lock:
            if self._result is not None:
                return False
            self._result = result
            self._event.set()
            return True
