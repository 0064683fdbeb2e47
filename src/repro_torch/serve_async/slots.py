"""Slot manager: continuous-batching occupancy across rollouts.

A *slot* is one concurrently-admitted request's seat in the serving
pipeline — there are ``capacity = max_batch x max_inflight x workers``
of them, matching the most requests that can be on the device (or in a
dispatched-but-uncollected rollout) at once.  A request acquires a slot
at admission (when its cohort is handed to ``begin_step``) and releases
it when its rollout drains; the released slot is immediately available
to the next queued request, which is what "slot recycling across the
T-step loop" means with a layer-major full-T datapath: while rollout k
is mid-flight through its T timesteps, rollout k+1's requests are
already seated, transferred, and queued behind it — no request waits
for a full bucket or an idle device.

The manager only does bookkeeping (free list + hold timestamps under a
lock); the engine emits the ``recycle`` spans and the occupancy gauge
from its return values, so this stays import-light and trivially
testable.

Port of ``repro.serve_async.slots`` (framework-free; the port's own copy).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple


class SlotManager:
    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"need at least one slot, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        # LIFO free list: hot slots get reused first, which keeps slot
        # ids dense and the per-slot Chrome-trace rows readable
        self._free = list(range(capacity - 1, -1, -1))
        self._held: Dict[int, Tuple[int, float]] = {}  # slot -> (uid, t)
        self.total_acquired = 0
        self.total_recycled = 0          # acquisitions of a used slot

    def acquire(self, uid: int) -> Optional[int]:
        """Seat ``uid``; returns the slot id, or None when full (the
        caller then leaves the request queued — backpressure, not an
        error)."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._held[slot] = (uid, time.perf_counter())
            self.total_acquired += 1
            if self.total_acquired > self.capacity:
                self.total_recycled += 1
            return slot

    def release(self, slot: int) -> Tuple[int, float]:
        """Free a slot; returns ``(uid, held_s)`` for the recycle span."""
        with self._lock:
            uid, t0 = self._held.pop(slot)
            self._free.append(slot)
            return uid, time.perf_counter() - t0

    def occupied(self) -> int:
        with self._lock:
            return len(self._held)

    def occupancy(self) -> float:
        return self.occupied() / self.capacity

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)
