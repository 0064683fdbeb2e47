"""Fault tolerance: step watchdog, straggler detection, restart protocol.

A copy of ``repro.distributed.fault_tolerance`` (plain Python).

At 1000+ nodes the failure model is: (a) hard node loss — detected by the
runtime, handled by checkpoint/restart onto the surviving mesh (elastic
restore in checkpoint.py); (b) stragglers — a slow host stretches every
synchronous step.  The watchdog tracks a robust step-time estimate and
flags outliers; the trainer reacts per policy (log / re-dispatch / abort
to restart).  Failure injection hooks make all of this testable on one
host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass
class WatchdogConfig:
    straggler_factor: float = 3.0     # step > factor * EMA -> straggler
    hang_factor: float = 10.0         # step > factor * EMA -> presumed hang
    ema_decay: float = 0.9
    min_samples: int = 5


class StepWatchdog:
    """Wraps the train step; detects stragglers & hangs from wall times."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig()):
        self.cfg = cfg
        self.ema: Optional[float] = None
        self.n = 0
        self.straggler_steps: List[int] = []
        self.events: List[dict] = []

    def observe(self, step: int, dt: float) -> str:
        """Feed one step time; returns 'ok' | 'straggler' | 'hang'."""
        verdict = "ok"
        if self.n >= self.cfg.min_samples and self.ema is not None:
            if dt > self.cfg.hang_factor * self.ema:
                verdict = "hang"
            elif dt > self.cfg.straggler_factor * self.ema:
                verdict = "straggler"
        if verdict != "ok":
            self.straggler_steps.append(step)
            self.events.append({"step": step, "dt": dt, "ema": self.ema,
                                "verdict": verdict})
        # EMA excludes outliers so one straggler doesn't poison the baseline
        if verdict == "ok":
            self.ema = (dt if self.ema is None
                        else self.cfg.ema_decay * self.ema
                        + (1 - self.cfg.ema_decay) * dt)
            self.n += 1
        return verdict


class FailureInjector:
    """Deterministic failure injection for tests/examples: raises at the
    configured steps, simulating a node loss the trainer must survive."""

    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.fired = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected node failure at step {step}")


def run_with_restarts(
    run: Callable[[int], int],
    *,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> int:
    """Restart protocol: call run(attempt); on failure restart (the run fn
    is expected to resume from the latest checkpoint).  Returns the final
    step reached."""
    attempt = 0
    while True:
        try:
            return run(attempt)
        except Exception as e:  # noqa: BLE001 — restart protocol
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
