"""Fault-tolerance runtime utilities, the port's copy of the reference's
``runtime/fault.py``: straggler watchdog, preemption handling,
transient-error retry. Cluster posture:

  * node failure  -> process dies -> auto-resume from the latest atomic
    checkpoint (trainer restores on start; data pipeline is stateless in
    the step number, so batch N is reproduced exactly).
  * preemption    -> SIGTERM -> PreemptionGuard requests a synchronous
    checkpoint at the next step boundary, then exits cleanly.
  * stragglers    -> StepWatchdog flags steps slower than k× the EMA; at
    cluster scale the flag feeds the scheduler (here: logged + counted).
    The dry-run path has no real collective to slow down, so the watchdog
    is validated by unit tests with synthetic timings.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional


@dataclasses.dataclass
class StepWatchdog:
    """EMA-based straggler detector for step times."""
    ratio: float = 3.0            # flag steps slower than ratio * EMA
    alpha: float = 0.1
    min_samples: int = 5
    ema: Optional[float] = None
    count: int = 0
    flagged: int = 0

    def observe(self, seconds: float) -> bool:
        self.count += 1
        if self.ema is None:
            self.ema = seconds
            return False
        slow = (self.count > self.min_samples
                and seconds > self.ratio * self.ema)
        if slow:
            self.flagged += 1        # straggler: skip EMA poisoning
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * seconds
        return slow


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a 'checkpoint then exit' request."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM,):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:   # not main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def should_stop(self) -> bool:
        return self.requested


def retry_transient(fn: Callable, *, attempts: int = 3, backoff: float = 0.5,
                    exceptions=(OSError, IOError)):
    """Retry a flaky side-effecting call (checkpoint IO, RPC) with backoff."""
    def wrapped(*a, **kw):
        last = None
        for i in range(attempts):
            try:
                return fn(*a, **kw)
            except exceptions as e:           # pragma: no cover - timing
                last = e
                time.sleep(backoff * (2 ** i))
        raise last
    return wrapped
