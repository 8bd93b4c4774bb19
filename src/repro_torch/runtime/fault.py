"""Fault-tolerance runtime: heartbeats, straggler detection, restart policy.

Port of ``src/repro/runtime/fault.py``, copied: the policies are host
numpy, ``time`` and ``deque``, and behave as the reference's do for the
same calls.

On a real 1000+-node deployment these hooks attach to the cluster
coordinator (GCS / Borg / SLURM heartbeats); the policies themselves are
host-side Python and identical at any scale, so they are implemented and
tested here directly:

  * HeartbeatMonitor — per-host last-seen bookkeeping; hosts silent longer
    than ``timeout`` are declared dead.
  * StragglerDetector — per-step wall-time EWMA; steps slower than
    ``threshold`` x the median flag the slowest host.  Mitigation at the
    trainer level: checkpoint + elastic re-mesh without the straggler
    (or, within a step, rely on deterministic skip via gradient
    accumulation masks — see Trainer.run docstring).
  * RestartPolicy — bounded exponential backoff restart budget.
  * FailureInjector — deterministic fault schedule for tests/drills
    (fail step k, crash-after-save, etc.).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

__all__ = ["HeartbeatMonitor", "StragglerDetector", "RestartPolicy",
           "FailureInjector", "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    pass


class HeartbeatMonitor:
    def __init__(self, hosts: list[str], timeout: float = 60.0):
        self.timeout = timeout
        now = time.monotonic()
        self.last_seen = {h: now for h in hosts}

    def beat(self, host: str, t: float | None = None):
        self.last_seen[host] = time.monotonic() if t is None else t

    def dead_hosts(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last_seen.items() if now - t > self.timeout]


class StragglerDetector:
    """Flags steps much slower than the running median."""

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, duration: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            if duration > self.threshold * med:
                self.flagged.append((step, duration))
                is_straggler = True
        self.times.append(duration)
        return is_straggler


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    restarts: int = 0

    def next_delay(self) -> float | None:
        """None when the restart budget is exhausted."""
        if self.restarts >= self.max_restarts:
            return None
        delay = min(self.backoff_cap, self.backoff_base * (2 ** self.restarts))
        self.restarts += 1
        return delay


class FailureInjector:
    """Deterministic failure schedule for drills: {step: kind}."""

    def __init__(self, schedule: dict[int, str] | None = None):
        self.schedule = dict(schedule or {})
        self.fired: list[int] = []

    def maybe_fail(self, step: int):
        kind = self.schedule.get(step)
        if kind and step not in self.fired:
            self.fired.append(step)
            raise SimulatedFailure(f"injected {kind} at step {step}")
