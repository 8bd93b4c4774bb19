"""Histograms and rate meters for the serving front ends.

Pure stdlib.  Two metric kinds:

  * :class:`Histogram` — fixed cumulative buckets (the Prometheus shape)
    *plus* a bounded ring of the recorded samples, so quantiles
    (:meth:`Histogram.percentile`) are **exact** over the retained window
    rather than bucket-interpolated.  While fewer than ``max_samples``
    observations have been made, percentiles are exact over *all* of
    them; past the cap they are exact over the most recent window.
  * :class:`Meter` — events per second over a sliding window.

Each renders a JSON-ready ``snapshot()`` and Prometheus text lines
(``prom_lines``); their owners (the scheduler's metrics, the HTTP
server) expose them.

Percentiles use the nearest-rank definition: ``percentile(p)`` of *n*
sorted samples is the ``ceil(p/100 * n)``-th smallest, so e.g. the p50
of 1..100 is exactly 50 and the p99 exactly 99.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

__all__ = [
    "Histogram",
    "Meter",
    "DEFAULT_BUCKETS",
    "LATENCY_BUCKETS_S",
]

# generic magnitude ladder (Prometheus' default, extended one decade up)
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
    50.0, 100.0,
)
# request latencies in seconds: sub-ms service steps up to multi-second
# queue waits under load
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Fixed-bucket histogram with exact sample-backed percentiles.

    ``buckets`` are upper bounds (le) of the cumulative Prometheus
    buckets; an implicit ``+Inf`` bucket always exists.  ``max_samples``
    bounds the raw-sample ring the percentiles are computed from.
    """

    def __init__(self, buckets=DEFAULT_BUCKETS, max_samples: int = 65_536):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be sorted and non-empty: {buckets}")
        self.buckets = tuple(float(b) for b in buckets)
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # + the Inf bucket
        self._samples: deque[float] = deque(maxlen=max_samples)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            self._samples.append(value)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    self._bucket_counts[i] += 1
                    break
            else:
                self._bucket_counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained samples (0 if none)."""
        if not 0 < p <= 100:
            raise ValueError(f"percentile must be in (0, 100], got {p}")
        with self._lock:
            samples = sorted(self._samples)
        if not samples:
            return 0.0
        rank = math.ceil(p / 100.0 * len(samples))
        return samples[rank - 1]

    def snapshot(self) -> dict:
        with self._lock:
            cum, out = 0, []
            for ub, c in zip(self.buckets, self._bucket_counts):
                cum += c
                out.append([ub, cum])
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": out,
        }

    def prom_lines(self, name: str) -> list[str]:
        lines = [f"# TYPE {name} histogram"]
        with self._lock:
            cum = 0
            for ub, c in zip(self.buckets, self._bucket_counts):
                cum += c
                lines.append(f'{name}_bucket{{le="{_fmt(ub)}"}} {cum}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {self._count}')
            lines.append(f"{name}_sum {_fmt(self._sum)}")
            lines.append(f"{name}_count {self._count}")
        return lines


class Meter:
    """Windowed event-rate meter: events/s over a sliding time window.

    Serving front ends use it for *sustained* throughput (req/s over the
    last ``window_s``), which a monotonic counter cannot give
    without a scraper differentiating it.  ``mark(n)`` records *n* events
    now; :attr:`rate` is events/s over the retained window (0 until the
    first mark).  ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, window_s: float = 10.0, clock=time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._clock = clock
        self._events: deque[tuple[float, float]] = deque()
        self._total = 0.0
        self._lock = threading.Lock()

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def mark(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"meter mark must be >= 0, got {n}")
        now = self._clock()
        with self._lock:
            self._total += n
            self._events.append((now, float(n)))
            self._prune(now)

    @property
    def total(self) -> float:
        return self._total

    @property
    def rate(self) -> float:
        """Events/s over the sliding window."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            if not self._events:
                return 0.0
            n = sum(c for _, c in self._events)
            # measure over the elapsed fraction of the window so a burst
            # younger than window_s is not diluted by empty history
            span = max(now - self._events[0][0], 1e-9)
        return n / min(max(span, 1e-3), self.window_s)

    def snapshot(self) -> dict:
        return {"total": self._total, "rate_per_s": self.rate}

    def prom_lines(self, name: str) -> list[str]:
        return [
            f"# TYPE {name}_total counter",
            f"{name}_total {_fmt(self._total)}",
            f"# TYPE {name}_rate_per_s gauge",
            f"{name}_rate_per_s {_fmt(self.rate)}",
        ]


def _fmt(v: float) -> str:
    """Prometheus-friendly number: integral values without the '.0'."""
    return str(int(v)) if float(v).is_integer() and abs(v) < 1e15 else repr(v)
