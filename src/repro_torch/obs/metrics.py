"""Counters, gauges, histograms + a resettable process-global registry.

Pure stdlib.  Three metric kinds:

  * :class:`Counter` — monotonically increasing float.
  * :class:`Gauge` — a settable instantaneous value.
  * :class:`Histogram` — fixed cumulative buckets (the Prometheus shape)
    *plus* a bounded ring of the recorded samples, so quantiles
    (:meth:`Histogram.percentile`) are **exact** over the retained window
    rather than bucket-interpolated.  While fewer than ``max_samples``
    observations have been made, percentiles are exact over *all* of
    them; past the cap they are exact over the most recent window.

:class:`MetricsRegistry` groups metrics by name (get-or-create, kind
conflicts raise) and renders either a JSON-ready :meth:`snapshot` or
Prometheus text exposition (:meth:`to_prometheus`).  The module-level
:func:`get_registry` registry is process-global but resettable —
``get_registry().reset()`` in a test fixture isolates tests without
process-wide import tricks.

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
    "Counter",
    "Gauge",
    "Histogram",
    "Meter",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "LATENCY_BUCKETS_S",
    "get_registry",
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


class Counter:
    """Monotonic counter.  ``inc`` by a non-negative amount only."""

    kind = "counter"

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value

    def prom_lines(self, name: str) -> list[str]:
        return [f"# TYPE {name} counter", f"{name} {_fmt(self._value)}"]


class Gauge:
    """Instantaneous value; ``set`` wins, ``inc``/``dec`` adjust."""

    kind = "gauge"

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value

    def prom_lines(self, name: str) -> list[str]:
        return [f"# TYPE {name} gauge", f"{name} {_fmt(self._value)}"]


class Histogram:
    """Fixed-bucket histogram with exact sample-backed percentiles.

    ``buckets`` are upper bounds (le) of the cumulative Prometheus
    buckets; an implicit ``+Inf`` bucket always exists.  ``max_samples``
    bounds the raw-sample ring the percentiles are computed from.
    """

    kind = "histogram"

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
    last ``window_s``), which a monotonic :class:`Counter` cannot give
    without a scraper differentiating it.  ``mark(n)`` records *n* events
    now; :attr:`rate` is events/s over the retained window (0 until the
    first mark).  ``clock`` is injectable for deterministic tests.
    """

    kind = "meter"

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


_PROM_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _prom_name(name: str) -> str:
    out = "".join(ch if ch in _PROM_OK else "_" for ch in name)
    return out if out and not out[0].isdigit() else "_" + out


class MetricsRegistry:
    """Named metrics, get-or-create, with JSON and Prometheus renderings."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, kind: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, "counter", Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, "gauge", Gauge)

    def histogram(self, name: str, buckets=None, max_samples: int = 65_536):
        return self._get_or_create(
            name,
            "histogram",
            lambda: Histogram(buckets or DEFAULT_BUCKETS, max_samples),
        )

    def meter(self, name: str, window_s: float = 10.0) -> Meter:
        return self._get_or_create(
            name, "meter", lambda: Meter(window_s=window_s)
        )

    def register(self, name: str, metric) -> None:
        """Attach an externally owned metric (e.g. a scheduler's latency
        histogram) so it appears in this registry's renderings."""
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None and existing is not metric:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = metric

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every metric — the test-isolation escape hatch."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._metrics.items())
        return {
            name: {"kind": m.kind, "value": m.snapshot()} for name, m in items
        }

    def to_prometheus(self) -> str:
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        for name, m in items:
            lines.extend(m.prom_lines(_prom_name(name)))
        return "\n".join(lines) + ("\n" if lines else "")


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry (reset it between tests)."""
    return _REGISTRY
