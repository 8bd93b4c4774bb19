"""Continuous-batching slot scheduler: the serving control plane.

Extracted from the control-plane skeleton of ``runtime/serve.py``'s
``ServeLoop`` so both serving front ends — token generation there,
classification in ``engine/service.py`` — share one scheduler instead of
each reimplementing (and subtly breaking) queue/slot bookkeeping:

  * a FIFO **request queue** with optional backpressure (``max_queue``;
    :meth:`SlotScheduler.submit` raises :class:`SchedulerFull`,
    :meth:`SlotScheduler.try_submit` returns ``False``),
  * a fixed number of **batch slots**: the executing batch always has the
    same shape, so the jitted forward is traced exactly once; free slots
    are *dead* and carried as ``False`` entries of :meth:`valid_mask`,
  * **continuous refill**: :meth:`refill` admits queued requests into
    free slots the moment they free up — mid-flight for workloads whose
    requests finish at different times, per batch for one-shot workloads,
  * **metrics**: per-request enqueue->done latency — histogram-backed, so
    :meth:`SchedulerMetrics.snapshot` carries exact p50/p99 next to the
    mean, split into queue wait (enqueue->admit) vs in-flight
    (admit->done) — and per-step slot occupancy, measured against an
    injectable monotonic ``clock`` so tests can pin time,
  * **tracing**: given a :class:`~repro_torch.obs.trace.Tracer`, every
    request becomes an async span (enqueue -> admit -> done) and each
    recorded step samples queue depth / live slots into counter tracks,
    landing request lifecycles on the same Perfetto timeline as compile
    phases and layer execution.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from repro_torch.obs.metrics import LATENCY_BUCKETS_S, Histogram
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["SchedulerFull", "SchedulerMetrics", "SlotScheduler"]


class SchedulerFull(RuntimeError):
    """Raised by :meth:`SlotScheduler.submit` when the bounded queue is
    full — the backpressure signal a front end turns into HTTP 429/503."""


def _latency_hist() -> Histogram:
    return Histogram(buckets=LATENCY_BUCKETS_S)


@dataclasses.dataclass
class SchedulerMetrics:
    """Counters the scheduler accumulates while serving.

    ``occupancy_sum`` adds the live-slot count once per recorded step, so
    ``occupancy_mean`` is the average fraction of the fixed batch shape
    doing useful work.  Latencies are enqueue->done wall-clock seconds,
    recorded into an exact-percentile histogram
    (``obs/metrics.Histogram``) and broken down into queue wait
    (enqueue->admit, recorded at admission over ``admitted`` requests)
    vs in-flight time (admit->done, recorded at completion).
    """

    batch_slots: int
    enqueued: int = 0
    admitted: int = 0
    completed: int = 0
    rejected: int = 0
    steps: int = 0
    occupancy_sum: int = 0
    latency_sum: float = 0.0
    latency_max: float = 0.0
    queue_wait_sum: float = 0.0
    in_flight_sum: float = 0.0
    first_results: int = 0
    first_result_sum: float = 0.0
    latency_hist: Histogram = dataclasses.field(
        default_factory=_latency_hist, repr=False, compare=False
    )
    queue_wait_hist: Histogram = dataclasses.field(
        default_factory=_latency_hist, repr=False, compare=False
    )
    first_result_hist: Histogram = dataclasses.field(
        default_factory=_latency_hist, repr=False, compare=False
    )

    @property
    def occupancy_mean(self) -> float:
        """Mean live fraction of the batch over recorded steps, in [0, 1]."""
        if self.steps == 0:
            return 0.0
        return self.occupancy_sum / (self.steps * self.batch_slots)

    @property
    def latency_mean(self) -> float:
        if self.completed == 0:
            return 0.0
        return self.latency_sum / self.completed

    @property
    def latency_p50(self) -> float:
        return self.latency_hist.percentile(50)

    @property
    def latency_p99(self) -> float:
        return self.latency_hist.percentile(99)

    @property
    def queue_wait_mean(self) -> float:
        if self.admitted == 0:
            return 0.0
        return self.queue_wait_sum / self.admitted

    @property
    def in_flight_mean(self) -> float:
        if self.completed == 0:
            return 0.0
        return self.in_flight_sum / self.completed

    @property
    def first_result_mean(self) -> float:
        if self.first_results == 0:
            return 0.0
        return self.first_result_sum / self.first_results

    def record_admit(self, queue_wait: float) -> None:
        self.admitted += 1
        self.queue_wait_sum += queue_wait
        self.queue_wait_hist.observe(queue_wait)

    def record_first_result(self, latency: float) -> None:
        """Enqueue->first-result SLO latency: time to the first usable
        output (first decode token for generation; the completed logits
        for single-step classification)."""
        self.first_results += 1
        self.first_result_sum += latency
        self.first_result_hist.observe(latency)

    def record_complete(self, latency: float, in_flight: float) -> None:
        self.completed += 1
        self.latency_sum += latency
        self.latency_max = max(self.latency_max, latency)
        self.latency_hist.observe(latency)
        self.in_flight_sum += in_flight

    def snapshot(self) -> dict:
        return {
            "batch_slots": self.batch_slots,
            "enqueued": self.enqueued,
            "admitted": self.admitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "steps": self.steps,
            "occupancy_mean": self.occupancy_mean,
            "latency_mean_s": self.latency_mean,
            "latency_max_s": self.latency_max,
            "latency_p50_s": self.latency_p50,
            "latency_p99_s": self.latency_p99,
            "queue_wait_mean_s": self.queue_wait_mean,
            "queue_wait_p99_s": self.queue_wait_hist.percentile(99),
            "in_flight_mean_s": self.in_flight_mean,
            "first_result_mean_s": self.first_result_mean,
            "first_result_p50_s": self.first_result_hist.percentile(50),
            "first_result_p99_s": self.first_result_hist.percentile(99),
        }

    def to_prometheus(self, prefix: str = "scheduler") -> str:
        """Prometheus text exposition of the current window — what an RPC
        front end returns from its ``/metrics`` endpoint."""
        lines = []
        scalars = {
            "batch_slots": ("gauge", self.batch_slots),
            "enqueued_total": ("counter", self.enqueued),
            "admitted_total": ("counter", self.admitted),
            "completed_total": ("counter", self.completed),
            "rejected_total": ("counter", self.rejected),
            "steps_total": ("counter", self.steps),
            "occupancy_mean": ("gauge", self.occupancy_mean),
        }
        for name, (kind, value) in scalars.items():
            full = f"{prefix}_{name}"
            lines.append(f"# TYPE {full} {kind}")
            lines.append(f"{full} {value}")
        lines.extend(self.latency_hist.prom_lines(f"{prefix}_latency_seconds"))
        lines.extend(
            self.queue_wait_hist.prom_lines(f"{prefix}_queue_wait_seconds")
        )
        lines.extend(
            self.first_result_hist.prom_lines(
                f"{prefix}_first_result_seconds"
            )
        )
        return "\n".join(lines) + "\n"


class SlotScheduler:
    """Fixed-slot continuous-batching scheduler (queue + slots + metrics).

    Args:
      batch_slots: number of slots in the fixed batch shape.
      max_queue: queued-request bound; 0 means unbounded.  Requests beyond
        the bound are rejected (``submit`` raises, ``try_submit`` returns
        ``False``) — requests already admitted to slots don't count.
      clock: monotonic time source for latency metrics (injectable so
        tests are deterministic).
      tracer: optional span tracer; each request becomes an async
        "request" span from enqueue to completion with an admission
        instant, and :meth:`record_step` samples queue depth / live
        slots into counter tracks once a step.  ``None`` resolves to the
        shared no-op tracer.

    Thread safety: every public method takes one internal re-entrant
    lock, so an async front end may ``try_submit`` from its event loop
    while a worker thread steps/refills/completes and a scraper calls
    :meth:`snapshot` — counters and slot bookkeeping stay consistent.
    (The histograms carry their own locks; ``reset_metrics`` swapping
    the metrics object is atomic under the same lock.)
    """

    def __init__(
        self,
        batch_slots: int,
        max_queue: int = 0,
        clock: Callable[[], float] = time.monotonic,
        tracer: Tracer | None = None,
    ):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.batch_slots = batch_slots
        self.max_queue = max_queue
        self._clock = clock
        self._tracer = tracer or NULL_TRACER
        self._lock = threading.RLock()
        self._queue: deque[tuple[Any, float, int]] = deque()
        self._slots: list[Any | None] = [None] * batch_slots
        self._enq_time: list[float] = [0.0] * batch_slots
        self._admit_time: list[float] = [0.0] * batch_slots
        self._slot_rid: list[int] = [0] * batch_slots
        self._first_done: list[bool] = [True] * batch_slots
        self._rid_seq = 0  # request-id sequence for the trace's async spans
        self._last_step_t: float | None = None
        self._step_ewma: float = 0.0  # smoothed inter-step wall time
        self.metrics = SchedulerMetrics(batch_slots=batch_slots)

    # ------------------------------------------------------------- admission

    def has_capacity(self) -> bool:
        """Whether the queue can accept a request right now — a probe
        that, unlike :meth:`try_submit`, does not count a rejection."""
        with self._lock:
            return not self.max_queue or len(self._queue) < self.max_queue

    def try_submit(self, item: Any) -> bool:
        """Enqueue ``item``; ``False`` (and a rejected tick) when full."""
        with self._lock:
            if not (not self.max_queue or len(self._queue) < self.max_queue):
                self.metrics.rejected += 1
                self._tracer.instant("request_rejected", cat="request")
                return False
            self._rid_seq += 1
            rid = self._rid_seq
            self._queue.append((item, self._clock(), rid))
            self.metrics.enqueued += 1
            self._tracer.async_begin("request", rid, cat="request")
            return True

    def resubmit(self, item: Any) -> None:
        """Re-enqueue already-admitted work at the *front* of the queue.

        The priority lane for load shedding: work the service already
        accepted (e.g. an in-flight slot replayed after a fault, or a
        request bumped out of a slot) must never compete with — or be
        shed in favour of — brand-new arrivals, so it bypasses
        ``max_queue`` and is admitted before anything behind it.
        """
        with self._lock:
            self._rid_seq += 1
            rid = self._rid_seq
            self._queue.appendleft((item, self._clock(), rid))
            self.metrics.enqueued += 1
            self._tracer.async_begin("request", rid, cat="request")

    def submit(self, item: Any) -> None:
        """Enqueue ``item``; raise :class:`SchedulerFull` when full."""
        if not self.try_submit(item):
            raise SchedulerFull(
                f"request queue full ({len(self._queue)}/{self.max_queue})"
            )

    def refill(self) -> list[tuple[int, Any]]:
        """Admit queued requests into free slots, lowest slot first.

        Returns the ``(slot, item)`` pairs admitted *now*; the caller
        writes their payloads into exactly those batch rows.
        """
        with self._lock:
            admitted = []
            for i in range(self.batch_slots):
                if self._slots[i] is None and self._queue:
                    item, t_enq, rid = self._queue.popleft()
                    now = self._clock()
                    self._slots[i] = item
                    self._enq_time[i] = t_enq
                    self._admit_time[i] = now
                    self._slot_rid[i] = rid
                    self._first_done[i] = False
                    self.metrics.record_admit(max(now - t_enq, 0.0))
                    self._tracer.async_instant(
                        "request", rid, cat="request", event="admit", slot=i
                    )
                    admitted.append((i, item))
            return admitted

    # ------------------------------------------------------------- occupancy

    def live(self) -> list[tuple[int, Any]]:
        """The currently occupied ``(slot, item)`` pairs."""
        with self._lock:
            return [
                (i, it) for i, it in enumerate(self._slots) if it is not None
            ]

    def valid_mask(self) -> np.ndarray:
        """Bool [batch_slots]: which rows of the fixed batch are live."""
        with self._lock:
            return np.array([s is not None for s in self._slots], bool)

    def queued(self) -> int:
        with self._lock:
            return len(self._queue)

    def slot_rid(self, slot: int) -> int:
        """The trace async-span id of the request occupying ``slot``."""
        with self._lock:
            return self._slot_rid[slot]

    def reset_metrics(self) -> None:
        """Start a fresh metrics window (e.g. after a warm-up batch).

        In-flight requests are *re-anchored* to the reset instant: their
        enqueue/admit timestamps become "now", so when they eventually
        complete they contribute only their post-reset time to the fresh
        window instead of dragging pre-reset wait in with them.
        """
        with self._lock:
            now = self._clock()
            for i, s in enumerate(self._slots):
                if s is not None:
                    self._enq_time[i] = now
                    self._admit_time[i] = now
            self._last_step_t = None
            self.metrics = SchedulerMetrics(batch_slots=self.batch_slots)

    def snapshot(self) -> dict:
        """Consistent point-in-time metrics dict (equivalent to
        ``scheduler.metrics.snapshot()`` but taken under the scheduler
        lock, so a concurrent ``reset_metrics`` can't swap the object
        mid-read)."""
        with self._lock:
            return self.metrics.snapshot()

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(
                s is not None for s in self._slots
            )

    def retry_after_hint(self) -> float:
        """Backpressure-derived retry hint in seconds for shed requests.

        Estimates how long until the queue has drained enough to accept
        new work: full-queue depth in units of batch_slots-sized waves,
        times the smoothed inter-step wall time (falling back to 50ms
        before any step has run).  Clamped to [1ms, 60s].
        """
        with self._lock:
            step = self._step_ewma if self._step_ewma > 0 else 0.05
            waves = max(1, math.ceil((len(self._queue) + 1)
                                     / self.batch_slots))
            return float(min(max(waves * step, 1e-3), 60.0))

    # ------------------------------------------------------------ completion

    def record_step(self) -> None:
        """Account one executed batch step at the current occupancy."""
        with self._lock:
            now = self._clock()
            if self._last_step_t is not None:
                dur = max(now - self._last_step_t, 0.0)
                self._step_ewma = (
                    dur if self._step_ewma == 0.0
                    else 0.8 * self._step_ewma + 0.2 * dur
                )
            self._last_step_t = now
            self.metrics.steps += 1
            live = sum(1 for s in self._slots if s is not None)
            self.metrics.occupancy_sum += live
            self._tracer.counter("scheduler/queue_depth",
                                 queued=len(self._queue))
            self._tracer.counter("scheduler/slots_live", live=live)

    def record_first_result(self, slot: int) -> None:
        """Record the enqueue->first-result latency for ``slot`` (e.g.
        the first decode token landing).  Idempotent per occupancy;
        :meth:`complete` falls back to recording it for single-step
        workloads that never call this."""
        with self._lock:
            if self._first_done[slot] or self._slots[slot] is None:
                return
            self._first_done[slot] = True
            now = self._clock()
            self.metrics.record_first_result(
                max(now - self._enq_time[slot], 0.0)
            )
            self._tracer.async_instant(
                "request", self._slot_rid[slot], cat="request",
                event="first_result", slot=slot,
            )

    def complete(self, slot: int) -> Any:
        """Free ``slot``, record its request's latency, return the item."""
        with self._lock:
            item = self._slots[slot]
            if item is None:
                raise ValueError(f"slot {slot} is not occupied")
            if not self._first_done[slot]:
                self.record_first_result(slot)
            self._slots[slot] = None
            self._first_done[slot] = True
            now = self._clock()
            latency = max(now - self._enq_time[slot], 0.0)
            in_flight = max(now - self._admit_time[slot], 0.0)
            self.metrics.record_complete(latency, in_flight)
            self._tracer.async_end(
                "request", self._slot_rid[slot], cat="request"
            )
            return item
