"""Span tracer with Chrome trace-event JSON export (Perfetto-loadable).

Design constraints, in order:

  * **near-zero overhead when off** — every instrumented call site takes
    a ``tracer=None`` default that resolves to :data:`NULL_TRACER`, whose
    methods are no-ops; nothing is recorded, no clock is read, a span is
    one shared context manager, and a traced forward runs the same ops
    as an untraced one.
  * **deterministic under test** — the clock is injectable
    (``clock=lambda: fake.t``), so span timestamps and durations are
    exact values, not wall-clock noise.
  * **bounded** — events live in a ring buffer (``max_events``); a
    long-running service can keep a tracer attached without growing
    memory, at the cost of dropping the oldest events (the drop count
    is reported in the export metadata).
  * **thread-safe** — one lock around the ring; thread idents map to
    small stable ``tid`` values with thread-name metadata in the export.

Export follows the Chrome trace-event format "JSON object" flavour:
``{"traceEvents": [...]}`` where each event carries ``ph`` (phase),
``ts``/``dur`` in *microseconds*, ``pid``/``tid``, ``name``, ``cat``,
``args``.  Phases used here:

  ``X``    complete span (ts + dur)          — :meth:`Tracer.span`
  ``i``    instant event                     — :meth:`Tracer.instant`
  ``C``    counter track                     — :meth:`Tracer.counter`
  ``b/e``  async span begin/end (by ``id``)  — request lifecycles
  ``n``    async instant (a step inside one) — e.g. slot admission
  ``M``    metadata (process/thread names)   — added at export time
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator
from contextlib import AbstractContextManager, contextmanager

__all__ = ["SpanRecord", "Tracer", "NULL_TRACER"]


class SpanRecord:
    """One finished (or in-flight) complete span.

    ``ts``/``dur`` are *seconds* on the tracer's clock; the Chrome export
    converts to microseconds.  ``dur`` is ``None`` until the span exits.
    ``args`` may be updated while the span is open (the updated values
    land in the export).
    """

    __slots__ = ("name", "cat", "ts", "dur", "tid", "args")

    def __init__(self, name: str, cat: str, ts: float, tid: int, args: dict):
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur: float | None = None
        self.tid = tid
        self.args = args


class Tracer:
    """Thread-safe span/instant/counter recorder with Chrome JSON export.

    Args:
      clock: monotonic time source returning *seconds* (injectable for
        deterministic tests).  Timestamps are relative to the tracer's
        creation instant, so exported traces start near ``ts=0``.
      max_events: ring-buffer bound; the oldest events are dropped once
        exceeded (``dropped_events`` in the export metadata counts them).
      enabled: a disabled tracer records nothing and its ``span()`` is a
        no-op context manager — the mechanism behind :data:`NULL_TRACER`.
      pid: the ``pid`` stamped on every event (one logical process).
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        max_events: int = 200_000,
        enabled: bool = True,
        pid: int = 0,
        process_name: str = "repro-engine",
    ):
        self.clock = clock
        self.enabled = enabled
        self.pid = pid
        self.process_name = process_name
        self._t0 = clock() if enabled else 0.0
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._seen = 0  # total events ever recorded (for drop accounting)
        self._tids: dict[int, int] = {}  # thread ident -> small stable tid
        self._tid_names: dict[int, str] = {}

    # ------------------------------------------------------------ recording

    def _now(self) -> float:
        return self.clock() - self._t0

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
                self._tid_names[tid] = threading.current_thread().name
        return tid

    def _record(self, ev: Any) -> None:
        with self._lock:
            self._events.append(ev)
            self._seen += 1

    def span(self, name: str, cat: str = "",
             **args) -> AbstractContextManager[SpanRecord]:
        """Record a complete ('X') span around the ``with`` body.

        Yields the :class:`SpanRecord`; after exit its ``dur`` holds the
        measured duration in seconds (on the injectable clock), which
        instrumentation can read back — e.g. the executor accumulates
        per-layer wall time from it.  Exceptions propagate; the span is
        still closed (and flagged ``error=True`` in its args).  A disabled
        tracer returns one shared no-op context manager, which reads no
        clock and yields a shared empty record.
        """
        if not self.enabled:
            return _NULL_SPAN_CONTEXT
        return self._span(name, cat, args)

    @contextmanager
    def _span(self, name: str, cat: str, args: dict) -> Iterator[SpanRecord]:
        rec = SpanRecord(name, cat, self._now(), self._tid(), args)
        try:
            yield rec
        except BaseException:
            rec.args["error"] = True
            raise
        finally:
            rec.dur = max(self._now() - rec.ts, 0.0)
            self._record(rec)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Record an instant ('i', thread-scoped) event."""
        if not self.enabled:
            return
        self._record(
            {
                "ph": "i",
                "name": name,
                "cat": cat,
                "ts": self._now(),
                "tid": self._tid(),
                "s": "t",
                "args": args,
            }
        )

    def counter(self, name: str, **series: float) -> None:
        """Record a counter ('C') sample: one track, one or more series."""
        if not self.enabled or not series:
            return
        self._record(
            {
                "ph": "C",
                "name": name,
                "cat": "",
                "ts": self._now(),
                "tid": self._tid(),
                "args": {k: float(v) for k, v in series.items()},
            }
        )

    def async_begin(self, name: str, id_: int, cat: str = "", **args) -> None:
        """Open an async ('b') span — e.g. a request lifecycle — keyed by
        ``id_``; close it with :meth:`async_end` using the same id."""
        self._async("b", name, id_, cat, args)

    def async_instant(self, name: str, id_: int, cat: str = "", **args) -> None:
        """An 'n' instant *inside* an open async span (e.g. admission)."""
        self._async("n", name, id_, cat, args)

    def async_end(self, name: str, id_: int, cat: str = "", **args) -> None:
        self._async("e", name, id_, cat, args)

    def _async(self, ph: str, name: str, id_: int, cat: str, args: dict):
        if not self.enabled:
            return
        self._record(
            {
                "ph": ph,
                "name": name,
                "cat": cat,
                "id": int(id_),
                "ts": self._now(),
                "tid": self._tid(),
                "args": args,
            }
        )

    # -------------------------------------------------------------- reading

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._seen = 0

    @property
    def origin(self) -> float:
        """The clock reading every ``ts`` is relative to: a span's start
        on the tracer's clock (``time.perf_counter`` by default) is
        ``origin + ts``, which puts it on another timeline read off the
        same clock, such as a device trace's."""
        return self._t0

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._seen - len(self._events)

    def events(self) -> list[dict]:
        """The buffered events in Chrome trace-event form (ts/dur in µs)."""
        with self._lock:
            raw = list(self._events)
        out = []
        for ev in raw:
            if isinstance(ev, SpanRecord):
                out.append(
                    {
                        "ph": "X",
                        "name": ev.name,
                        "cat": ev.cat,
                        "ts": ev.ts * 1e6,
                        "dur": (ev.dur or 0.0) * 1e6,
                        "pid": self.pid,
                        "tid": ev.tid,
                        "args": ev.args,
                    }
                )
            else:
                out.append({**ev, "ts": ev["ts"] * 1e6, "pid": self.pid})
        return out

    def spans(self, cat: str | None = None) -> list[SpanRecord]:
        """Finished complete spans, optionally filtered by category."""
        with self._lock:
            raw = [e for e in self._events if isinstance(e, SpanRecord)]
        if cat is not None:
            raw = [e for e in raw if e.cat == cat]
        return raw

    def slowest(
        self, n: int = 3, cat: str | None = None, prefix: str | None = None
    ) -> list[tuple[str, float]]:
        """Top-``n`` span names by *total* duration (seconds), descending.

        Durations aggregate over same-named spans, so a layer executed
        many times ranks by its cumulative time.  ``prefix`` filters by
        span-name prefix (e.g. ``"layer:"``).
        """
        totals: dict[str, float] = {}
        for s in self.spans(cat):
            if prefix is not None and not s.name.startswith(prefix):
                continue
            totals[s.name] = totals.get(s.name, 0.0) + (s.dur or 0.0)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])
        return ranked[:n]

    # ------------------------------------------------------------- exporting

    def to_chrome(self) -> dict:
        """The full trace as a Chrome trace-event JSON object."""
        meta = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": self.pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": self.process_name},
            }
        ]
        for tid, tname in sorted(self._tid_names.items()):
            meta.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": self.pid,
                    "tid": tid,
                    "ts": 0,
                    "args": {"name": tname},
                }
            )
        return {
            "traceEvents": meta + self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped_events},
        }

    def write(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# a shared open span handed out by disabled tracers, so `with t.span(...)
# as sp` call sites never branch; its dur stays 0.0 and args go nowhere
_NULL_SPAN = SpanRecord("", "", 0.0, 0, {})
_NULL_SPAN.dur = 0.0


class _NullSpanContext:
    """What a disabled tracer's ``span()`` returns: one shared context
    manager that yields :data:`_NULL_SPAN` and lets exceptions through,
    cheaper to enter than a generator-based one."""

    __slots__ = ()

    def __enter__(self) -> SpanRecord:
        return _NULL_SPAN

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN_CONTEXT = _NullSpanContext()

NULL_TRACER = Tracer(enabled=False, max_events=1)
"""Shared no-op tracer: the resolution of every ``tracer=None`` default."""
