"""The program's own spans against a profiled stretch of the device.

:mod:`h100bench.devtrace` names an idle gap of the device only after a
CUDA runtime call that covers it; everything else falls under
``python``.  The program knows more: ``obs.trace.Tracer`` records the
served step's phases (``service.stage``, ``service.step`` holding
``forward`` and ``service.readback``, ``service.complete``) and, inside
the forward, its upload and each layer's enqueue (``forward.upload``,
``layer:<name>``).  This module reads the two together, and takes
nothing from the program (a tracer is read through ``spans()`` and
``origin`` alone):

  * :class:`SpanTrace` is a :class:`~h100bench.devtrace.DeviceTrace` that
    also keeps each device operation's and runtime call's correlation id
    (which pairs an operation with the call that launched it), the
    operations as recorded, unclipped, and a clock anchor;
  * :class:`SpanStretch` is a :class:`~h100bench.devtrace.Stretch` whose
    :meth:`~SpanStretch.stop` returns one.

The program's spans are timed on the host clock (``time.perf_counter``).
Right after the closing synchronise the stretch reads that clock and the
wall clock (``time.time_ns``) together; the trace's host events are
wall-clock nanoseconds since its ``baseTimeNanoseconds``, so the pair
puts any host-clock reading on the trace's clock
(:meth:`SpanTrace.to_trace`).  (The last device operation is no such
anchor: the host goes on working between the last step and the closing
synchronise, for tens of milliseconds on the card.)

The trace's device timestamps are the profiler's conversion of the
device's clock, and on the card they part from its host events partway
through some stretches, by up to several percent of the time elapsed:
kernels then appear to start milliseconds before the calls that launched
them.  :meth:`SpanTrace.aligned` moves them back onto the host events'
clock, anchored once a program span (a step's forward) on the launch
that found the device idle.  :meth:`SpanTrace.idle_by_span` and
:meth:`SpanTrace.device_by_layer` read the aligned stretch against the
program's spans.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile
import time
from collections import defaultdict

from h100bench.devtrace import (DEVICE_CATS, HOST_CATS, DeviceTrace, Stretch,
                                parse_chrome)

__all__ = ["SpanTrace", "SpanStretch", "parse_spans", "program_spans",
           "span_checks", "enqueue_ms", "service_host_ms", "forward_idle_ms"]


def _innermost(times: list[float], spans: list, outside: str) -> list[str]:
    """For each of ``times`` (ascending), the name of the shortest of
    ``spans`` ``[(start, dur, name)]`` that covers it, ``outside`` where
    none does."""
    spans = sorted(spans, key=lambda sp: sp[0])
    out = []
    active: list = []  # heap of (dur, end, name): the shortest on top
    j = 0
    for t in times:  # in time order, so a span once ended stays so
        while j < len(spans) and spans[j][0] <= t:
            start, dur, name = spans[j]
            heapq.heappush(active, (dur, start + dur, name))
            j += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        out.append(active[0][2] if active else outside)
    return out


def _ranked(by: dict) -> list[list]:
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])]


class SpanTrace(DeviceTrace):
    """A profiled stretch that the program's spans can be read against."""

    def __init__(self, t0: float, t1: float, device: list, host: list,
                 steps: int, device_corr: list | None = None,
                 host_corr: list | None = None,
                 clock: tuple | None = None, recorded: list | None = None):
        super().__init__(t0, t1, device, host, steps)
        # the correlation id of each entry of device and host (None where
        # the trace gives none)
        self.device_corr = device_corr or [None] * len(device)
        self.host_corr = host_corr or [None] * len(host)
        # (host_start, host_end, wall_end_ns, base_ns): the stretch's
        # start and end on the host clock, the wall clock read with its
        # end, and the trace's base; None where not all are known
        self.clock = clock
        # every device operation as recorded, unclipped: [(name, cat,
        # start, dur, correlation id)], what aligned() moves
        self.recorded = recorded
        self.offsets: list = []  # the anchors of an aligned stretch

    def to_trace(self, host_s: float) -> float | None:
        """A reading of the host clock (``time.perf_counter``) on the
        trace's clock, or ``None`` where the trace cannot be placed."""
        if self.clock is None:
            return None
        _, host_end, wall_end_ns, base_ns = self.clock
        return ((wall_end_ns - base_ns) + (host_s - host_end) * 1e9) * 1e-9

    def host_stretch(self) -> tuple[float, float]:
        """The stretch as the host clock timed it, on the trace's clock
        (``(t0, t1)`` where the trace cannot be placed)."""
        if self.clock is None:
            return self.t0, self.t1
        return self.to_trace(self.clock[0]), self.to_trace(self.clock[1])

    def gaps(self) -> list[tuple[float, float]]:
        """The stretch's idle intervals ``(start, end)``, in time order:
        no device operation runs in them."""
        busy = self._merged()
        edges = [self.t0] + [x for se in busy for x in se] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_by_span(self, spans: list) -> list[list]:
        """Idle device time summed by the program's spans ``[(name,
        start, dur)]`` on the trace's clock (read it on the
        :meth:`aligned` stretch): each gap is cut where a span starts or
        ends, and each piece goes to the innermost span that covers it
        (``outside`` where none does: the caller's own loop).  The rows
        sum to the stretch's idle time."""
        edges = sorted({t for _, s, d in spans for t in (s, s + d)})
        pieces = []
        for s, e in self.gaps():
            cut = [s] + edges[bisect.bisect_right(edges, s):
                              bisect.bisect_left(edges, e)] + [e]
            pieces += zip(cut, cut[1:])
        names = _innermost([0.5 * (s + e) for s, e in pieces],
                           [(s, d, n) for n, s, d in spans], "outside")
        by = defaultdict(float)
        for (s, e), name in zip(pieces, names):
            by[name] += e - s
        return _ranked(by)

    def _call_starts(self) -> dict:
        """The start of each runtime call, by correlation id."""
        return {c: hs for (_, _, hs, _), c in zip(self.host, self.host_corr)
                if c is not None}

    def device_by_layer(self, spans: list, is_spmm) -> dict[str, list]:
        """Device seconds ``[spmm, rest]`` by the program span that
        launched each operation: the innermost of ``spans`` ``[(name,
        start, dur)]`` around the start of the runtime call with the
        operation's correlation id (``outside`` where none covers it,
        ``unmatched`` where the trace holds no such call).
        ``is_spmm(name)`` tells the spmm's kernels from the rest."""
        call = self._call_starts()
        launched = sorted((call[c], i) for i, c in enumerate(self.device_corr)
                          if c in call)
        names = _innermost([t for t, _ in launched],
                           [(s, d, n) for n, s, d in spans], "outside")
        owner = {i: name for (_, i), name in zip(launched, names)}
        by: dict[str, list] = {}
        for i, (name, _, _, d) in enumerate(self.device):
            row = by.setdefault(owner.get(i, "unmatched"), [0.0, 0.0])
            row[0 if is_spmm(name) else 1] += d
        return by

    def aligned(self, spans: list, anchor: str) -> SpanTrace | None:
        """This stretch as the host clock timed it (:meth:`host_stretch`),
        its device operations moved onto the host events' clock.

        In each program span named ``anchor`` (``spans`` ``[(name, start,
        dur)]`` on the trace's clock), the operation that starts least
        long after its launch's runtime call began found the device idle:
        its start stands for that call's start, up to the launch's own
        few microseconds.  Between two such anchors the device clock's
        offset is taken to change linearly, and beyond the first and last
        to go on as between its two nearest.  The result's ``offsets``
        ``[(host time, device minus host seconds)]`` are the anchors'.
        ``None`` where the trace cannot be placed or no anchor span
        launched anything."""
        if self.clock is None:
            return None
        ops = self.recorded or [op + (c,) for op, c in
                                zip(self.device, self.device_corr)]
        call = self._call_starts()
        own = sorted((s, s + d) for n, s, d in spans if n == anchor)
        starts = [s for s, _ in own]
        best: dict[int, tuple] = {}
        for _, _, start, _, c in ops:
            if c not in call:
                continue
            t = call[c]
            k = bisect.bisect_right(starts, t) - 1
            if k < 0 or t > own[k][1]:
                continue
            if k not in best or start - t < best[k][0]:
                best[k] = (start - t, start)
        if not best:
            return None
        anchors = sorted((dev, lag) for lag, dev in best.values())
        dev_t = [d for d, _ in anchors]

        def offset(t: float) -> float:
            if len(anchors) == 1:
                return anchors[0][1]
            j = min(max(bisect.bisect_right(dev_t, t), 1), len(anchors) - 1)
            (d0, o0), (d1, o1) = anchors[j - 1], anchors[j]
            return o0 if d1 == d0 else o0 + (o1 - o0) * (t - d0) / (d1 - d0)

        lo, hi = self.host_stretch()
        device, corr = [], []
        for name, cat, s, d, c in ops:
            a, b = s - offset(s), s + d - offset(s + d)
            if b > lo and a < hi:
                a, b = max(a, lo), min(b, hi)
                device.append((name, cat, a, b - a))
                corr.append(c)
        out = SpanTrace(lo, hi, device, self.host, self.steps,
                        device_corr=corr, host_corr=self.host_corr,
                        clock=self.clock)
        out.offsets = [(d - o, o) for d, o in anchors]
        return out

    def calls_inside(self, spans: list, span: str, calls: list) -> int:
        """How many of the host ``calls`` ``[(name, cat, start, dur)]``
        lie wholly inside a program span named ``span`` (``spans``
        ``[(name, start, dur)]`` on the trace's clock)."""
        own = sorted((s, s + d) for n, s, d in spans if n == span)
        starts = [s for s, _ in own]
        inside = 0
        for _, _, cs, cd in calls:
            i = bisect.bisect_right(starts, cs) - 1
            if i >= 0 and cs + cd <= own[i][1]:
                inside += 1
        return inside

    def launches(self, match=None) -> list:
        """The stretch's runtime calls that launch kernels
        (``cudaLaunchKernel*``), or, given ``match``, those that launched
        a device operation whose name ``match`` accepts (by correlation
        id)."""
        if match is None:
            lo, hi = self.host_stretch()
            return [h for h in self.host
                    if h[0].startswith("cudaLaunchKernel")
                    and lo <= h[2] <= hi]
        want = {c for (name, *_), c in zip(self.device, self.device_corr)
                if c is not None and match(name)}
        return [h for h, c in zip(self.host, self.host_corr) if c in want]


def _corr(event: dict):
    return event.get("args", {}).get("correlation")


def parse_spans(trace: dict, steps: int, window_s: float,
                host_end: float | None = None,
                wall_end_ns: int | None = None) -> SpanTrace:
    """:func:`~h100bench.devtrace.parse_chrome`'s stretch of a Chrome
    trace, its operations and calls in the same order, with their
    correlation ids.  Given the host clock (``host_end``) and the wall
    clock (``wall_end_ns``) read together at the stretch's end, and a
    trace that gives its ``baseTimeNanoseconds``, it can place host-clock
    readings."""
    base = parse_chrome(trace, steps, window_s)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    ops = [(e["name"], e["cat"], float(e["ts"]) * 1e-6,
            float(e["dur"]) * 1e-6, _corr(e))
           for e in events if e.get("cat") in DEVICE_CATS]
    kept = [op for op in ops if op[2] + op[3] > base.t0]
    base_ns = trace.get("baseTimeNanoseconds")
    clock = None
    if None not in (host_end, wall_end_ns, base_ns):
        clock = (host_end - window_s, host_end, int(wall_end_ns),
                 int(base_ns))
    return SpanTrace(
        base.t0, base.t1, base.device, base.host, steps,
        device_corr=[op[4] for op in kept],
        host_corr=[_corr(e) for e in events if e.get("cat") in HOST_CATS],
        clock=clock, recorded=ops)


class SpanStretch(Stretch):
    """A :class:`~h100bench.devtrace.Stretch` that reads the host and the
    wall clock together after its closing synchronise, and returns a
    :class:`SpanTrace`."""

    def stop(self, steps: int) -> SpanTrace:
        import torch

        torch.cuda.synchronize()
        host_end = time.perf_counter()
        wall_end_ns = time.time_ns()
        window_s = host_end - self._t0
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        return parse_spans(trace, steps, window_s, host_end, wall_end_ns)


def program_spans(tracer, trace: SpanTrace | None) -> list:
    """The tracer's complete spans ``[(name, start, dur)]`` in seconds,
    the start put on ``trace``'s clock (on the host clock without one);
    empty where the tracer exposes no ``origin`` or the trace cannot
    place it."""
    origin = getattr(tracer, "origin", None)
    if origin is None:
        return []
    shift = origin if trace is None else trace.to_trace(origin)
    if shift is None:
        return []
    return [(sp.name, sp.ts + shift, sp.dur) for sp in tracer.spans()]


def span_checks(trace: SpanTrace, spans: list,
                aligned: SpanTrace | None) -> dict:
    """How well the program's spans sit on the trace's clock: the
    stretch's kernel launches lying inside a ``forward`` span, and the
    runtime calls of its device-to-host copies inside a
    ``service.readback`` span, each ``[inside, of]``; the stretch's idle
    seconds as recorded and, on ``aligned`` (the stretch aligned on the
    ``forward`` spans), the idle seconds ``idle_by_span`` shares out
    beside its own, and the device clock's offset from the host's at the
    first and the last anchor (seconds)."""
    launches = trace.launches()
    readbacks = trace.launches(lambda n: n.startswith("Memcpy DtoH"))
    out = {
        "launches_in_forward": [
            trace.calls_inside(spans, "forward", launches), len(launches)],
        "readbacks_in_readback": [
            trace.calls_inside(spans, "service.readback", readbacks),
            len(readbacks)],
        "idle_recorded_s": trace.window_s - trace.busy_s(),
    }
    if aligned is not None:
        out["idle_by_span_s"] = sum(s for _, s in aligned.idle_by_span(spans))
        out["idle_s"] = aligned.window_s - aligned.busy_s()
        out["offset_s"] = [aligned.offsets[0][1], aligned.offsets[-1][1]]
    return out


def enqueue_ms(spans: list) -> float | None:
    """The mean ``forward`` span, ms: the host's upload of the batch and
    its enqueue of every layer's ops, with no wait on the device (the
    traced forward synchronises nowhere).  ``None`` without one."""
    durs = [d for name, _, d in spans if name == "forward"]
    if not durs:
        return None
    return sum(durs) / len(durs) * 1e3


def service_host_ms(spans: list) -> float | None:
    """The service's own host work a step, ms: the ``service.stage``
    spans (admission into free slots, the slot buffer's numpy copies, the
    validity mask) and the ``service.complete`` spans (the per-slot
    completion loop), summed, over the ``service.step`` spans' count.
    ``None`` where either phase or the step is missing."""
    host = {"service.stage": 0.0, "service.complete": 0.0}
    seen, steps = set(), 0
    for name, _, d in spans:
        if name in host:
            host[name] += d
            seen.add(name)
        elif name == "service.step":
            steps += 1
    if len(seen) < len(host) or not steps:
        return None
    return sum(host.values()) / steps * 1e3


def forward_idle_ms(trace: SpanTrace | None, spans: list) -> float | None:
    """Device idle ms a step, over the stretch as the host clock timed
    it, that lies inside a ``forward`` span (at any depth: the upload, a
    layer): the device waiting on the host's launches.  The device's
    operations are read on the host's clock (:meth:`SpanTrace.aligned`).
    ``None`` without a placed trace or a ``forward`` span."""
    if trace is None or trace.steps <= 0:
        return None
    tr = trace.aligned(spans, "forward")
    if tr is None:
        return None
    fwd = sorted((s, s + d) for name, s, d in spans if name == "forward")
    idle, j = 0.0, 0
    for s, e in tr.gaps():  # both in time order
        while j < len(fwd) and fwd[j][1] <= s:
            j += 1
        k = j
        while k < len(fwd) and fwd[k][0] < e:
            idle += min(e, fwd[k][1]) - max(s, fwd[k][0])
            k += 1
    return idle / tr.steps * 1e3
