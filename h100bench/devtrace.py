"""A profiled stretch of the window, read from ``torch.profiler``'s trace.

The profiler records the device only (CUDA activity: kernels, copies,
memsets, and the runtime calls the host made); recording every host op
as well doubled a CIFAR-10 step's host time.  It runs over the stretch
alone: :meth:`Stretch.start` starts it at a step boundary and syncs the
device, :meth:`Stretch.stop`, once the window is over, syncs, takes the
stretch's length on the host clock, stops the profiler, exports the
Chrome trace to a temporary file, reads it and deletes it.  (Marking the
stretch with a kernel of its own at each end proved unreliable on the
card: such one-cycle kernels went missing from some traces.)
:class:`DeviceTrace` holds what was read:

  * device operations with their names, start and duration;
  * the host's runtime calls (launches, copies, syncs), to say what the
    host was doing while the device sat idle.

Trace times are seconds on the trace's clock; the stretch ends with its
last device operation and is as long as the host clock measured.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
import warnings
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
__all__ = ["DeviceTrace", "Stretch", "short_name", "parse_chrome"]


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments or
    parameters: ``void ns::k<4, 2>(float*)`` -> ``ns::k``; a copy's or
    memset's name (no ``::``) whole."""
    if "::" not in name:
        return name
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


class DeviceTrace:
    """Device operations and host events of one profiled stretch."""

    def __init__(self, t0: float, t1: float, device: list, host: list,
                 steps: int):
        self.t0, self.t1 = t0, t1
        self.device = device  # [(name, cat, start, dur)], clipped
        self.host = host  # [(name, cat, start, dur)]
        self.steps = steps

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def _merged(self) -> list[tuple[float, float]]:
        spans = sorted((s, s + d) for _, _, s, d in self.device)
        out: list[list[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return sum(e - s for s, e in self._merged())

    def seconds_where(self, match) -> tuple[float, int]:
        """(summed device seconds, count) of operations whose full name
        ``match(name)`` accepts."""
        tot, n = 0.0, 0
        for name, _, _, d in self.device:
            if match(name):
                tot += d
                n += 1
        return tot, n

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations (by short name) taking most time."""
        by = defaultdict(float)
        for name, _, _, d in self.device:
            by[short_name(name)] += d
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])][:k]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle device time summed by what the host was doing: each gap
        between device operations goes to the shortest host event that
        covers its middle (``python`` where none does)."""
        busy = self._merged()
        edges = [self.t0] + [x for se in busy for x in se] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda h: h[2])
        by = defaultdict(float)
        active: list = []  # heap of (dur, end, name): the shortest on top
        j = 0
        for s, e in gaps:  # in time order, so an event once ended stays so
            mid = 0.5 * (s + e)
            while j < len(host) and host[j][2] <= mid:
                name, _, hs, hd = host[j]
                heapq.heappush(active, (hd, hs + hd, name))
                j += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            by[active[0][2] if active else "python"] += e - s
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])][:k]


def parse_chrome(trace: dict, steps: int, window_s: float) -> DeviceTrace:
    """The stretch of a Chrome trace exported by ``torch.profiler``: the
    ``window_s`` seconds that end with its last device operation."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    ops = [(e["name"], e["cat"], float(e["ts"]) * 1e-6,
            float(e["dur"]) * 1e-6)
           for e in events if e.get("cat") in DEVICE_CATS]
    if not ops:
        raise RuntimeError("the trace holds no device operation")
    t1 = max(s + d for _, _, s, d in ops)
    t0 = t1 - window_s
    device = [(n, c, max(s, t0), min(s + d, t1) - max(s, t0))
              for n, c, s, d in ops if s + d > t0]
    host = [(e["name"], e["cat"], float(e["ts"]) * 1e-6,
             float(e["dur"]) * 1e-6)
            for e in events if e.get("cat") in HOST_CATS]
    return DeviceTrace(t0, t1, device, host, steps)


def _sync() -> None:
    import torch

    torch.cuda.synchronize()


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


class Stretch:
    """Profile the device over the steps between :meth:`start` and
    :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0

    @staticmethod
    def warm(fn) -> None:
        """Run ``fn`` under a throwaway profiler, so the profiler's own
        start-up (CUPTI) is paid in set-up, not inside the window."""
        with _profiler():
            fn()
            _sync()

    def start(self) -> None:
        import torch

        self._prof = _profiler()
        with warnings.catch_warnings():
            # a second profiler in one process warns that it starts clean
            warnings.simplefilter("ignore", UserWarning)
            self._prof.start()
        # the first launch after the profiler starts can take milliseconds
        # (seen on the card): a one-cycle kernel takes it before the
        # stretch's clock starts
        torch.cuda._sleep(1)
        _sync()
        self._t0 = time.perf_counter()

    def stop(self, steps: int) -> DeviceTrace:
        """Close the stretch of ``steps`` steps, stop the profiler and read
        it."""
        _sync()
        window_s = time.perf_counter() - self._t0
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
        return parse_chrome(trace, steps, window_s)
