"""One run of one cell: set-up, the measured window, the check.

This is the only module of the benchmark that drives the program
(``repro_torch``): it compiles the benchmark's seeded network with
``engine.lowering.compile_network`` and serves requests through
``engine.service.InferenceService`` (``submit`` / ``step``), the entry
the window times.  Everything it measures with comes from the yardstick
modules beside it.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time

import numpy as np
import torch

from h100bench import check, counts, generator, reference, synth
from h100bench.devtrace import DeviceTrace, Stretch
from h100bench.registry import Cell, metric_reader
from repro_torch.engine.lowering import CompileOptions, compile_network
from repro_torch.engine.service import InferenceService
from repro_torch.models.cnn import CNNConfig
from repro_torch.obs.trace import Tracer
from repro_torch.serve.api import Request

clock = time.perf_counter

__all__ = ["SpanTracer", "Window", "RunRecord", "cnn_config",
           "build_program", "build_service", "serve_backlog", "serve_open",
           "run_cell"]


class SpanTracer(Tracer):
    """The program's tracer, keeping its complete spans (``service.step``)
    and dropping the per-request async events and counter samples, whose
    recording would cost the traced run host time on every request."""

    def async_begin(self, *a, **k) -> None:
        pass

    def async_instant(self, *a, **k) -> None:
        pass

    def async_end(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass


@dataclasses.dataclass
class Window:
    """What the window served."""

    seconds: float  # host clock, from the window's start to its last result
    image_idx: np.ndarray  # pool image of each request served
    logits: np.ndarray  # [requests, classes] as served
    missing: int  # requests due that were never served
    steps: int  # service steps that served something
    due: np.ndarray | None = None  # open loop: due times (host clock)
    done: np.ndarray | None = None  # open loop: times the logits were held
    submit_lag: np.ndarray | None = None  # open loop: submit - due
    trace: DeviceTrace | None = None

    @property
    def images(self) -> int:
        return int(self.image_idx.size)


@dataclasses.dataclass
class RunRecord:
    """Everything a metric reader may read of one run."""

    cell: Cell
    batch_slots: int
    setup_s: float
    window: Window
    scheduler: dict  # SchedulerMetrics counters of the window
    step_spans: list  # seconds of each ``service.step`` span (traced runs)
    tracer_dropped: int
    nnz: dict  # nonzero weights per layer, the benchmark's own count
    peaks: dict | None  # published peaks of this device, if known

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def trace(self) -> DeviceTrace | None:
        return self.window.trace


def cnn_config(config: dict) -> CNNConfig:
    return CNNConfig(
        conv_channels=tuple(tuple(int(c) for c in ch)
                            for ch in config["conv_channels"]),
        pool_after=frozenset(int(i) for i in config["pool_after"]),
        num_classes=int(config["num_classes"]),
        input_hw=int(config["input_hw"]),
        kernel=int(config.get("kernel", 3)),
    )


def build_program(config: dict, params: dict, bits: dict, device):
    eng = config["engine"]
    if eng.get("mapping", "fixed") != "fixed":
        raise ValueError(f"unknown mapping {eng['mapping']!r}")
    opts = CompileOptions(block=int(eng["block"]), tile=int(eng["tile"]),
                          precision=eng["precision"])
    return compile_network(cnn_config(config), params, bits, options=opts,
                           device=device)


def build_service(program, config: dict, device, tracer=None):
    svc = config["service"]
    return InferenceService(program, batch_slots=int(svc["batch_slots"]),
                            collect_stats=bool(svc.get("collect_stats",
                                                       False)),
                            tracer=tracer, device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Profile:
    """A traced run's profiled stretch: the window's last ``steps`` steps
    (started once the steps left, at the window's mean step interval so
    far, are about ``steps``).  A backlog window ends with the stretch's
    last step; an open one runs on through its drain, which the stretch
    then holds too.  The profiler stops only after the window."""

    def __init__(self, on: bool, steps: int):
        self.on = on
        self.steps = steps
        self.stretch = Stretch() if on else None
        self.started = False
        self.count = 0

    def before(self, step: int, now: float, t0: float, end: float) -> None:
        if not self.on or self.started or step == 0:
            return
        if now + self.steps * (now - t0) / step >= end:
            self.stretch.start()
            self.started = True

    def after(self) -> None:
        if self.started:
            self.count += 1

    @property
    def done(self) -> bool:
        return self.started and self.count >= self.steps

    def close(self) -> DeviceTrace | None:
        if not self.started:
            return None
        return self.stretch.stop(self.count)


def serve_backlog(svc, pool_np, indices, seconds: float, backlog: int,
                  profile: _Profile) -> Window:
    """Keep at least ``backlog`` requests queued and step the service
    until ``seconds`` have passed (traced: until the profiled stretch,
    timed to end then, is complete); the window ends with its last
    step."""
    idx, out, ends = [], [], []
    steps = 0
    t0 = clock()
    end = t0 + seconds
    while True:
        while svc.scheduler.queued() < backlog:
            i = next(indices)
            req = Request(image=pool_np[i])
            req.bench_idx = i
            svc.submit(req)
        profile.before(steps, clock(), t0, end)
        finished = svc.step()
        t = clock()
        profile.after()
        steps += 1
        ends.append(t)
        for r in finished:
            idx.append(r.bench_idx)
            out.append(r.logits)
        if profile.done if profile.on else t >= end:
            break
    per_s = np.bincount((np.asarray(ends) - t0).astype(int)) * (
        len(idx) / max(steps, 1))
    _log("images by second of the window: "
         + " ".join(f"{v:.0f}" for v in per_s))
    return Window(seconds=t - t0, image_idx=np.asarray(idx, np.int64),
                  logits=np.stack(out), missing=0, steps=steps,
                  trace=profile.close())


def serve_open(svc, pool_np, indices, offsets: np.ndarray,
               profile: _Profile) -> Window:
    """Submit request ``i`` once ``offsets[i]`` seconds have passed,
    whatever the service is doing, step while there is work, and serve
    every request due, the drain included."""
    n = len(offsets)
    img = np.fromiter((next(indices) for _ in range(n)), np.int64, n)
    done = np.full(n, np.nan)
    lag = np.zeros(n)
    out: list = [None] * n
    steps = i = 0
    t0 = clock()
    due = t0 + offsets
    while i < n or svc.has_work():
        now = clock()
        while i < n and due[i] <= now:
            req = Request(image=pool_np[img[i]])
            req.bench_i = i
            svc.submit(req)
            lag[i] = clock() - due[i]
            i += 1
        if svc.has_work():
            profile.before(steps, now, t0, due[-1])
            finished = svc.step()
            t = clock()
            profile.after()
            steps += 1
            for r in finished:
                done[r.bench_i] = t
                out[r.bench_i] = r.logits
        elif i < n:
            wait = due[i] - clock()
            if wait > 0:
                time.sleep(wait)
    t_end = clock()
    served = [k for k in range(n) if out[k] is not None]
    return Window(seconds=t_end - t0, image_idx=img[served],
                  logits=np.stack([out[k] for k in served]),
                  missing=n - len(served), steps=steps, due=due[served],
                  done=done[served], submit_lag=lag,
                  trace=profile.close())


def _warm(svc, pool_np, batch_slots: int, profile: bool) -> None:
    """The serving path at its one shape, with real images: the fixed
    all-dead batch, two full steps, and (traced runs) one step under the
    profiler."""
    svc.warmup()
    svc.serve([Request(image=pool_np[i % len(pool_np)])
               for i in range(2 * batch_slots)])
    if profile:
        Stretch.warm(lambda: svc.serve(
            [Request(image=pool_np[i % len(pool_np)])
             for i in range(batch_slots)]))
    svc.reset_metrics()


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it, or ``None``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None) -> dict:
    """Run ``cell`` once and return its result line as a dict (without
    the driver's refusal checks, which ``run.py`` makes)."""
    t_start = clock() if t_start is None else t_start
    config, mix = cell.config, cell.traffic
    dev = torch.device(device)
    batch_slots = int(config["service"]["batch_slots"])
    shape = (int(config["conv_channels"][0][0]), int(config["input_hw"]),
             int(config["input_hw"]))

    # -- set-up: weights and images from the seed, compile, warm ---------
    bits = synth.network_patterns(config)
    params = synth.device_weights(config, bits, generator.sub_seed(seed, 1),
                                  dev)
    program = build_program(config, params, bits, dev)
    pool = generator.image_pool(generator.pool_size(mix, batch_slots), shape,
                              generator.sub_seed(seed, 2), dev)
    pool_np = pool.cpu().numpy()
    tracer = SpanTracer(max_events=1 << 22) if trace else None
    svc = build_service(program, config, dev, tracer)
    # the device is profiled only where there is one
    profiled = trace and dev.type == "cuda"
    _warm(svc, pool_np, batch_slots, profiled)
    if tracer is not None:
        tracer.reset()
    indices = generator.image_indices(len(pool_np), generator.sub_seed(seed, 3))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    # what set-up left alive is never garbage: keep the collector off it
    gc.collect()
    gc.freeze()
    setup_s = clock() - t_start

    # -- the window ---------------------------------------------------------
    prof = _Profile(profiled, generator.PROFILE_STEPS)
    if mix["arrivals"] == "backlog":
        win = serve_backlog(svc, pool_np, indices, seconds,
                            int(mix["backlog_batches"]) * batch_slots, prof)
    elif mix["arrivals"] == "open":
        offsets = generator.arrival_offsets(mix, seconds)
        win = serve_open(svc, pool_np, indices, offsets, prof)
        lag = win.submit_lag
        _log(f"generator lateness: p50 {np.percentile(lag, 50) * 1e3:.4f} ms"
             f", p95 {np.percentile(lag, 95) * 1e3:.4f} ms, max "
             f"{lag.max() * 1e3:.4f} ms over {lag.size} requests")
    else:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    m = svc.scheduler.metrics
    sched = {"queue_wait_sum": m.queue_wait_sum, "admitted": m.admitted,
             "completed": m.completed, "steps": m.steps,
             "occupancy_mean": m.occupancy_mean}
    spans, dropped = [], 0
    if tracer is not None:
        spans = [s.dur for s in tracer.spans() if s.name == "service.step"]
        dropped = tracer.dropped_events
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    run = RunRecord(cell=cell, batch_slots=batch_slots, setup_s=setup_s,
                    window=win, scheduler=sched, step_spans=spans,
                    tracer_dropped=dropped, nnz=counts.nnz_of(params),
                    peaks=counts.peaks_for(kind))

    # -- the check, once the program's state is freed -----------------------
    del svc, program, tracer
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    used = np.unique(win.image_idx)
    ref = np.zeros((len(pool_np), int(config["num_classes"])))
    ref[used] = reference.logits(config, params, pool[torch.as_tensor(
        used, device=dev)]).numpy()
    verdict = check.compare(win.logits, win.image_idx, ref, win.missing,
                            float(config["limits"]["max_logit_err"]))
    _log(f"reference: {len(used)} images in {clock() - t_ref:.3f} s")

    # -- the metrics of this kind of run --------------------------------------
    specs = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for spec in specs:
        value = metric_reader(spec["name"], cell.bench_dir).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        dev_info["power_limit"] = power_limit()
    result = {"correct": verdict["correct"],
              "attempted": win.images + win.missing,
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev_info}
    if trace and win.trace is not None:
        dev_info["busy_s"] = win.trace.busy_s()
        dev_info["window_s"] = win.trace.window_s
        result["breakdown"] = {"device_ops": win.trace.top_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["checks"] = verdict["checks"]
    return result
