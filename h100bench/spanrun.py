"""Run one cell of ``BENCHMARK.json`` with the program's spans read
against the device trace: where the device's idle time lies by program
span, and which span launched each device operation.

    python3 h100bench/spanrun.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, on a CUDA device (without one it runs on
the CPU and reads the spans alone).  The set-up and the window are the
benchmark's own (``h100bench.cell``), traced: the program's tracer keeps
its complete spans and the window's last steps are profiled, through
:class:`h100bench.spantrace.SpanStretch`.  No check against the
reference: ``run.py --trace 1`` makes it on the same window.  The tables
and the mapping's checks go to standard error; the last line of standard
output is one JSON object: ``device``, ``steps`` (profiled), the span
readings ``enqueue_ms`` (mean ``forward`` span), ``service_host_ms``
(stage and completion a step), ``forward_idle_ms`` (device idle a step
inside a ``forward`` span) and ``step_ms`` (mean ``service.step`` span),
``checks``, ``idle_by_span`` and ``device_by_layer`` (seconds over the
profiled stretch).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def report(trace, spans: list, is_spmm) -> dict:
    """The mapping's checks and both tables of a profiled stretch (on the
    stretch aligned to the host clock), logged to standard error."""
    from h100bench import spantrace

    aligned = trace.aligned(spans, "forward")
    c = spantrace.span_checks(trace, spans, aligned)
    _log(f"span mapping: {c['launches_in_forward'][0]} of "
         f"{c['launches_in_forward'][1]} launches inside forward, "
         f"{c['readbacks_in_readback'][0]} of "
         f"{c['readbacks_in_readback'][1]} readbacks inside "
         f"service.readback")
    out = {"checks": c}
    if aligned is None:
        _log("program spans: none placed on the trace")
        return out
    steps = max(trace.steps, 1)
    idle = aligned.idle_by_span(spans)
    total = sum(s for _, s in idle) or 1.0
    _log(f"device clock minus host clock: {c['offset_s'][0] * 1e6:.1f} us "
         f"at the first step, {c['offset_s'][1] * 1e6:.1f} us at the last; "
         f"idle {c['idle_s']:.6f} s aligned ({c['idle_by_span_s']:.6f} s by "
         f"span), {c['idle_recorded_s']:.6f} s as recorded")
    _log(f"idle by program span (ms a step over {trace.steps} steps): "
         + ", ".join(f"{n} {s / steps * 1e3:.4f} ({100 * s / total:.1f} %)"
                     for n, s in idle))
    rows = sorted(aligned.device_by_layer(spans, is_spmm).items(),
                  key=lambda kv: -sum(kv[1]))
    _log("device by launching span (ms a step, spmm + rest): "
         + ", ".join(f"{n} {a / steps * 1e3:.4f} + {b / steps * 1e3:.4f}"
                     for n, (a, b) in rows))
    out["idle_by_span"] = idle
    out["device_by_layer"] = dict(rows)
    return out


def run_spans(cell, seed: int, seconds: float, device="cuda") -> dict:
    """Set up and serve ``cell`` as a traced benchmark run does, and read
    the program's spans against the profiled stretch (on the host clock
    alone where the device is not CUDA)."""
    import numpy as np
    import torch

    from h100bench import cell as bench
    from h100bench import generator, spantrace, synth
    from h100bench.registry import metric_reader

    config, mix = cell.config, cell.traffic
    dev = torch.device(device)
    slots = int(config["service"]["batch_slots"])
    shape = (int(config["conv_channels"][0][0]), int(config["input_hw"]),
             int(config["input_hw"]))
    bits = synth.network_patterns(config)
    params = synth.device_weights(config, bits, generator.sub_seed(seed, 1),
                                  dev)
    program = bench.build_program(config, params, bits, dev)
    pool = generator.image_pool(generator.pool_size(mix, slots), shape,
                                generator.sub_seed(seed, 2), dev)
    pool_np = pool.cpu().numpy()
    tracer = bench.SpanTracer(max_events=1 << 22)
    svc = bench.build_service(program, config, dev, tracer)
    profiled = dev.type == "cuda"
    bench._warm(svc, pool_np, slots, profiled)
    tracer.reset()
    indices = generator.image_indices(len(pool_np),
                                      generator.sub_seed(seed, 3))
    if profiled:
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    _log(f"set-up: {time.perf_counter() - T_START:.3f} s")

    prof = bench._Profile(profiled, generator.PROFILE_STEPS)
    if profiled:
        prof.stretch = spantrace.SpanStretch()
    if mix["arrivals"] == "backlog":
        win = bench.serve_backlog(svc, pool_np, indices, seconds,
                                  int(mix["backlog_batches"]) * slots, prof)
    elif mix["arrivals"] == "open":
        win = bench.serve_open(svc, pool_np, indices,
                               generator.arrival_offsets(mix, seconds), prof)
    else:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    gc.unfreeze()
    if tracer.dropped_events:
        raise RuntimeError(f"the tracer dropped {tracer.dropped_events} "
                           "events: the spans hold a part of the window")
    spans = spantrace.program_spans(tracer, win.trace)
    steps = [d for name, _, d in spans if name == "service.step"]
    out = {"device": (torch.cuda.get_device_name(dev) if profiled
                      else dev.type),
           "images": win.images,
           "steps": win.trace.steps if win.trace is not None else 0,
           "enqueue_ms": spantrace.enqueue_ms(spans),
           "service_host_ms": spantrace.service_host_ms(spans),
           "forward_idle_ms": spantrace.forward_idle_ms(win.trace, spans),
           "step_ms": float(np.mean(steps)) * 1e3 if steps else None}
    if win.trace is not None:
        out.update(report(win.trace, spans,
                          metric_reader("spmm_roofline").is_spmm))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from h100bench.registry import load_cell
    from h100bench.run import _environment

    _environment()
    cell = load_cell(args.workload)

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = run_spans(cell, args.seed, args.seconds, device)
    print(json.dumps({"workload": cell.name, "seed": args.seed, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
