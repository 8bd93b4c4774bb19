#!/usr/bin/env python3
"""Where the generation path's time goes on one GPU (the PyTorch port).

    python3 scripts/profile_generate_torch.py [--seed N] [--out FILE]

Builds the model ``chip_smoke.py``'s ``generate`` phase serves
(h2o-danube-1.8B at full width and depth, pattern-sparse MLPs, bf16
weights drawn on the card from the seed) behind ``DecodeService`` with
8 slots and a 6144-token cache, fills every slot, then measures two
windows: ``DECODE_STEPS`` decode steps with all 8 slots live, and the
prefill of one 4500-token prompt.  Each window runs twice in a row:
first timed on the host clock alone (ending in a device sync), then
traced with ``torch.profiler``.  For each it prints both wall times, the
device's busy time in the trace (the sum of the kernels' device time;
one stream, so they do not overlap), the idle share against each wall
time (the traced one carries the profiler's own host cost), the kernel
launches, and the kernels that take the most device time.  One JSON
object on stdout, also written to ``--out``.  Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCFG = dict(batch_slots=8, max_seq=6144, eos_id=-1)
DECODE_STEPS = 10
LONG = 4500
TOP = 10


def window(fn) -> dict:
    """Run ``fn`` twice: timed alone, then traced.  Host wall ms of each,
    device busy ms in the trace, the idle share against each wall time,
    launches, and the top kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "untraced_wall_ms": untraced,
        "wall_ms": wall,
        "device_busy_ms": busy,
        "idle_share_untraced": 1.0 - busy / untraced if busy else None,
        "idle_share": 1.0 - busy / wall if busy else None,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:120], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:TOP]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "profile_generate.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_generate_torch: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.serve import DecodeService, ServeConfig
    from repro_torch.serve.api import Request

    dev = torch.device("cuda", 0)
    cfg = h2o_danube_1_8b.config(sparse=True)
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    scfg = ServeConfig(**SCFG)
    svc = DecodeService(cfg, statics, params, scfg, device=dev)
    rng = np.random.default_rng(args.seed)
    for n in rng.integers(16, 1025, scfg.batch_slots):
        svc.submit(Request(prompt=rng.integers(1, cfg.vocab, int(n)),
                           max_new_tokens=2 * DECODE_STEPS + 8))
    svc.step()  # every slot admitted: prefills, then one decode step
    svc.step()  # warm
    live = len(svc.scheduler.live())

    def decode_steps():
        for _ in range(DECODE_STEPS):
            svc.step()

    res = {"model": cfg.name, "serve_config": SCFG, "live_slots": live,
           "device": torch.cuda.get_device_name(0)}
    res["decode"] = window(decode_steps)
    res["decode"]["steps"] = DECODE_STEPS
    svc.run()

    def long_prefill():
        svc.submit(Request(prompt=rng.integers(1, cfg.vocab, LONG),
                           max_new_tokens=1))
        svc.step()

    res["prefill"] = window(long_prefill)
    res["prefill"]["prompt_len"] = LONG
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
