#!/usr/bin/env python3
"""Time the fp32 pattern-spmm kernel at every VGG16 layer under a grid of
split plans, on one GPU.

    python3 scripts/spmm_plan_sweep.py [--seed N] [--out FILE]

Compiles the synthetic pattern-pruned VGG16 of ``chip_smoke.py`` (fp32,
block = tile = 128) on the card and, at each layer's serving shape
(8 batch slots), times ``pattern_spmm_cuda`` with the plan
``_split_plan`` picks and with every (block tile, split count) the layer
allows: each block tile of ``_TILE_SHAPES`` that fits the tile width,
each distinct split count ``ceil(k_max / chunk)`` for chunk = 1..k_max.
Each timing is ``chip_smoke.device_ms`` (median of 20 calls, L2 flushed,
device asleep while the host enqueues).  The default plan is also run
under ``torch.profiler`` (10 calls, L2 flushed before each) to split its
device time between the two kernels of a call: the split walk
(``pattern_spmm_f32_kernel``) and the reduction (``split_reduce_kernel``).
Prints one JSON object per layer and a summary (default plan against the
best of the grid, summed over the 14 layers, beside ``x @ W``); the
whole result goes to ``--out``.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_split(fn, dev, calls: int = 10) -> dict:
    """Mean device ms per call of each kernel ``fn`` launches, by
    ``torch.profiler``: {"split_walk": ms, "reduce": ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 18, dtype=torch.float32, device=dev)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {"split_walk": 0.0, "reduce": 0.0}
    for e in prof.key_averages():
        key = ("split_walk" if "pattern_spmm_f32_kernel" in e.key
               else "reduce" if "split_reduce_kernel" in e.key else None)
        if key:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            out[key] += total / calls / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "spmm_plan_sweep.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("spmm_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.engine import CompileOptions, compile_network
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.models.cnn import params_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, params, bits = cs.build_model(args.seed)
    prog = compile_network(cfg, params_from_numpy(params, dev), bits,
                           options=CompileOptions(), device=dev)
    cases = cs.layer_cases(prog, np.random.default_rng(args.seed + 2), dev)
    layers = []
    for name, bp, x in cases:
        m = x.shape[0]
        nnz = torch.as_tensor(bp.nnz, dtype=torch.int32, device=dev)
        default = tk._split_plan(m, bp.n_tiles, bp.tile, bp.k_max)
        want = tk.pattern_spmm_plain(x, bp.w_comp, bp.block_ids, nnz,
                                     bp.block)
        grid = []
        counts = sorted({-(-bp.k_max // c) for c in range(1, bp.k_max + 1)})
        for config, (bm, bn, bk) in enumerate(tk._TILE_SHAPES):
            if (bn == 32) != (bp.tile <= 32):
                continue
            base = -(-m // bm) * bp.n_tiles * -(-bp.tile // bn)
            for splits in counts:
                plan = tk.SplitPlan(config, bm, bn, bk, splits,
                                    -(-bp.k_max // splits), base * splits)
                y = tk.pattern_spmm_cuda(x, bp.w_comp, bp.block_ids, nnz,
                                         bp.block, plan=plan)
                err = float((y - want).abs().max())
                ms = cs.device_ms(
                    lambda plan=plan: tk.pattern_spmm_cuda(
                        x, bp.w_comp, bp.block_ids, nnz, bp.block,
                        plan=plan), dev)
                grid.append({"config": config, "tile_rows": bm,
                             "tile_cols": bn, "step_depth": bk,
                             "splits": splits, "blocks": plan.blocks,
                             "ms": ms, "max_abs_diff": err})
        wd = bp.dense()[:, torch.as_tensor(bp.new_order, device=dev)
                        .long()].contiguous()
        _, ops = cs.cost("pattern_spmm_cuda", bp, m)
        best = min(grid, key=lambda r: r["ms"])
        chosen = next(r for r in grid if r["config"] == default.config
                      and r["splits"] == default.splits)
        chosen["profiled_ms"] = kernel_split(
            lambda: tk.pattern_spmm_cuda(x, bp.w_comp, bp.block_ids, nnz,
                                         bp.block), dev)
        row = {"layer": name, "m": m, "k": bp.k_in, "n": bp.n_out,
               "tiles": bp.n_tiles, "k_max": bp.k_max, "ops": ops,
               "default": chosen, "best": best,
               "library_ms": cs.device_ms(lambda: x @ wd, dev), "grid": grid}
        layers.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "grid"}),
              flush=True)
    res = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi(),
           "default_ms": sum(r["default"]["ms"] for r in layers),
           "best_ms": sum(r["best"]["ms"] for r in layers),
           "library_ms": sum(r["library_ms"] for r in layers),
           "max_abs_diff": max(g["max_abs_diff"] for r in layers
                               for g in r["grid"]),
           "layers": layers}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "layers"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
