#!/usr/bin/env python3
"""Time a split kernel at every VGG16 layer under a grid of plans, on one
GPU.

    python3 scripts/spmm_plan_sweep.py [--kernel fp32|int8|ou_mvm]
                                       [--seed N] [--out FILE]

Compiles the synthetic pattern-pruned VGG16 of ``chip_smoke.py`` (block =
tile = 128) on the card and, at each layer's serving shape (8 batch
slots), times the kernel with the plan its wrapper picks and with every
plan of the grid:

- ``fp32`` (default): ``pattern_spmm_cuda`` under each block tile of
  ``_TILE_SHAPES`` that fits the tile width and each distinct split count
  ``ceil(k_max / chunk)`` for chunk = 1..k_max; ``x @ W`` beside it;
- ``int8``: ``pattern_spmm_quant_cuda`` (the int8 program, K-major
  bricks made once) under each block tile of ``_QUANT_TILE_SHAPES`` and
  the same split counts; its worst ``max|d| / max|plain|`` beside;
- ``ou_mvm``: ``ou_mvm_cuda`` on each conv's dense weight at the centre
  patch of ``chip_smoke.ou_cases`` under its one plan (a 4-column slab
  a block); ``x @ w`` beside it.

Each timing is ``chip_smoke.device_ms`` (median of 20 calls, L2 flushed,
device asleep while the host enqueues).  The default plan is also run
under ``torch.profiler`` (10 calls, L2 flushed before each) for the
kernels' own device time, without the launch floor the events see: for
the spmm kernels split between the walk and the reduction
(``split_reduce_kernel``), for ``ou_mvm`` beside ``x @ w``'s gemv
kernel.  Prints one JSON object per layer and a
summary (default plan against the best of the grid, summed over the
layers); the whole result goes to ``--out``.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_ms(fn, dev, names: dict, calls: int = 10) -> dict:
    """Mean device ms per call of the kernels ``fn`` launches, by
    ``torch.profiler`` with the L2 flushed before each call: {label: ms}
    summed over the kernels whose name holds ``names[label]``."""
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
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for label, pattern in names.items():
            if pattern in e.key:
                total = getattr(e, "device_time_total", None)
                if total is None:
                    total = e.cuda_time_total
                out[label] += total / calls / 1e3
    return out


def spmm_layers(kind, cases, dev) -> list[dict]:
    """The grid of plans at every layer of ``cases`` for the fp32
    (``kind`` "fp32") or int8 spmm kernel."""
    import torch

    import chip_smoke as cs
    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels import pattern_spmm as tk

    fp32 = kind == "fp32"
    shapes = tk._TILE_SHAPES if fp32 else tk._QUANT_TILE_SHAPES
    planner = tk._split_plan if fp32 else tk._quant_plan
    layers = []
    for name, bp, x in cases:
        m = x.shape[0]
        nnz = torch.as_tensor(bp.nnz, dtype=torch.int32, device=dev)
        if fp32:
            args = (x, bp.w_comp, bp.block_ids, nnz, bp.block)
            want = tk.pattern_spmm_plain(*args)

            def call(plan=None):
                return tk.pattern_spmm_cuda(*args, plan=plan)
        else:
            xq, _ = quantize_rows(x)
            args = (xq, bp.w_comp, bp.block_ids, bp.w_scales, nnz, bp.block)
            wk = tk.kmajor_bricks(bp.w_comp)
            want = tk.pattern_spmm_quant_plain(*args)

            def call(plan=None):
                return tk.pattern_spmm_quant_cuda(*args, w_kmajor=wk,
                                                  plan=plan)
        default = planner(m, bp.n_tiles, bp.tile, bp.k_max)
        scale = max(float(want.abs().max()), 1e-30)
        grid = []
        counts = sorted({-(-bp.k_max // c) for c in range(1, bp.k_max + 1)})
        for config, (bm, bn, bk) in enumerate(shapes):
            if (bn == 32) != (bp.tile <= 32):
                continue
            base = -(-m // bm) * bp.n_tiles * -(-bp.tile // bn)
            for splits in counts:
                plan = tk.SplitPlan(config, bm, bn, bk, splits,
                                    -(-bp.k_max // splits), base * splits)
                err = float((call(plan) - want).abs().max())
                ms = cs.device_ms(lambda plan=plan: call(plan), dev)
                grid.append({"config": config, "tile_rows": bm,
                             "tile_cols": bn, "step_depth": bk,
                             "splits": splits, "blocks": plan.blocks,
                             "ms": ms, "max_abs_diff": err,
                             "rel": err / scale})
        kname = "pattern_spmm_cuda" if fp32 else "pattern_spmm_quant_cuda"
        nbytes, ops = cs.cost(kname, bp, m)
        best = min(grid, key=lambda r: r["ms"])
        chosen = next(r for r in grid if r["config"] == default.config
                      and r["splits"] == default.splits)
        chosen["profiled_ms"] = kernel_ms(call, dev, {
            "split_walk": ("pattern_spmm_f32_kernel" if fp32
                           else "pattern_spmm_i8_kernel"),
            "reduce": "split_reduce_kernel"})
        row = {"layer": name, "m": m, "k": bp.k_in, "n": bp.n_out,
               "tiles": bp.n_tiles, "k_max": bp.k_max, "ops": ops,
               "bytes": nbytes, "default": chosen, "best": best,
               "grid": grid}
        if fp32:
            wd = bp.dense()[:, torch.as_tensor(bp.new_order, device=dev)
                            .long()].contiguous()
            row["library_ms"] = cs.device_ms(lambda: x @ wd, dev)
        layers.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "grid"}),
              flush=True)
    return layers


def ou_layers(cases, dev) -> list[dict]:
    """The kernel's one plan at each conv's centre patch, beside
    ``x @ w``."""
    import chip_smoke as cs
    from repro_torch.kernels import ou_mvm as tou

    layers = []
    for name, x, w, r, c in cases:
        if not name.endswith("/centre"):
            continue
        rows, cols = w.shape
        plan = tou._ou_plan(rows, cols, tou._ou_vec(w))
        nbytes, _ = cs.ou_cost(x, w, r)
        ms = cs.device_ms(lambda: tou.ou_mvm_cuda(x, w, r, c), dev)
        chosen = {**plan._asdict(), "ms": ms,
                  "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                  "max_abs_diff": float((tou.ou_mvm_cuda(x, w, r, c)
                                         - tou.ou_mvm_plain(x, w, r, c))
                                        .abs().max()),
                  "profiled_ms": kernel_ms(
                      lambda: tou.ou_mvm_cuda(x, w, r, c), dev,
                      {"kernel": "ou_mvm_f32_kernel"})["kernel"]}
        row = {"layer": name, "r": rows, "c": cols, "bytes": nbytes,
               "default": chosen, "best": chosen,
               "library_ms": cs.device_ms(lambda: x @ w, dev),
               "library_profiled_ms": kernel_ms(
                   lambda: x @ w, dev, {"kernel": "gemv"})["kernel"],
               "grid": [chosen]}
        layers.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "grid"}),
              flush=True)
    return layers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("fp32", "int8", "ou_mvm"),
                    default="fp32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="default: build/<kernel>_plan_sweep.json")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(ROOT, "build",
                                   f"{args.kernel}_plan_sweep.json")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("spmm_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.engine import CompileOptions, compile_network
    from repro_torch.models.cnn import params_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, params, bits = cs.build_model(args.seed)
    precision = "int8" if args.kernel == "int8" else "fp32"
    prog = compile_network(cfg, params_from_numpy(params, dev), bits,
                           options=CompileOptions(precision=precision),
                           device=dev)
    if args.kernel == "ou_mvm":
        images = np.random.default_rng(args.seed + 3).normal(
            size=(1, cfg.conv_channels[0][0], cfg.input_hw, cfg.input_hw)
        ).astype(np.float32)
        layers = ou_layers(cs.ou_cases(prog, params, images, dev), dev)
    else:
        cases = cs.layer_cases(prog, np.random.default_rng(args.seed + 2),
                               dev)
        layers = spmm_layers(args.kernel, cases, dev)
    res = {"kernel": args.kernel, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi(),
           "default_ms": sum(r["default"]["ms"] for r in layers),
           "best_ms": sum(r["best"]["ms"] for r in layers),
           "library_ms": (sum(r["library_ms"] for r in layers)
                          if "library_ms" in layers[0] else None),
           "max_abs_diff": max(g["max_abs_diff"] for r in layers
                               for g in r["grid"]),
           "layers": layers}
    if args.kernel == "int8":
        res["max_rel"] = max(g["rel"] for r in layers for g in r["grid"])
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "layers"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
