"""The rate sweep that fixes an open-loop mix's rate.

    python3 h100bench/sweep.py --config <config> --mix <open mix> \\
        --rates r1,r2,... [--seconds 8] [--seed n] [--out file.json]

One process, one set-up (as a run's), then the open-loop window of
``--seconds`` at each rate in turn, with the mix's other parameters.
For each rate it prints the offered and completed rates, the p50 and p95
of first results (from due time) and the drain after the last request was
due.  A rate is sustained when no backlog builds: the window and its
drain complete at least 98 % of the offered rate, and the drain takes at
most three mean step intervals.  The highest sustained rate is the
highest below the lowest rate that is not; the mix's file takes 0.8 x it,
written in by hand (``PERF.md`` keeps the table).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--mix", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA device", file=sys.stderr)
        return 3
    from h100bench import generator, synth
    from h100bench.cell import (_Profile, _warm, build_program,
                                build_service, serve_open)
    from h100bench.registry import BENCH_DIR, read_json

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = read_json(BENCH_DIR / "configs" / f"{args.config}.json")
    mix = read_json(BENCH_DIR / "traffic" / f"{args.mix}.json")
    dev = torch.device("cuda", 0)
    slots = int(config["service"]["batch_slots"])
    bits = synth.network_patterns(config)
    params = synth.device_weights(config, bits, generator.sub_seed(args.seed, 1),
                                  dev)
    shape = (int(config["conv_channels"][0][0]), int(config["input_hw"]),
             int(config["input_hw"]))
    pool = generator.image_pool(generator.pool_size(mix, slots), shape,
                              generator.sub_seed(args.seed, 2), dev)
    pool_np = pool.cpu().numpy()
    svc = build_service(build_program(config, params, bits, dev), config,
                        dev)
    _warm(svc, pool_np, slots, False)
    indices = generator.image_indices(len(pool_np),
                                    generator.sub_seed(args.seed, 3))
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        offsets = generator.arrival_offsets({**mix, "rate_per_s": rate},
                                          args.seconds)
        svc.reset_metrics()
        t0 = time.perf_counter()
        win = serve_open(svc, pool_np, indices, offsets, _Profile(False, 0))
        lat = (win.done - win.due) * 1e3
        last_due = float(win.due.max())
        drain = float(win.done.max()) - last_due
        interval = (last_due - t0) / max(win.steps, 1)
        done_rate = win.images / win.seconds
        row = {"rate_per_s": rate, "requests": int(win.images),
               "completed_per_s": done_rate,
               "first_result_p50_ms": float(np.percentile(lat, 50)),
               "first_result_p95_ms": float(np.percentile(lat, 95)),
               "drain_ms": drain * 1e3,
               "mean_step_interval_ms": interval * 1e3,
               "occupancy_mean": svc.metrics["occupancy_mean"],
               "sustained": (done_rate >= 0.98 * rate
                             and drain <= 3 * interval)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = []  # sustained rates below the lowest one that is not
    for r in sorted(rows, key=lambda r: r["rate_per_s"]):
        if not r["sustained"]:
            break
        ok.append(r["rate_per_s"])
    res = {"config": args.config, "mix": args.mix, "seconds": args.seconds,
           "device": torch.cuda.get_device_name(dev), "rows": rows,
           "highest_sustained": max(ok) if ok else None}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
