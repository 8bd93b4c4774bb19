"""Readings that an int8 configuration's ``max_logit_err`` limit is set
from.

    python3 h100bench/control_quant.py --config <config> --seeds s1,s2,... \\
        [--mix bulk] [--out file.json]

For each seed, in one process: the run's seeded network and image pool
(as ``cell.run_cell`` makes them), and ``max_logit_err`` against the
float64 unquantized reference (``reference.logits``) of

  * ``program``: the program's logits of every pool image, served
    through the timed entry (``InferenceService`` at the
    configuration's ``batch_slots`` and precision);
  * ``ref_q8``: the plain quantized reference at 8 bits
    (``reference_quant.logits(..., bits=8)``), what a correct int8
    program reads;
  * ``ref_q4``: the same at 4 bits, the control one step below int8.

One JSON line a seed, then a summary line.  The program's worst reading
over a dozen seeds is the limit's lower reading, the 4-bit control's
least its upper one (``PERF.md``); a program far above ``ref_q8`` is a
fault of the program.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BITS = {"ref_q8": 8, "ref_q4": 4}


def readings(config: dict, mix: dict, seed: int, device) -> dict:
    """``max_logit_err`` of the program and of the quantized references
    against the float64 reference, over one seed's image pool."""
    import numpy as np

    from h100bench import check, generator, reference, reference_quant, synth
    from h100bench.cell import build_program, build_service
    from repro_torch.serve.api import Request

    slots = int(config["service"]["batch_slots"])
    bits = synth.network_patterns(config)
    params = synth.device_weights(config, bits, generator.sub_seed(seed, 1),
                                  device)
    shape = (int(config["conv_channels"][0][0]), int(config["input_hw"]),
             int(config["input_hw"]))
    pool = generator.image_pool(generator.pool_size(mix, slots), shape,
                                generator.sub_seed(seed, 2), device)
    svc = build_service(build_program(config, params, bits, device), config,
                        device)
    reqs = svc.serve([Request(image=img) for img in pool.cpu().numpy()])
    served = np.stack([r.logits for r in reqs])
    del svc, reqs
    ref = reference.logits(config, params, pool).numpy()
    out = {"seed": seed, "images": int(len(ref)),
           "program": float(check.logit_errors(served, ref).max())}
    for name, b in BITS.items():
        q = reference_quant.logits(config, params, pool, bits=b).numpy()
        out[name] = float(check.logit_errors(q, ref).max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--mix", default="bulk")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("control_quant.py: no CUDA device", file=sys.stderr)
        return 3
    from h100bench.registry import BENCH_DIR, read_json

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = read_json(BENCH_DIR / "configs" / f"{args.config}.json")
    mix = read_json(BENCH_DIR / "traffic" / f"{args.mix}.json")
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        row = readings(config, mix, seed, torch.device("cuda", 0))
        rows.append(row)
        print(json.dumps(row), flush=True)
    limit = config["limits"]["max_logit_err"]
    summary = {
        "config": args.config, "seeds": len(rows), "limit": limit,
        "device": torch.cuda.get_device_name(0),
        "program_max": max(r["program"] for r in rows),
        "ref_q8_max": max(r["ref_q8"] for r in rows),
        "ref_q4_min": min(r["ref_q4"] for r in rows),
    }
    summary["margin_above_program"] = limit / summary["program_max"]
    summary["margin_below_q4"] = summary["ref_q4_min"] / limit
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary,
                                              "rows": rows}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
