"""Readings that the limit of ``max_logit_err`` is set from.

    python3 h100bench/control.py --config <config> --seeds s1,s2,... \\
        [--out file.json]

For each seed, in one process: the run's seeded network and image pool
(as ``cell.run_cell`` makes them), the program's logits of every pool
image served through the timed entry (``InferenceService`` at the
configuration's ``batch_slots``), the float64 reference's, and the
control's, the reference in float32 with its operands rounded to TF32
(``reference.logits(..., tf32=True)``), plus the card's own TF32 (the
reference in float32 with TF32 switched on in cuDNN and cuBLAS).  Prints
``max_logit_err`` of each against the float64 reference, one JSON line a
seed.  The program's readings over a dozen seeds give the limit's lower
reading, the control's its upper one (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(config: dict, mix: dict, seed: int, device) -> dict:
    """``max_logit_err`` of the program, the TF32 control and the card's
    TF32 against the float64 reference, over one seed's image pool."""
    import numpy as np
    import torch

    from h100bench import check, generator, reference, synth
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
           "program": float(check.logit_errors(served, ref).max()),
           "control_tf32": float(check.logit_errors(
               reference.logits(config, params, pool, tf32=True).numpy(),
               ref).max())}
    if torch.device(device).type == "cuda":
        p32 = {k: {n: t.float() for n, t in v.items()}
               for k, v in params.items()}
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.no_grad():
                card = torch.cat([
                    reference.forward(config, p32, pool[s:s + 16]).cpu()
                    for s in range(0, len(pool), 16)]).double().numpy()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        out["card_tf32"] = float(check.logit_errors(card, ref).max())
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
        print("control.py: no CUDA device", file=sys.stderr)
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
    summary = {
        "config": args.config, "seeds": len(rows),
        "limit": config["limits"]["max_logit_err"],
        "program_max": max(r["program"] for r in rows),
        "control_tf32_min": min(r["control_tf32"] for r in rows),
        "card_tf32_min": min(r.get("card_tf32", float("nan")) for r in rows),
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary,
                                              "rows": rows}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
