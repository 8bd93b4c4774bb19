#!/usr/bin/env python3
"""Where the CNN forward's time goes on one GPU (the PyTorch port).

    python3 scripts/profile_forward_torch.py [--seed N] [--forwards N]
                                             [--out FILE]

Compiles the synthetic pattern-pruned VGG16 of ``chip_smoke.py`` (block =
tile = 128) on the card in fp32 and in int8 and, for each, runs
``--forwards`` forwards of 8 images through ``make_forward`` twice in a
row: first timed on the host clock alone (ending in a device sync), then
traced with ``torch.profiler`` (``scripts/profile_generate_torch.py``'s
``window``).  For each precision it prints the wall times, the device's
busy time in the trace (one stream, so the kernels do not overlap), the
idle share against each wall time, the kernel launches, and the kernels
that take the most device time, each also per forward.  One JSON object
on stdout, also written to ``--out``.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--forwards", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "profile_forward.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_forward_torch: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from profile_generate_torch import window
    from repro_torch.engine import CompileOptions, compile_network, make_forward
    from repro_torch.models.cnn import params_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, params, bits = cs.build_model(args.seed)
    tparams = params_from_numpy(params, dev)
    images = np.random.default_rng(args.seed + 3).normal(
        size=(BATCH, cfg.conv_channels[0][0], cfg.input_hw, cfg.input_hw)
    ).astype(np.float32)
    res = {"model": "vgg16 cifar10 (synthesize_network)", "batch": BATCH,
           "forwards": args.forwards,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi()}
    for precision in ("fp32", "int8"):
        prog = compile_network(cfg, tparams, bits,
                               options=CompileOptions(precision=precision),
                               device=dev)
        fwd = make_forward(prog, device=dev)
        for _ in range(3):
            fwd(images)  # warm: kernels built, tables on the card

        def forwards(fwd=fwd):
            for _ in range(args.forwards):
                fwd(images)

        w = window(forwards)
        for key in ("untraced_wall_ms", "wall_ms", "device_busy_ms"):
            w[key + "_per_forward"] = w[key] / args.forwards
        w["launches_per_forward"] = w["kernel_launches"] / args.forwards
        res[precision] = w
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
