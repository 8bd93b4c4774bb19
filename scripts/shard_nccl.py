#!/usr/bin/env python3
"""The sharded path over NCCL, one rank a card (the PyTorch port).

    python3 scripts/shard_nccl.py [--seed N]

Runs ``chip_smoke.py``'s ``shard`` phase with part (b) on the NCCL
backend over the visible cards, one rank a card: a 2 x 2 (data, model)
mesh on four cards, 1 x 2 on two or three.  Part (a) (the one-rank mesh)
and every gate are the phase's own: the synthetic VGG16 in fp32 and int8
served through ``InferenceService(mesh=...)`` by every rank against the
unsharded service on card 0, and flash-decode of full-width
granite-3-2b over the split cache.  Prints the cards' names and power
limits, then the phase's JSON line; exits non-zero when a gate fails.
Needs at least two CUDA devices and ``nvcc``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print("shard_nccl: needs at least two CUDA devices", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs

    from repro_torch.engine import CompileOptions, compile_network
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import params_from_numpy

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.SHARD_BACKEND = "nccl"
    cs.SHARD_MESH = (2, 2) if cards >= 4 else (1, 2)
    _build.build()
    dev = torch.device("cuda", 0)
    cfg, params, bits = cs.build_model(args.seed)
    tparams = params_from_numpy(params, dev)
    progs = [compile_network(cfg, tparams, bits,
                             options=CompileOptions(precision=p), device=dev)
             for p in ("fp32", "int8")]
    # the serve phase's requests
    images = np.random.default_rng(args.seed + 3).normal(
        size=(sum(cs.BURSTS), cfg.conv_channels[0][0], cfg.input_hw,
              cfg.input_hw)).astype(np.float32)
    cs.shard_phase(args.seed, dev, progs[0], progs[1], images)
    torch.distributed.destroy_process_group()  # part (a)'s one-rank group
    return 0


if __name__ == "__main__":
    sys.exit(main())
