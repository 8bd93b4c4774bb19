"""Batched serving driver of the PyTorch port (twin of
``examples/serve_decode.py``): a smoke model serves batched requests
through the slot-based continuous-batching loop.

  PYTHONPATH=src python examples/serve_decode_torch.py [--arch granite_3_2b]
      [--device cpu]

``--device`` is where it runs: ``cuda`` by default (raising without a
card; every prefill's attention goes through the flash kernel there),
``cpu`` when asked (the kernels' plain versions).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import count_params, init_params
from repro_torch.runtime.serve import ServeConfig, ServeLoop
from repro_torch.serve.api import Request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    dev = resolve_device(None if args.device == "cuda" else "cpu")
    cfg = get_smoke_config(args.arch)
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"{cfg.name}: {count_params(params):,} params")

    scfg = ServeConfig(
        batch_slots=args.slots,
        max_seq=args.prompt_len + args.new_tokens + 8,
        eos_id=-1,
    )
    loop = ServeLoop(cfg, statics, params, scfg, device=dev)

    rng = np.random.default_rng(0)
    reqs = [
        Request(
            prompt=rng.integers(1, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for _ in range(args.requests)
    ]
    t0 = time.time()
    loop.generate(reqs)
    dt = time.time() - t0
    total = sum(len(r.output) for r in reqs)
    print(f"{len(reqs)} requests x {args.new_tokens} tokens "
          f"({args.slots} slots): {total} tokens in {dt:.2f}s "
          f"= {total/dt:.1f} tok/s")
    for i, r in enumerate(reqs[:3]):
        print(f"request {i}: {r.output[:10]}...")


if __name__ == "__main__":
    main()
