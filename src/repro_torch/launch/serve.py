"""Serving launcher: batched generation over the slot-based ServeLoop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_3_2b \\
      --smoke --requests 16 --new-tokens 24 [--device cpu]

Port of ``src/repro/launch/serve.py``: the same flags, the same seeded
prompts (``default_rng(0)``), ``ServeConfig(eos_id=-1)`` so no request
stops early, ``runtime.serve.ServeLoop`` over ``serve.api.Request``s,
and the reference's three report lines.  ``--device`` is where it runs
(default ``cuda``, raising without a card; ``cpu`` when asked), and the
params are drawn from seed 0 on it; :func:`main` also takes ``params``
(the reference's ``init_params(cfg, PRNGKey(0))`` through
``models.convert.lm_params_from_numpy``, say), which then replace the
draw.  ``--metrics-out`` writes the run's report as JSON: every
request's tokens, tokens/s, the scheduler's metrics and each kernel
wrapper's launches in the run (prefills go through the flash kernel on
the card).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention, ou_mvm, pattern_spmm
from repro_torch.models.transformer import init_params, init_statics
from repro_torch.runtime.serve import ServeConfig, ServeLoop
from repro_torch.serve.api import Request


def _launches() -> dict:
    """Each kernel wrapper's launches so far in this process."""
    return {"pattern_spmm_cuda": pattern_spmm.pattern_spmm_cuda.launches,
            "pattern_spmm_quant_cuda":
                pattern_spmm.pattern_spmm_quant_cuda.launches,
            "ou_mvm_cuda": ou_mvm.ou_mvm_cuda.launches,
            "flash_attention_cuda": flash_attention.flash_attention_cuda
            .launches}


def main(argv=None, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's report here as JSON")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(None if args.device == "cuda" else "cpu")
    if params is None:
        params, statics = init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        statics = init_statics(cfg, dev)
    scfg = ServeConfig(
        batch_slots=args.slots,
        max_seq=args.max_seq or min(cfg.max_seq, args.prompt_len
                                    + args.new_tokens + 8),
        eos_id=-1,  # synthetic prompts: never stop early
    )
    loop = ServeLoop(cfg, statics, params, scfg, device=dev)

    rng = np.random.default_rng(0)
    reqs = [
        Request(
            prompt=rng.integers(1, cfg.vocab, size=args.prompt_len).astype(
                np.int32
            ),
            max_new_tokens=args.new_tokens,
        )
        for _ in range(args.requests)
    ]
    before = _launches()
    t0 = time.time()
    loop.generate(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.output) for r in reqs)
    print(f"{len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s)")
    m = loop.metrics
    print(f"scheduler: {m['steps']} steps, "
          f"occupancy {m['occupancy_mean']:.0%}, "
          f"mean latency {m['latency_mean_s']:.2f}s")
    for r in reqs[:3]:
        print("out:", r.output[:12])
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({
                "arch": cfg.name, "device": str(dev),
                "layers": cfg.n_layers, "requests": len(reqs),
                "outputs": [[int(t) for t in r.output] for r in reqs],
                "seconds": dt, "tokens": total_new,
                "tokens_per_s": total_new / dt, "scheduler": m,
                "kernel_launches": {k: v - before[k]
                                    for k, v in _launches().items()}}, f)
    return reqs


if __name__ == "__main__":
    main()
