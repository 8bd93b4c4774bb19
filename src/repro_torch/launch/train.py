"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --smoke --steps 50 --batch 8 --seq 128 [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch granite_3_2b --smoke --device cpu

Port of ``src/repro/launch/train.py``.  Builds one mesh over the launched
ranks (``data`` = the world, ``model`` = 1; or the production mesh with
``--production-mesh``), places params and optimizer state with the
production rules (``launch.steps.param_shardings`` and ZeRO-1 moments,
``runtime.train`` with ``shardings=``), feeds each rank its rows of the
packed synthetic pipeline (``data.shard_batch``), and drives the
fault-tolerant ``Trainer`` (periodic async checkpoints of whole leaves,
resume-from-latest) with a step that donates the state, as the
reference's ``jax.jit(..., donate_argnums=(0,))`` does
(``make_train_step(..., donate=True)``).  One process starts its own one-rank group; under
``torchrun`` every rank joins the launched group (``nccl`` on ``cuda``,
``gloo`` on the CPU).  ``--device`` is where it runs (default ``cuda``,
raising without a card; ``cpu`` when asked).  Every rank draws the same
params from seed 0, then keeps its slabs.  Rank 0 prints; with
``--metrics-out`` it also writes every step's metrics as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, packed_batches, shard_batch
from repro_torch.launch.mesh import (
    make_local_mesh,
    make_production_mesh,
    mesh_device,
)
from repro_torch.models.transformer import init_params, init_specs
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.runtime.train import (
    TrainConfig,
    Trainer,
    init_train_state,
    make_train_step,
    train_shardings,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--metrics-out", default=None,
                    help="write every step's metrics here as JSON (rank 0)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    owns_group = not dist.is_initialized()
    if owns_group and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        history = _train(args, cfg)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return history


def _train(args, cfg):
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = (
        make_production_mesh(device_type=args.device)
        if args.production_mesh
        else make_local_mesh(data=world, model=1, device_type=args.device)
    )
    dev = mesh_device(mesh)
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    shardings = train_shardings(init_specs(cfg), params, mesh)

    opt = adamw()
    tcfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        async_ckpt=True,
    )
    lr_fn = linear_warmup_cosine(args.lr, 20, args.steps)
    step = make_train_step(cfg, statics, opt, lr_fn, tcfg,
                           shardings=shardings, donate=True)
    state = init_train_state(params, opt, tcfg, shardings=shardings)
    del params

    dcfg = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch
    )
    batches = packed_batches(dcfg)
    trainer = Trainer(
        step, state, batches, tcfg,
        put_batch=lambda b: shard_batch(b, mesh),
        shardings=shardings,
    )
    lead = dist.get_rank() == 0
    resumed = trainer.maybe_restore()
    if resumed and lead:
        print(f"resumed from step {resumed}")
    history = trainer.run()
    trainer.ckpt.close()
    if lead:
        for h in history[:: max(1, len(history) // 20)]:
            print(
                f"step {h['step']:5d} loss {h['loss']:.4f} "
                f"gnorm {h['grad_norm']:.3f} {h['seconds']*1e3:.0f}ms"
            )
        if history:
            print(f"final loss {history[-1]['loss']:.4f}")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump({"resumed": resumed, "history": history}, f)
    return history


if __name__ == "__main__":
    main()
