"""Where a step's peak of live bytes is set, on fake tensors.

Usage:
  PYTHONPATH=src python3 scripts/step_peak_site.py --arch h2o_danube_1_8b \\
      --layers 4 [--shape train_4k]
  PYTHONPATH=src python3 scripts/step_peak_site.py --arch h2o_danube_1_8b \\
      --layers 2 --sparse --unsharded --batch 4x512 [--loss-and-grads \
      [--no-remat]]

The config (``--sparse``: the paper's sparse MLPs, where the arch's
config takes them) is cut to its first ``--layers`` layers at full
width.  The default runs the cell's production step (``launch.steps.
build_step``: the train step, or with ``--shape prefill_32k`` or a decode
shape the placed serving step) for rank 0 of the single-pod fake mesh,
as the dry run does; ``--unsharded`` runs the one-device step of ``runtime.train``
(AdamW, no weight decay, the state donated) on a ``--batch`` of rows x
tokens, as
``chip_smoke.py``'s ``train`` phase does; with ``--loss-and-grads``
only its loss and gradients (``step.loss_and_grads``, no update), as the
``dryrun`` phase's (a) counts them, with the config's remat or, with
``--no-remat``, without.  Nothing is allocated: the
step runs in a ``FakeTensorMode`` under ``launch.op_stats.OpStats``
(``keep_site``).  Prints the step's input bytes, its peak and the Python
stack of the allocation that set the peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from repro_torch.launch import op_stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--sparse", action="store_true")
    ap.add_argument("--unsharded", action="store_true")
    ap.add_argument("--batch", default="4x512")
    ap.add_argument("--loss-and-grads", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import _module

    torch.set_num_threads(1)
    full = (_module(args.arch).config(sparse=True) if args.sparse
            else _module(args.arch).config())
    cfg = dataclasses.replace(full, n_layers=args.layers,
                              layer_types=full.layer_types[:args.layers],
                              remat=not args.no_remat)
    if args.unsharded:
        stats, inputs = _unsharded(cfg, args.batch, args.loss_and_grads)
    else:
        stats, inputs = _cell(args.arch, args.shape, cfg)
    print(f"{cfg.name} {args.layers} layers, remat {cfg.remat}: inputs "
          f"{inputs} bytes, "
          f"peak {stats.peak_bytes} bytes")
    print(stats.peak_site)
    return 0


def _cell(arch: str, shape: str, cfg):
    from repro_torch.launch.dryrun import _static_tensors
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step

    mesh = make_production_mesh(multi_pod=False, fake=True)
    built = build_step(arch, shape, mesh, cfg=cfg)
    with built.mode, op_stats.OpStats(keep_site=True).name_groups(mesh) as stats:
        stats.add_inputs(built.args, _static_tensors(built.meta["statics"]))
        inputs = stats.peak_bytes
        built.fn(*built.args)
    return stats, inputs


def _unsharded(cfg, batch: str, loss_and_grads: bool):
    from repro_torch.launch.dryrun import _static_tensors
    from repro_torch.models.transformer import init_params, init_statics
    from repro_torch.optim import adamw
    from repro_torch.runtime import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    rows, seq = (int(v) for v in batch.split("x"))
    statics = init_statics(cfg, "cpu")
    opt = adamw(weight_decay=0.0)
    tcfg = TrainConfig()
    step = make_train_step(cfg, statics, opt, lambda s: 1e-3, tcfg,
                           donate=True)
    with op_stats.fake_mode():
        params, _ = init_params(cfg, torch.Generator(), device="cpu")
        state = init_train_state(params, opt, tcfg)
        del params
        tokens = torch.zeros((rows, seq + 1), dtype=torch.int32)
        with op_stats.OpStats(keep_site=True) as stats:
            if loss_and_grads:
                stats.add_inputs(state["params"], {"tokens": tokens},
                                 _static_tensors(statics))
                inputs = stats.peak_bytes
                step.loss_and_grads(state["params"], {"tokens": tokens})
            else:
                stats.add_inputs(state, {"tokens": tokens},
                                 _static_tensors(statics))
                inputs = stats.peak_bytes
                step(state, {"tokens": tokens})
    return stats, inputs


if __name__ == "__main__":
    sys.exit(main())
