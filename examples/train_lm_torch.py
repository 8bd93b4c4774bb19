"""End-to-end LM training on the PyTorch port, the twin of
``examples/train_lm.py`` through ``repro_torch``: packed data pipeline,
AdamW + cosine schedule, fault-tolerant Trainer (async checkpoints,
resume), optional pattern-sparse MLPs.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]
  PYTHONPATH=src python examples/train_lm_torch.py --hundred-m --steps 300

The default config (~10M params) trains a few hundred steps in
CPU-minutes; --hundred-m selects a ~100M-param model for a GPU.
``--device`` is where it runs (default ``cuda``; ``cpu`` when asked).
The step runs every layer on its plain PyTorch route
(``apply_model(..., kernels=False)``), which autograd differentiates.
"""

import argparse
import os
import tempfile

import torch

from repro_torch.data import DataConfig, packed_batches
from repro_torch.models.transformer import ModelConfig, count_params, init_params
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.runtime.train import (
    TrainConfig,
    Trainer,
    init_train_state,
    make_train_step,
)


def small_config(hundred_m: bool) -> ModelConfig:
    if hundred_m:
        return ModelConfig(
            name="lm100m", n_layers=12, d_model=768, vocab=32000,
            layer_types=(("attn", "mlp"),) * 12, n_heads=12, n_kv_heads=4,
            d_head=64, d_ff=2048, model_shards=1, max_seq=1024,
        )
    return ModelConfig(
        name="lm10m", n_layers=4, d_model=256, vocab=2048,
        layer_types=(("attn", "mlp"),) * 4, n_heads=8, n_kv_heads=4,
        d_head=32, d_ff=768, model_shards=1, max_seq=512,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = small_config(args.hundred_m)
    device = torch.device(args.device)
    params, statics = init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    print(f"{cfg.name}: {count_params(params)/1e6:.1f}M params")

    opt = adamw()
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir, async_ckpt=True,
    )
    lr_fn = linear_warmup_cosine(args.lr, 20, args.steps)
    step = make_train_step(cfg, statics, opt, lr_fn, tcfg)
    state = init_train_state(params, opt, tcfg)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    trainer = Trainer(step, state, packed_batches(dcfg), tcfg)
    resumed = trainer.maybe_restore()
    if resumed:
        print(f"resumed from checkpoint at step {resumed}")
    hist = trainer.run()
    trainer.ckpt.close()
    for h in hist[:: max(1, len(hist) // 15)]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"({h['seconds']*1e3:.0f} ms/step)")
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f}  "
              f"stragglers flagged: {len(trainer.straggler.flagged)}")
    return hist


if __name__ == "__main__":
    main()
