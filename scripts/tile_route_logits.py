"""How far the pattern-spmm tile route moves served logits, on one card.

Usage:
  PYTHONPATH=src python3 scripts/tile_route_logits.py [--seed 0]

``chip_smoke.py``'s ``dryrun`` (c) model (h2o-danube-1.8B at full width,
its first ``SHARD_TRAIN_LAYERS`` layers, float32, a bf16 cache, its
prompts from the seed) is served unsharded on the config's own sparse
layouts (each dictionary group one dense product per pattern) with the
kernels, greedily.  The same model is then served teacher-forced on
those tokens three ways: the tile route (``chip_smoke.tile_route``: the
groups written out as brick tables) on the pattern-spmm kernel and on its
plain version, and the own layouts with ``kernels=False``.  Prints, for
one sparse layer, each route's largest difference from the own layouts'
output; for each way, the decode logits' largest difference relative to
the row's largest logit and whether the argmaxes agree step by step; and
the own layouts' top-2 logit gap per row and step on the same scale.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import init_cache, init_params  # noqa: E402
from repro_torch.runtime.serve import (  # noqa: E402
    ServeConfig,
    decode_logits,
    make_prefill_step,
)


def serve(cfg, statics, params, prompts, kernels: bool, dev,
          forced=None) -> tuple:
    """Greedy tokens a step (numpy) and each decode step's logits (CPU),
    each step reading ``forced``'s token where given."""
    b, p = prompts.shape
    cache = init_cache(statics, b, cs.DRYRUN_MAX_SEQ, torch.bfloat16,
                       device=dev)
    tok, cache = make_prefill_step(cfg, statics, ServeConfig(
        cache_dtype="bfloat16"), kernels=kernels)(params, cache, prompts)
    toks, logits = [tok.cpu().numpy()], []
    for i in range(cs.DRYRUN_DECODE):
        if forced is not None:
            tok = torch.as_tensor(forced[i], device=dev)
        lg, cache = decode_logits(statics, params, cache, tok,
                                  torch.tensor(p + i, device=dev),
                                  kernels=kernels)
        tok = lg.argmax(-1)
        toks.append(tok.cpu().numpy())
        logits.append(lg.cpu())
    return toks, logits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.cut_layers(cs.train_config(), cs.SHARD_TRAIN_LAYERS, "float32")
    with torch.no_grad():
        params, statics = init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed),
            device=dev)
        tiles = cs.tile_route(statics)
        prompts = torch.as_tensor(
            np.random.default_rng(args.seed + 41).integers(
                1, cfg.vocab, (cs.DRYRUN_BATCH, cs.DRYRUN_PROMPT)),
            device=dev)
        own_mlp, tile_mlp = statics["body"][0]["mlp"], tiles["body"][0]["mlp"]
        x = torch.randn(8, cfg.d_model, device=dev, generator=torch.Generator(
            device=dev).manual_seed(args.seed + 1))
        for name in ("up", "gate"):
            w = {"w_comp": params["body"][0]["mlp"][name]["w_comp"][0]}
            want = layers.sparse_linear(w, own_mlp[name], x)
            for kernels in (True, False):
                got = layers.sparse_linear(w, tile_mlp[name], x, kernels)
                print(f"layer 0 {name}: tile route, kernels={kernels}: "
                      f"max|d| {(got - want).abs().max().item():.3e} of "
                      f"max|y| {want.abs().max().item():.3e}")
        own_toks, own_logits = serve(cfg, statics, params, prompts, True, dev)
        for label, st, kernels in (("tile route, kernels", tiles, True),
                                   ("tile route, plain", tiles, False),
                                   ("own layouts, plain", statics, False)):
            toks, logits = serve(cfg, st, params, prompts, kernels, dev,
                                 forced=own_toks)
            rel = [float((g - w).abs().max() / w.abs().max())
                   for w, g in zip(own_logits, logits)]
            same = [bool(np.array_equal(a, b))
                    for a, b in zip(own_toks, toks)]
            print(f"{label}: logits rel diff by step "
                  f"{['%.2e' % r for r in rel]}; argmaxes equal {same}")
        for i, lg in enumerate(own_logits):
            top = lg.topk(2, dim=-1).values
            gap = (top[:, 0] - top[:, 1]) / lg.abs().max(dim=-1).values
            print(f"step {i}: own layouts' top-2 gap by row "
                  f"{['%.2e' % g for g in gap.tolist()]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
