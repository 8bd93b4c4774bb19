#!/usr/bin/env python3
"""Is a float32 train step of ``chip_smoke.py``'s part (i) or (j) the
same from the same params, run twice on one card?

    python3 scripts/train_step_repeat.py [j|i] [default|deterministic]

Builds the part's unsharded float32 model and first batch as
``chip_smoke.unsharded_runs`` does (the seed 0, the part's cut), then,
each twice from the same params: the step-1 gradient (an SGD step at
``SGD_LR``) and AdamW's step 1.  Prints one JSON line: for each leaf
whose two gradients differ, the largest change and the count of weights
that changed; the weights the fixed floors call well posed whose
gradient changes sign; and the second AdamW step held to the first by
``chip_smoke.adam_rule`` on the fixed floors, with the weights it finds
off where posed (leaf, flat index, both gradients).  ``deterministic``
runs under ``torch.use_deterministic_algorithms`` (with
``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts).  Run both arms in
one call, on one card; needs a CUDA device.
"""

import dataclasses
import importlib.util
import json
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def main(part: str, arm: str) -> int:
    if part not in ("i", "j") or arm not in ("default", "deterministic"):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if arm == "deterministic":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = cs.DRILL_CUBLAS_WORKSPACE
    import torch

    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw, sgd
    from repro_torch.optim.optimizers import _map
    from repro_torch.runtime import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    if arm == "deterministic":
        torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if part == "j":
        cfg = cs.cut_layers(cs.mamba2_shard_config(), cs.MAMBA_SHARD_LAYERS,
                            "float32")
        batch = cs.MAMBA_SHARD_BATCH
    else:
        ds = cs.deepseek_shard_config()
        cfg = cs.with_dtype(dataclasses.replace(
            ds, n_layers=1, layer_types=ds.layer_types[:1]), "float32")
        batch = cs.DEEPSEEK_SHARD_BATCH
    seed = 0
    corpus = SyntheticCorpus(min(cs.TRAIN_CORPUS_VOCAB, cfg.vocab), seed)
    put = {k: torch.as_tensor(v, device=dev)
           for k, v in next(cs.train_data(seed, corpus, batch)).items()}
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    tcfg = TrainConfig(steps=1)
    sgd_step = make_train_step(cfg, statics, sgd(), lambda s: cs.SGD_LR,
                               tcfg)

    def grads_at(p):
        p1, _ = sgd_step(init_train_state(p, sgd(), tcfg), put)
        return _map(lambda a, b: ((a - b) / cs.SGD_LR).cpu(), p,
                    p1["params"])

    opt = adamw(weight_decay=0.0)
    step = make_train_step(cfg, statics, opt, lambda s: cs.TRAIN_LR, tcfg)

    def adam_from(p):
        state, _ = step(init_train_state(_map(torch.clone, p), opt, tcfg),
                        put)
        return _map(lambda t: t.cpu(), state["params"])

    g1, g2 = grads_at(params), grads_at(params)
    changed, sign_flips = {}, 0
    for (key, a), (_, b) in zip(_leaf_paths(g1), _leaf_paths(g2)):
        d = (a - b).abs()
        if bool((d > 0).any()):
            changed[key] = {"max_abs_change": float(d.max()),
                            "weights_changed": int((d > 0).sum()),
                            "leaf_max_abs_grad": float(a.abs().max())}
        ga = a.abs()
        posed = ((ga >= cs.NOISE_FLOOR * ga.max())
                 & (ga >= cs.ADAM_EPS_REGION * cs.ADAM_EPS))
        sign_flips += int((posed & (torch.sign(a) != torch.sign(b))).sum())
    p_a, p_b = adam_from(params), adam_from(params)
    rule = cs.adam_rule(_leaf_paths(p_b), p_a, g1, cs.TRAIN_LR)
    off_posed = []
    gs1, gs2 = dict(_leaf_paths(g1)), dict(_leaf_paths(g2))
    for (key, a), (_, b) in zip(_leaf_paths(p_b), _leaf_paths(p_a)):
        far = (a - b).abs() >= cs.ADAM_OFF * cs.TRAIN_LR
        g = gs1[key].abs()
        posed = ((g >= cs.NOISE_FLOOR * g.max())
                 & (g >= cs.ADAM_EPS_REGION * cs.ADAM_EPS))
        for i in cs._flat_nonzero(far & posed)[:8]:
            off_posed.append({"leaf": key, "index": i,
                              "grad_first": float(gs1[key].view(-1)[i]),
                              "grad_rerun": float(gs2[key].view(-1)[i])})
    print(json.dumps({
        "part": part, "arm": arm, "model": cfg.name,
        "layers": cfg.n_layers, "batch": list(batch),
        "device": torch.cuda.get_device_name(0),
        "grad_bit_equal": not changed, "grad_changed_leaves": changed,
        "posed_sign_flips": sign_flips,
        "adam_rerun_rule": {k: rule[k] for k in (
            "off", "total", "off_where_posed", "max_abs_diff")},
        "adam_rerun_off_where_posed": off_posed}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(sys.argv[1:3] if len(sys.argv) >= 3 else
                    (sys.argv[1:2] + ["default"] if len(sys.argv) == 2
                     else ["j", "default"]))))
