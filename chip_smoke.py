#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main paths at full width, through the entry points a
user calls: compile the synthetic pattern-pruned VGG16 (CIFAR-10, 13
convs, Table-II statistics) in fp32 and int8, save and reload the fp32
program, and serve seeded requests through ``InferenceService`` on
``cuda``; compile it again with the per-layer crossbar mapping search
(``optimize="auto"``), serve it with skip statistics and price the served
traffic with ``hardware_report``; train full-width VGG16 on seeded
class-prototype batches, pattern-prune it with ``admm_pattern_prune``,
compile it verified and range-certified, reload it with verification and
serve it; run ``ops.ou_mvm`` on every conv's dense weight at real
inputs; generate tokens with full-width, full-depth
h2o-danube-1.8B (pattern-sparse MLPs, bf16, weights from the seed)
through ``DecodeService``, every prefill through the flash-attention
kernel.  Before each path it builds the CUDA kernels from the sources in
``src/`` and holds each against its plain PyTorch version on the card,
at every shape the path gives it.

Phases, one JSON line each: ``device``, ``build``, ``compile``,
``kernels`` (kernel vs plain), ``serve``, ``search``, ``prune``,
``ou_mvm``, ``flash`` (kernel vs plain), ``generate``, ``times``.  The
spmm rows carry each layer's split plan (``splits``, ``blocks``) and, in
``times``, its TFLOP/s (fp32) or TOP/s and bound (int8); the ``ou_mvm``
rows carry the column-slab plan (``slab_cols``, ``blocks``) and, in
``times``, GB/s; every kernel must give the same bits on a second run.
The flash rows carry the route (``tensor_core`` for bf16 and fp16,
``simt`` for fp32), and every prefill launch of ``generate`` must take
the tensor-core route.  The ``prune`` phase gates every kernel's pattern
in its layer's dictionary (at most ``num_patterns`` nonzero ones) and its
weights inside that pattern; strict compiles in fp32 and int8 whose
certificates and verifier reports equal the same compiles on the CPU;
``python -m repro_torch.analysis all`` exiting 0 on each saved program;
served fp32 labels equal to the dense ``cnn_apply`` (layers within
``LAYER_TOL``, logits within ``E2E_TOL`` of the CPU plain path); conv1's
kernel output at the input that attains its certified ``pre_hi`` and
``pre_lo`` within ``bound_rounding_limit`` of them; and every layer's
spmm + bias over the served images inside its certificate, fp32 and
int8.  Its spmm launches join the serve phase's in the summary.  Any
failed check exits non-zero.  The last three lines are the card's name and power limit as ``nvidia-smi`` prints them, the
per-kernel ``{"kernels": [...]}`` summary, and
``{"ok": true, "device": {...}}``.

Needs a CUDA device and ``nvcc``; without a card it exits 1 and prints no
result.  It imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH_SLOTS = 8
# the first 64 requests of benchmarks/bench_engine.py's SERVICE_BURSTS
BURSTS = (1, 7, 19, 2, 30, 5)
N_INT8 = 16
FP32_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's fp32 bound
# int8: every brick partial is an exact integer and the fold rounds as
# the plain version's does, so only the order of float sums may differ
QUANT_REL = 2e-6
# Each layer on the card against the same layer of the plain path on the
# CPU, both fed the same input.
LAYER_TOL = 1e-4
# End to end the served logits against the CPU plain path's, relative to
# the largest CPU logit.  fp32 reassociation noise compounds through 13
# channel_norms (those over 2x2 maps divide by the std of 4 values): on
# seed 0 the CPU's own fp32 plain path is 2.6e-4 off a float64 dense
# forward on logits of ~5 (5e-5 relative) and the card 8.7e-4 off the
# CPU (1.8e-4 relative).  The limit is six times the CPU's own noise, so
# a kernel error that stays under LAYER_TOL per layer but adds up across
# the 14 layers still fails.
E2E_TOL = 3e-4
REPS = 20
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's ~1.98 GHz boost clock
# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12  # CUDA cores (IEEE fp32 has no tensor-core path)
PEAK_INT8_OPS = 1979e12  # tensor cores
HBM_BYTES_PER_S = 3.35e12
# ou_mvm: the paper's 9x8 OU; per column, the kernel within
# OU_TOL * (1 + sum_r |x_r w_rc|) of its plain version (the reference's
# 1e-5 bound, tests/test_kernels.py, scaled by the column's magnitude)
OU_ROWS, OU_COLS = 9, 8
OU_TOL = 1e-5
OU_SWEEP = ((100, 52, 9, 8), (64, 64, 16, 8), (27, 8, 9, 8))
# hardware_report fields that depend on no activation: equal exactly
# between the program on the card and the same program on the CPU
PRICE_FIELDS = ("crossbars", "naive_crossbars", "area_cells",
                "naive_area_cells", "energy_pj", "cycles", "index_kb",
                "mapping", "precision")

KERNELS = {
    "pattern_spmm_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pattern_spmm.cu",
        "replaces": "src/repro/kernels/pattern_spmm.py:58",
    },
    "pattern_spmm_quant_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pattern_spmm.cu",
        "replaces": "src/repro/kernels/pattern_spmm.py:126",
    },
    "ou_mvm_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ou_mvm.cu",
        "replaces": "src/repro/kernels/ou_mvm.py:47",
    },
    "flash_attention_cuda": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
    },
}
# flash attention: tests/test_kernels.py's sweep (b, hq, hkv, sq, sk, d),
# causal only where sq == sk, with and without a window of 33, in the three
# input types; then the generation path's own calls (h2o-danube-1.8B: 32
# query heads over 8 key heads, D 80, bf16, window 4096), each at a prompt
# length of FLASH_PATH_S both as a bare [S, S] attention and as the
# prefill reads it: keys from the [1, max_seq, 8, 80] cache through a
# transposed view, kv_len = S < max_seq; and once with kv_len < Sq = Sk
FLASH_SWEEP = ((1, 2, 1, 64, 64, 32), (2, 4, 2, 100, 100, 64),
               (1, 3, 3, 128, 256, 32), (1, 8, 2, 77, 77, 80))
FLASH_TYPES = ("float32", "bfloat16", "float16")
FLASH_HEADS = (32, 8, 80)  # query heads, key heads, head dim
FLASH_PATH_S = (17, 128, 1000, 4500)
FLASH_WINDOW = 4096
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense


def flash_tolerance(dtype: str) -> dict:
    """tests/test_kernels.py's ``_tolerance``: bf16 (and fp16) inputs with
    fp32 accumulators differ by a few ULPs of bf16 between two routes."""
    return (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
            else dict(rtol=8e-2, atol=4e-2))


# The rounding limit, for 16-bit inputs besides ``flash_tolerance``: the
# kernel rounds its fp32 result once into the input type, so it lies
# within half an ulp (2^-8 relative in bf16, 2^-11 in fp16) of the plain
# version computed in fp32 from the same inputs, plus the two fp32 sums'
# own difference, FLASH_SUM_SLACK of the query row's largest |value|.
# ``_tolerance`` alone is wider than an output of the path (softmax means
# of ~500-4096 keys, |o| ~ 0.01-0.02) and lets a key too many or too few
# through; scripts/flash_fault_check.py plants such faults and shows that
# this limit fails each of them (PERF.md).
FLASH_HALF_ULP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
FLASH_SUM_SLACK = 2.0 ** -16


# generation: full-width, full-depth h2o-danube-1.8B with the paper's
# pattern-sparse MLPs, weights from the seed
GEN_SCFG = dict(batch_slots=8, max_seq=6144, eos_id=-1)
GEN_REQUESTS = 24
GEN_LENGTHS = (16, 1024)  # seeded prompt lengths, none a multiple of 128
GEN_LONG = 4500  # one prompt longer than the window: it masks in the kernel
GEN_LONG_AT = 9  # its place in the arrival order
GEN_NEW = 32  # new tokens per request
GEN_BURSTS = (1, 7, 5, 2, 6, 4)  # arrivals between service steps
# prefill logits of the kernel route against the plain route on the card.
# bf16: no farther apart than twice the plain bf16 route's own distance
# from the same model in float32 (the bf16 rounding noise of this model
# and prompt); float32: both routes in float32 within GEN_FP32_REL of each
# other (a wrong mask or a wrong softmax moves logits by O(1) relative).
# Relative to the largest logit of the plain route.
GEN_BF16_NOISE_FACTOR = 2.0
GEN_FP32_REL = 1e-3


# prune: the paper's flow on full-width VGG16 for CIFAR-10 (Table II's
# 86.03 % sparsity, 6 patterns a layer), trained on synthetic
# class-prototype batches made from the seed, pixels clipped to the
# certificate's declared input range
PRUNE_BATCH = 64
PRUNE_DENSE_STEPS = 40
PRUNE_CFG = dict(target_sparsity=0.8603, num_patterns=6, admm_steps=40,
                 admm_every=20, retrain_steps=20)
# AdamW's rate for all three stages: at 1e-3 the dense loss of this
# channel_norm VGG16 stays at ln 10 (chance) through the phase
PRUNE_LR = 1e-4
PRUNE_NOISE = 0.7  # tests/test_pruning.py's gen_batch
PRUNE_REQUESTS = sum(BURSTS)  # served in the serve phase's bursts


def prune_model_config():
    """The ``prune`` phase's network: the paper's VGG16 for CIFAR-10."""
    from repro_torch.models.cnn import vgg16_config

    return vgg16_config(10, 32)


def _jsonable(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"not JSON serializable: {type(v)}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=_jsonable),
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_model(seed: int):
    """(cfg, numpy params, pattern bits): ``synthesize_network`` for the
    13 convs with zero biases, as ``benchmarks/bench_engine.py`` builds
    it, and a seeded normal FC (zeros there would tie every logit).  A
    conv bias would make a channel whose inputs are all zero a nonzero
    constant, which ``channel_norm`` divides by its eps."""
    from repro_torch.core.synthetic import synthesize_network
    from repro_torch.models.cnn import vgg16_config

    stats, layers = synthesize_network("cifar10", seed=seed)
    cfg = vgg16_config(num_classes=10, input_hw=stats.input_hw)
    rng = np.random.default_rng(seed + 1)
    params, bits = {}, {}
    for i, layer in enumerate(layers, start=1):
        spec = layer.spec
        params[f"conv{i}"] = {
            "w": layer.weights.reshape(spec.c_out, spec.c_in, 3, 3),
            "b": np.zeros(spec.c_out, np.float32),
        }
        bits[f"conv{i}"] = layer.pattern_bits
    c_last = cfg.conv_channels[-1][1]
    params["fc"] = {
        "w": (rng.normal(size=(c_last, cfg.num_classes))
              / np.sqrt(c_last)).astype(np.float32),
        "b": (0.1 * rng.normal(size=cfg.num_classes)).astype(np.float32),
    }
    return cfg, params, bits


def _host(a):
    import torch

    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def program_mismatches(a, b) -> list[str]:
    """Names of the arrays in which two programs differ (dtype or bits)."""
    bad = []

    def same(name, x, y):
        x, y = _host(x), _host(y)
        if x is None or y is None:
            if not (x is None and y is None):
                bad.append(name)
        elif x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(name)

    layers = [(c.name, c, d) for c, d in zip(a.convs, b.convs)]
    layers.append(("fc", a.fc, b.fc))
    if len(a.convs) != len(b.convs):
        bad.append("convs")
    for name, x, y in layers:
        same(f"{name}.bias", x.bias, y.bias)
        if name != "fc":
            same(f"{name}.pattern_bits", x.pattern_bits, y.pattern_bits)
        for field in ("w_comp", "block_ids", "w_scales", "nnz", "new_order",
                      "inv_order", "dict_masks"):
            same(f"{name}.bp.{field}", getattr(x.bp, field),
                 getattr(y.bp, field))
    return bad


def layer_cases(prog, rng, dev):
    """One kernel case per spmm of a forward at ``BATCH_SLOTS`` images:
    (name, bp, x) with seeded activations in the real feature columns and
    zeros in the padding, as the executor pads them."""
    import torch

    ops = [(op.name, op.bp, BATCH_SLOTS * op.out_hw ** 2, op.k_unpadded)
           for op in prog.convs]
    ops.append(("fc", prog.fc.bp, BATCH_SLOTS, prog.fc.d_in))
    cases = []
    for name, bp, m, k_real in ops:
        x = np.zeros((m, bp.k_in), np.float32)
        x[:, :k_real] = rng.normal(size=(m, k_real))
        cases.append((name, bp.to(dev), torch.as_tensor(x, device=dev)))
    return cases


def small_geometry_case(rng, dev):
    """Block 9, tile 8 (the smallest geometry in use), ragged rows, and a
    first tile with no bricks at all (``nnz[0] == 0``)."""
    import torch

    from repro_torch.core.sparse import build_block_pattern, nonzero_block_masks

    m, k, n, block, tile = 200, 81, 32, 9, 8
    w = rng.normal(size=(k, n)) / np.sqrt(k)
    keep = rng.random((k // block, 1, n)) < 0.4
    w = (w.reshape(k // block, block, n) * keep).reshape(k, n)
    w = w.astype(np.float32)
    w[:, :tile] = 0.0  # all-zero masks sort first: tile 0 holds no brick
    bp = build_block_pattern(w, block=block, tile=tile,
                             masks=nonzero_block_masks(w, block), device=dev)
    check(int(bp.nnz[0]) == 0, "small geometry: tile 0 should hold no brick")
    x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32), device=dev)
    return ("block9_tile8", bp, x)


def calls(kind, bp, x, dev):
    """(kernel, plain) zero-argument calls of a kernel's wrapper and of its
    plain version on the same operands, made once here as the executor
    makes them (``nnz`` on the device; int8 activations quantized per
    row and the bricks' K-major copy), so a timed call is the launch
    alone."""
    import torch

    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels import pattern_spmm as tk

    nnz = torch.as_tensor(bp.nnz, dtype=torch.int32, device=dev)
    if kind == "pattern_spmm_cuda":
        args = (x, bp.w_comp, bp.block_ids, nnz, bp.block)
        return (lambda: tk.pattern_spmm_cuda(*args),
                lambda: tk.pattern_spmm_plain(*args))
    xq, _ = quantize_rows(x)
    args = (xq, bp.w_comp, bp.block_ids, bp.w_scales, nnz, bp.block)
    wk = tk.kmajor_bricks(bp.w_comp)  # as the executor prepares it
    return (lambda: tk.pattern_spmm_quant_cuda(*args, w_kmajor=wk),
            lambda: tk.pattern_spmm_quant_plain(*args))


def spmm_plan(kind, bp, m: int) -> dict:
    """A spmm kernel's plan for one layer (``_split_plan`` of its shapes
    for fp32, ``_quant_plan`` for int8): block tile, splits and the
    first launch's blocks."""
    from repro_torch.kernels import pattern_spmm as tk

    planner = (tk._split_plan if kind == "pattern_spmm_cuda"
               else tk._quant_plan)
    plan = planner(m, bp.n_tiles, bp.tile, bp.k_max)
    return {"tile_rows": plan.bm, "tile_cols": plan.bn,
            "step_depth": plan.bk, "splits": plan.splits,
            "blocks": plan.blocks}


def reduce_launches_expected(prog, batches: int,
                             kind: str = "pattern_spmm_cuda") -> int:
    """Split reductions a run of ``batches`` forwards of ``prog`` at
    ``BATCH_SLOTS`` images launches: one per layer whose plan splits."""
    ms = [BATCH_SLOTS * op.out_hw ** 2 for op in prog.convs] + [BATCH_SLOTS]
    bps = [op.bp for op in prog.convs] + [prog.fc.bp]
    return batches * sum(spmm_plan(kind, bp, m)["splits"] > 1
                         for bp, m in zip(bps, ms))


def compare(kind, y, want, bp) -> dict:
    """Kernel output against its plain version, with the stated limit."""
    import torch

    torch.cuda.synchronize()
    d = (y - want).abs()
    out = {"max_abs_diff": float(d.max()) if d.numel() else 0.0}
    if kind == "pattern_spmm_cuda":
        lim = FP32_TOL["atol"] + FP32_TOL["rtol"] * want.abs()
        out["limit"] = f"|d| <= {FP32_TOL['atol']} + {FP32_TOL['rtol']}*|plain|"
        out["worst_over_limit"] = float((d / lim).max()) if d.numel() else 0.0
        out["ok"] = out["worst_over_limit"] <= 1.0
    else:
        scale = float(want.abs().max()) if want.numel() else 0.0
        rel = out["max_abs_diff"] / max(scale, 1e-30)
        single = [t for t in range(bp.n_tiles) if int(bp.nnz[t]) <= 1]
        exact = all(
            torch.equal(y[:, t * bp.tile:(t + 1) * bp.tile],
                        want[:, t * bp.tile:(t + 1) * bp.tile])
            for t in single
        )
        out.update(limit=f"max|d|/max|plain| <= {QUANT_REL}; single-brick "
                         "tiles exact",
                   rel=rel, single_brick_tiles=len(single),
                   single_brick_exact=exact, ok=rel <= QUANT_REL and exact)
    empty = [t for t in range(bp.n_tiles) if int(bp.nnz[t]) == 0]
    if empty:
        zero = all(not y[:, t * bp.tile:(t + 1) * bp.tile].any() for t in empty)
        out["empty_tiles_zero"] = zero
        out["ok"] = out["ok"] and zero
    return out


def cost(kind, bp, m: int) -> tuple[float, float]:
    """(bytes, operations) one call must move and do, counted from this
    call's data: each x block some tile uses read once, each stored brick
    read once (padded slots are never read), the index tables and (int8)
    the scales read once, the output written once."""
    nnz = np.asarray(bp.nnz)
    ids = _host(bp.block_ids)
    bricks = int(nnz.sum())
    used = {int(ids[t, k]) for t in range(bp.n_tiles) for k in range(nnz[t])}
    esize = 4 if kind == "pattern_spmm_cuda" else 1
    nbytes = (m * len(used) * bp.block * esize
              + bricks * bp.block * bp.tile * esize
              + ids.size * 4 + nnz.size * 4
              + m * bp.n_tiles * bp.tile * 4)
    if kind == "pattern_spmm_quant_cuda":
        nbytes += bricks * 4  # w_scales
    ops = 2.0 * m * bp.block * bp.tile * bricks
    return float(nbytes), ops


def device_ms(fn, dev) -> float:
    """Median device time of ``fn`` by CUDA events over ``REPS`` calls,
    each after a write of more than the L2 cache, as a forward finds the
    layer's weights (the model's 59 MB of fp32 weights exceed the L2).
    Before each call the device sleeps ``SLEEP_CYCLES`` (about 1 ms) so
    the host has enqueued the start event, the call and the end event
    before the device reaches them: the events time the device's work,
    not the host's wrapper, even for calls shorter than their enqueue."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def host_ms(fn) -> float:
    """Median host wall time of ``fn`` ending in a device sync."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def layer_parity(prog, cpu_prog, images, dev) -> list[dict]:
    """Each layer of the forward on the card against the same layer of
    the plain path on the CPU, both fed the CPU path's input to that
    layer: the per-layer difference without the compounding of earlier
    layers' rounding through 13 ``channel_norm``s."""
    import torch

    from repro_torch.engine.executor import _Dispatch, _run_conv, _run_fc

    card, host = _Dispatch(dev), _Dispatch(torch.device("cpu"))
    x = torch.as_tensor(images)
    rows = []
    for op, cop in zip([*prog.convs, prog.fc], [*cpu_prog.convs, cpu_prog.fc]):
        if op is prog.fc:
            x = x.mean(dim=(2, 3))
            want = _run_fc(cop, x, host, host.prepare(cop.bp, cop.bias))
            got = _run_fc(op, x.to(dev), card, card.prepare(op.bp, op.bias))
        else:
            want, _ = _run_conv(cop, x, host, host.prepare(cop.bp, cop.bias))
            got, _ = _run_conv(op, x.to(dev), card,
                               card.prepare(op.bp, op.bias))
        diff = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        rows.append({"layer": getattr(op, "name", "fc"), "max_abs_diff": diff,
                     "max_abs": scale, "rel": diff / max(scale, 1.0)})
        x = want
    return rows


def mapping_mismatches(a, b) -> list[str]:
    """Layers whose searched mapping (or the FC reorder) differs."""
    bad = [c.name for c, d in zip(a.convs, b.convs)
           if (c.mapping is None) != (d.mapping is None)
           or (c.mapping is not None
               and c.mapping.to_manifest() != d.mapping.to_manifest())]
    if a.fc.reorder != b.fc.reorder:
        bad.append("fc.reorder")
    return bad


def spmm_checks(prog, rng, dev) -> tuple[list[dict], float]:
    """The fp32 spmm kernel against its plain version at every layer of
    ``prog``; returns the rows and the largest difference."""
    rows, worst = [], 0.0
    for name, bp, x in layer_cases(prog, rng, dev):
        kernel, plain = calls("pattern_spmm_cuda", bp, x, dev)
        res = compare("pattern_spmm_cuda", kernel(), plain(), bp)
        rows.append({"case": name, "m": x.shape[0], "k": bp.k_in,
                     "n": bp.n_out, "k_max": bp.k_max,
                     "bricks": int(bp.nnz.sum()), **res})
        worst = max(worst, res["max_abs_diff"])
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"pattern_spmm_cuda disagrees with its plain version on "
                   f"{bad}")
    return rows, worst


def ratios(rep) -> dict:
    """The paper's efficiency ratios of one ``hardware_report``."""
    return {
        "crossbars": rep["crossbars"],
        "naive_crossbars": rep["naive_crossbars"],
        "area_efficiency": rep["area_efficiency"],
        "area_cells": rep["area_cells"],
        "naive_area_cells": rep["naive_area_cells"],
        "area_cells_ratio": rep["naive_area_cells"] / rep["area_cells"],
        "energy_pj": rep["energy_pj"],
        "naive_energy_pj": rep["naive_energy_pj"],
        "energy_ratio": rep["naive_energy_pj"] / rep["energy_pj"],
    }


def search_phase(seed, cfg, params, tparams, bits, images, dense_labels,
                 fixed_prog, dev) -> dict:
    """Compile with the mapping search on the card, hold it against the
    same compile on the CPU, serve it with skip statistics and price the
    served traffic.  Returns the spmm launches and largest kernel error."""
    import torch

    from repro_torch.core.mapping import MappingCandidate
    from repro_torch.engine import (
        CompileOptions,
        InferenceService,
        compile_network,
        load_program,
        make_forward,
        save_program,
    )
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.api import Request

    tracer = Tracer()
    t0 = time.perf_counter()
    prog = compile_network(
        cfg, tparams, bits,
        options=CompileOptions(optimize="auto", tracer=tracer), device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin = compile_network(cfg, params, bits,
                           options=CompileOptions(optimize="auto"),
                           device="cpu")
    cpu_s = time.perf_counter() - t0
    check(all(isinstance(c.mapping, MappingCandidate) for c in prog.convs),
          "a conv of the searched program carries no MappingCandidate")
    mism = program_mismatches(prog, twin) + mapping_mismatches(prog, twin)
    check(not mism, f"searched compile on the card differs from the CPU's "
                    f"in {mism}")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = save_program(os.path.join(tmp, "vgg16_searched"), prog)
        loaded = load_program(path, device=dev)
        cpu_prog = load_program(path, device="cpu")
    for other, where in ((loaded, "card"), (cpu_prog, "CPU")):
        mism = program_mismatches(prog, other) + mapping_mismatches(prog,
                                                                    other)
        check(not mism, f"searched save/load ({where}) changed {mism}")
    fixed_rep = fixed_prog.hardware_report()
    searched_rep = loaded.hardware_report()
    check(searched_rep["area_cells"] <= fixed_rep["area_cells"]
          and searched_rep["energy_pj"] <= fixed_rep["energy_pj"],
          "the searched mapping is worse than the fixed scheme")

    # the searched reorders give the spmm kernel a new brick layout
    kernel_rows, worst = spmm_checks(loaded, np.random.default_rng(seed + 4),
                                     dev)

    svc = InferenceService(loaded, batch_slots=BATCH_SLOTS, device=dev,
                           collect_stats=True)
    svc.warmup()
    # the searched path: counts from 0, the trace through the service, read
    tk.pattern_spmm_cuda.launches = 0
    tk.pattern_spmm_cuda.reduce_launches = 0
    reqs = [Request(image=img) for img in images]
    serve_s = serve_bursts(svc, reqs)
    launches = tk.pattern_spmm_cuda.launches
    reduce_launches = tk.pattern_spmm_cuda.reduce_launches
    spmms = len(loaded.convs) + 1
    check(all(r.done for r in reqs), "a request was not served")
    check(launches == spmms * svc.batches_run,
          f"pattern_spmm_cuda launches {launches} != {spmms} x "
          f"{svc.batches_run} batches of the searched program")
    want = reduce_launches_expected(loaded, svc.batches_run)
    check(reduce_launches == want, f"searched program's split reductions "
                                   f"{reduce_launches} != {want}")
    labels = np.array([r.label for r in reqs])
    check(bool((labels == dense_labels).all()),
          "the searched program's labels differ from the dense reference's")
    parity = layer_parity(loaded, cpu_prog, images[:BATCH_SLOTS], dev)
    bad = [r["layer"] for r in parity if r["rel"] > LAYER_TOL]
    check(not bad, f"searched layers {bad} differ from the CPU plain path")

    fwd = make_forward(loaded, tracer=Tracer(), device=dev)
    for _ in range(5):
        fwd(images[:BATCH_SLOTS])
    observed = fwd.observed_times()
    t0 = time.perf_counter()
    rep = svc.hardware_report(assumed_skip=0.5, observed=observed)
    report_s = time.perf_counter() - t0
    _, cpu_stats = make_forward(cpu_prog, collect_stats=True,
                                device="cpu")(images)
    cpu_rep = cpu_prog.hardware_report(skip_stats=cpu_stats, assumed_skip=0.5,
                                       observed=observed)
    differ = [f for f in PRICE_FIELDS if rep[f] != cpu_rep[f]]
    check(not differ, f"hardware_report fields {differ} differ between the "
                      f"card's program and the CPU's")
    names = sorted(c.name for c in loaded.convs)
    check(rep["skip"]["measured_layers"] == names,
          f"measured layers {rep['skip']['measured_layers']} != {names}")
    check(rep["energy_pj_measured"] <= rep["energy_pj"],
          "measured-skip energy above the no-skip bound")

    spans = {sp.name: sp for sp in tracer.spans()
             if sp.name.startswith("search:")}
    e_card, e_cpu = rep["energy_pj_measured"], cpu_rep["energy_pj_measured"]
    emit("search", model="vgg16 cifar10 (synthesize_network)",
         compile_seconds={"card": card_s, "cpu_twin": cpu_s},
         search_seconds={n: sp.dur for n, sp in spans.items()},
         evaluations={n: sp.args.get("evaluations") for n, sp in spans.items()
                      if n != "search:fc"},
         chosen={c.name: c.mapping.to_manifest() for c in loaded.convs},
         fc=spans["search:fc"].args if "search:fc" in spans else None,
         bricks={c.name: [int(c.bp.nnz.sum()), int(f.bp.nnz.sum())]
                 for c, f in zip(loaded.convs, fixed_prog.convs)},
         bricks_note="[searched, fixed]",
         bit_equal_vs_cpu_compile=True, round_trip_bit_equal=True,
         fixed=ratios(fixed_rep), searched=ratios(searched_rep),
         never_worse=True, kernel_cases=kernel_rows,
         requests=len(reqs), batches=svc.batches_run, launches=launches,
         reduce_launches=reduce_launches,
         requests_per_s=len(reqs) / serve_s,
         labels_match_dense=True, layer_limit=f"max|d| <= {LAYER_TOL} * "
                                              "max(1, max|cpu layer|)",
         layer_parity_vs_cpu=parity,
         report_seconds=report_s,
         price_fields_equal_cpu=list(PRICE_FIELDS),
         skip={k: rep["skip"][k] for k in (
             "assumed_probability", "measured_windows", "measured_layers",
             "energy_pj_noskip", "energy_pj_assumed", "energy_pj_measured",
             "measured_discount", "measured_vs_assumed_delta_frac")},
         measured_energy_card_vs_cpu={
             "card": e_card, "cpu": e_cpu,
             "rel_diff": (e_card - e_cpu) / e_cpu if e_cpu else None},
         measured_layer_energy=[
             {"layer": a["name"], "card": a["energy_pj_measured"],
              "cpu": b["energy_pj_measured"]}
             for a, b in zip(rep["layers"], cpu_rep["layers"])],
         drift=rep["drift"])
    return {"launches": launches, "max_abs_err": worst, "program": loaded}


def prune_batches(cfg, seed: int, lo: float, hi: float):
    """Endless class-prototype batches ``(x, y)`` of ``PRUNE_BATCH``
    images, as numpy: one seeded prototype per class, each image its
    class's prototype plus ``PRUNE_NOISE`` normal noise, clipped to
    ``[lo, hi]``."""
    rng = np.random.default_rng(seed)
    shape = (cfg.conv_channels[0][0], cfg.input_hw, cfg.input_hw)
    protos = rng.normal(size=(cfg.num_classes, *shape))
    while True:
        y = rng.integers(0, cfg.num_classes, size=PRUNE_BATCH)
        x = protos[y] + PRUNE_NOISE * rng.normal(size=(PRUNE_BATCH, *shape))
        yield np.clip(x, lo, hi).astype(np.float32), y


def attaining_image(w: np.ndarray, j: int, sign: float, amax: float,
                    hw: int) -> np.ndarray:
    """A ``[1, C, hw, hw]`` image whose conv1 patch around the centre
    pixel is ``sign * amax * sign(w[j])`` and zero elsewhere: the input
    in ``[-amax, amax]`` at which output column ``j``'s spmm + bias
    reaches ``b_j + sign * amax * sum|w_j|``, the certificate's
    ``pre_hi`` (``sign=+1``) or ``pre_lo`` (``sign=-1``) when ``j`` is the
    column that sets it."""
    _, c_in, k, _ = w.shape
    img = np.zeros((1, c_in, hw, hw), np.float32)
    c, r = hw // 2, k // 2
    img[0, :, c - r:c + r + 1, c - r:c + r + 1] = sign * amax * np.sign(w[j])
    return img


def bound_rounding_limit(b_j: float, w_j: np.ndarray, amax: float) -> float:
    """How far an fp32 spmm + bias may land from its exact value at the
    attaining input: ``n * 2^-24 * (|b_j| + amax * sum|w_j|)`` for the
    ``n`` terms it sums (the patch's products and the bias; 28 for a
    3x3x3 conv1)."""
    n = np.size(w_j) + 1
    return n * 2.0 ** -24 * (abs(float(b_j))
                             + amax * float(np.abs(w_j).astype(np.float64)
                                            .sum()))


def pre_activations(prog, images, dev) -> list:
    """Each spmm layer's output plus bias (before ``channel_norm``, ReLU
    and pooling; the logits for ``fc``) over ``images``, through the
    dispatch the forward uses on ``dev``, each layer fed the previous
    layer's output: ``[(name, [rows, columns] tensor)]``."""
    import torch

    from repro_torch.engine.executor import _Dispatch, _run_conv, _run_fc

    class Recording(_Dispatch):
        def spmm(self, x2d, prepared):
            self.last = super().spmm(x2d, prepared)
            return self.last

    disp = Recording(dev)
    x = torch.as_tensor(images, device=dev)
    out = []
    for op in prog.convs:
        prep = disp.prepare(op.bp, op.bias)
        x, _ = _run_conv(op, x, disp, prep)
        out.append((op.name, disp.last[:, :op.c_out] + prep.bias))
    prep = disp.prepare(prog.fc.bp, prog.fc.bias)
    out.append(("fc", _run_fc(prog.fc, x.mean(dim=(2, 3)), disp, prep)))
    return out


def prune_phase(seed: int, dev) -> dict:
    """The paper's flow, entirely in the port on the card: dense training
    of full-width VGG16, ADMM pattern pruning, strict compiles (verified,
    range-certified) in fp32 and int8 held against the same compiles on
    the CPU, save and reload with verification, the analysis CLI on the
    saved programs, serving through both spmm kernels, and the
    certificates held against the kernels' outputs.  Returns the spmm
    launches of its serving and the kernels' largest errors."""
    import torch
    import torch.nn.functional as F

    from repro_torch.analysis.ranges import DEFAULT_INPUT_RANGE
    from repro_torch.core.patterns import ALL_ZERO, kernel_masks, masks_to_bits
    from repro_torch.core.pruning import (
        PruneConfig,
        _grad,
        admm_pattern_prune,
        sparsity_of,
    )
    from repro_torch.engine import (
        CompileOptions,
        InferenceService,
        compile_network,
        load_program,
        make_forward,
        save_program,
    )
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.models.cnn import cnn_apply, conv_weight_names, init_cnn
    from repro_torch.obs.trace import Tracer
    from repro_torch.optim import adamw
    from repro_torch.serve.api import Request

    cfg = prune_model_config()
    names = conv_weight_names(cfg)
    lo, hi = DEFAULT_INPUT_RANGE
    amax = max(abs(lo), abs(hi))
    stream = prune_batches(cfg, seed + 6, lo, hi)

    def batches():
        for x, y in stream:
            yield (torch.as_tensor(x, device=dev),
                   torch.as_tensor(y, device=dev))

    def loss_fn(p, x, y):
        return F.cross_entropy(cnn_apply(cfg, p, x), y)

    # -- dense training ---------------------------------------------------
    params = init_cnn(cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = adamw(weight_decay=0.0)
    state = opt.init(params)
    data = batches()
    losses = []

    def recorded(p, x, y):
        loss = loss_fn(p, x, y)
        losses.append(loss.detach())
        return loss

    t0 = time.perf_counter()
    for _ in range(PRUNE_DENSE_STEPS):
        grads = _grad(recorded, params, *next(data))
        params, state = opt.update(grads, state, params, PRUNE_LR)
    dense_losses = torch.stack(losses).tolist()
    dense_s = time.perf_counter() - t0

    # -- ADMM pattern pruning ---------------------------------------------
    pcfg = PruneConfig(**PRUNE_CFG)
    tracer = Tracer()
    t0 = time.perf_counter()
    res = admm_pattern_prune(params, names, loss_fn, data, pcfg,
                             adamw(weight_decay=0.0), lr=PRUNE_LR, seed=seed,
                             tracer=tracer)
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t0
    stages = {sp.name: sp.dur for sp in tracer.spans("prune")}
    # the retrain span ends when its steps are enqueued; the device's
    # work is done at the synchronize above
    stages["retrain"] = prune_s - sum(v for k, v in stages.items()
                                      if k != "retrain")
    held_x, held_y = next(stream)
    with torch.no_grad():
        final_loss = float(loss_fn(res.params, torch.as_tensor(
            held_x, device=dev), torch.as_tensor(held_y, device=dev)))
    hparams = {n: {k: t.detach().cpu().numpy() for k, t in layer.items()}
               for n, layer in res.params.items()}
    layers = {}
    for n in names:
        pattern = res.pattern_bits[n]
        bits = masks_to_bits(kernel_masks(hparams[n]["w"]))
        used = sorted(set(np.unique(pattern).tolist()) - {ALL_ZERO})
        layers[n] = {
            "patterns_outside_dictionary": int((~np.isin(
                pattern, res.dictionaries[n].patterns)).sum()),
            "kernels_with_weights_outside_pattern": int(
                np.count_nonzero(bits & ~pattern)),
            # a pattern position left exactly zero: pruned before ADMM and
            # never moved by a gradient (its input channel is dead)
            "kernels_below_pattern": int(np.count_nonzero(bits != pattern)),
            "nonzero_patterns": len(used),
            "all_zero_kernels": float((pattern == ALL_ZERO).mean()),
            "sparsity": res.layer_sparsity(n),
        }
    bad = [n for n, r in layers.items()
           if r["patterns_outside_dictionary"]
           or r["kernels_with_weights_outside_pattern"]
           or r["nonzero_patterns"] > pcfg.num_patterns]
    check(not bad, f"pruned layers {bad} leave their pattern dictionaries: "
                   f"{ {n: layers[n] for n in bad} }")
    check(np.isfinite(final_loss) and np.isfinite(dense_losses).all(),
          "training loss not finite")

    # -- strict compiles, card against CPU --------------------------------
    progs, compile_s, spans = {}, {}, {}
    for prec in ("fp32", "int8"):
        ctr = Tracer()
        t0 = time.perf_counter()
        prog = compile_network(cfg, res.params, res.pattern_bits,
                               options=CompileOptions(precision=prec,
                                                      verify="strict",
                                                      tracer=ctr),
                               device=dev)
        compile_s[prec] = time.perf_counter() - t0
        spans[prec] = {sp.name: sp.dur for sp in ctr.spans("compile")
                       if sp.name in ("verify", "ranges")}
        t0 = time.perf_counter()
        twin = compile_network(cfg, hparams, res.pattern_bits,
                               options=CompileOptions(precision=prec,
                                                      verify="strict"),
                               device="cpu")
        compile_s[f"{prec}_cpu_twin"] = time.perf_counter() - t0
        check(prog.certificate is not None, f"{prec}: no certificate")
        check(prog.certificate.to_manifest() == twin.certificate.to_manifest(),
              f"{prec}: the card's certificate differs from the CPU's")
        check(prog.verify().to_json() == twin.verify().to_json(),
              f"{prec}: verifier reports differ between card and CPU")
        mism = program_mismatches(prog, twin)
        check(not mism, f"{prec}: strict compile differs from the CPU's in "
                        f"{mism}")
        progs[prec] = prog

    # -- save, reload with verification, the analysis CLI -----------------
    loaded, cpu_progs, load_s, cli = {}, {}, {}, {}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for prec, prog in progs.items():
            path = save_program(os.path.join(tmp, f"pruned_{prec}"), prog)
            t0 = time.perf_counter()
            loaded[prec] = load_program(path, device=dev)  # verifies
            load_s[prec] = time.perf_counter() - t0
            t0 = time.perf_counter()
            load_program(path, verify=False, device=dev)
            load_s[f"{prec}_unverified"] = time.perf_counter() - t0
            cpu_progs[prec] = load_program(path, device="cpu")
            check(not program_mismatches(prog, loaded[prec]),
                  f"{prec}: save/load changed the program")
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.analysis", "all", path,
                 "--json"], capture_output=True, text=True, env=env,
                cwd=ROOT, timeout=600)
            cli_s = time.perf_counter() - t0
            merged = json.loads(out.stdout) if out.returncode == 0 else {}
            cli[prec] = {
                "exit_code": out.returncode, "seconds": cli_s,
                "certificate_equal": merged.get("ranges", {}).get(
                    "certificate") == prog.certificate.to_manifest()}
            check(out.returncode == 0 and cli[prec]["certificate_equal"],
                  f"python -m repro_torch.analysis all on the {prec} program: "
                  f"exit {out.returncode} {out.stderr[-500:]}")

    # -- each spmm kernel against its plain version on the pruned bricks --
    rng = np.random.default_rng(seed + 7)
    max_err, kernel_rows = {}, {}
    for kname, prec in (("pattern_spmm_cuda", "fp32"),
                        ("pattern_spmm_quant_cuda", "int8")):
        rows = []
        for name, bp, x in layer_cases(loaded[prec], rng, dev):
            kernel, plain = calls(kname, bp, x, dev)
            r = compare(kname, kernel(), plain(), bp)
            rows.append({"case": name, "k_max": bp.k_max,
                         "bricks": int(bp.nnz.sum()), **r})
        kernel_rows[kname] = rows
        max_err[kname] = max(r["max_abs_diff"] for r in rows)
        bad = [r["case"] for r in rows if not r["ok"]]
        check(not bad, f"{kname} disagrees with its plain version on the "
                       f"pruned layers {bad}")

    # -- serving through both spmm kernels --------------------------------
    drawn = [next(stream) for _ in range(-(-PRUNE_REQUESTS // PRUNE_BATCH))]
    images = np.concatenate([x for x, _ in drawn])[:PRUNE_REQUESTS]
    truth = np.concatenate([y for _, y in drawn])[:PRUNE_REQUESTS]
    svc32 = InferenceService(loaded["fp32"], batch_slots=BATCH_SLOTS,
                             device=dev)
    svc8 = InferenceService(loaded["int8"], batch_slots=BATCH_SLOTS,
                            device=dev)
    svc32.warmup()
    svc8.warmup()
    # the pruned path: counts from 0, traffic through both services, read
    tk.pattern_spmm_cuda.launches = 0
    tk.pattern_spmm_quant_cuda.launches = 0
    reqs32 = [Request(image=img) for img in images]
    reqs8 = [Request(image=img) for img in images]
    serve32_s = serve_bursts(svc32, reqs32)
    serve8_s = serve_bursts(svc8, reqs8)
    launches = {"pattern_spmm_cuda": tk.pattern_spmm_cuda.launches,
                "pattern_spmm_quant_cuda": tk.pattern_spmm_quant_cuda.launches}
    spmms = len(cfg.conv_channels) + 1
    batches_run = {"fp32": svc32.batches_run, "int8": svc8.batches_run}
    check(all(r.done for r in reqs32 + reqs8), "a pruned request was not "
                                                "served")
    for kname, prec in (("pattern_spmm_cuda", "fp32"),
                        ("pattern_spmm_quant_cuda", "int8")):
        check(launches[kname] == spmms * batches_run[prec],
              f"{kname} launches {launches[kname]} != {spmms} x "
              f"{batches_run[prec]} {prec} batches of the pruned program")
    logits32 = np.stack([r.logits for r in reqs32])
    labels32 = np.array([r.label for r in reqs32])
    labels8 = np.array([r.label for r in reqs8])
    with torch.no_grad():
        dense = cnn_apply(cfg, res.params, torch.as_tensor(
            images, device=dev)).cpu().numpy()
    top2 = np.sort(dense, axis=1)[:, -2:]
    cpu_logits = make_forward(cpu_progs["fp32"], device="cpu")(images).numpy()
    e2e = float(np.abs(logits32 - cpu_logits).max()
                / max(1.0, float(np.abs(cpu_logits).max())))
    parity = layer_parity(loaded["fp32"], cpu_progs["fp32"],
                          images[:BATCH_SLOTS], dev)
    check(bool(np.isfinite(logits32).all()), "pruned logits not finite")
    check(bool((labels32 == dense.argmax(1)).all()),
          "pruned program's labels differ from the dense reference's")
    bad = [r["layer"] for r in parity if r["rel"] > LAYER_TOL]
    check(not bad, f"pruned layers {bad} differ from the CPU plain path")
    check(e2e <= E2E_TOL, f"pruned logits differ from the CPU plain path by "
                          f"{e2e} (relative) > {E2E_TOL}")

    # -- the certificates against the kernels ------------------------------
    prog32 = loaded["fp32"]
    cert = prog32.certificate.layer(prog32.convs[0].name)
    w1 = hparams[names[0]]["w"].astype(np.float64)
    b1 = np.asarray(prog32.convs[0].bias, np.float64)
    reach = amax * np.abs(w1).reshape(w1.shape[0], -1).sum(axis=1)
    hw = cfg.input_hw
    centre = (hw // 2) * hw + hw // 2
    bound_rows = []
    for which, sign, j, bound in (
        ("pre_hi", 1.0, int(np.argmax(b1 + reach)), cert.pre_hi),
        ("pre_lo", -1.0, int(np.argmin(b1 - reach)), cert.pre_lo),
    ):
        img = attaining_image(hparams[names[0]]["w"], j, sign, amax, hw)
        got = float(pre_activations(prog32, img, dev)[0][1][centre, j])
        limit = bound_rounding_limit(b1[j], hparams[names[0]]["w"][j], amax)
        bound_rows.append({"bound": which, "column": j, "certified": bound,
                           "kernel": got, "distance": abs(got - bound),
                           "limit": limit,
                           "ok": abs(got - bound) <= limit})
    check(all(r["ok"] for r in bound_rows),
          f"conv1 through the kernel misses its certified bound: "
          f"{bound_rows}")
    inside = {}
    for prec, prog in loaded.items():
        rows = []
        for (name, pre), entry in zip(pre_activations(prog, images, dev),
                                      prog.certificate.layers):
            check(name == entry.name, f"certificate order {entry.name} != "
                                      f"{name}")
            got_lo, got_hi = float(pre.min()), float(pre.max())
            rows.append({"layer": name, "min": got_lo, "max": got_hi,
                         "pre_lo": entry.pre_lo, "pre_hi": entry.pre_hi,
                         "inside": entry.pre_lo <= got_lo
                         and got_hi <= entry.pre_hi})
        inside[prec] = rows
        bad = [r["layer"] for r in rows if not r["inside"]]
        check(not bad, f"{prec}: layers {bad} leave their certified "
                       f"[pre_lo, pre_hi]")

    emit("prune", model="vgg16 cifar10, trained on class-prototype batches",
         seed=seed, batch=PRUNE_BATCH, dense_steps=PRUNE_DENSE_STEPS,
         prune_config=PRUNE_CFG, lr=PRUNE_LR,
         seconds={"dense_training": dense_s, **stages, "prune_total": prune_s},
         dense_loss_first_last=[dense_losses[0], dense_losses[-1]],
         final_loss_held_out=final_loss,
         sparsity=sparsity_of(res.params, names), layers=layers,
         compile_seconds=compile_s, verify_ranges_span_seconds=spans,
         load_seconds=load_s, analysis_cli=cli,
         certificate_equal_cpu=True, verifier_reports_equal_cpu=True,
         fp32_safe={p: g.certificate.fp32_safe for p, g in loaded.items()},
         kernel_cases=kernel_rows, requests=PRUNE_REQUESTS,
         batches=batches_run, launches=launches,
         requests_per_s={"fp32": PRUNE_REQUESTS / serve32_s,
                         "int8": PRUNE_REQUESTS / serve8_s},
         labels_match_dense=True,
         min_dense_top2_margin=float((top2[:, 1] - top2[:, 0]).min()),
         served_accuracy={"fp32": float((labels32 == truth).mean()),
                          "int8": float((labels8 == truth).mean())},
         e2e_rel_vs_cpu=e2e, layer_parity_vs_cpu=parity,
         int8_top1_agreement_vs_fp32=float((labels8 == labels32).mean()),
         conv1_bound=bound_rows, layers_inside_certificate=inside)
    return {"launches": launches, "max_abs_err": max_err}


def ou_cases(prog, params, images, dev) -> list[tuple]:
    """(case, x, w, ou_rows, ou_cols) on the card: each conv's dense
    im2col weight [C_in*9, C_out] at two patches of the layer's real
    input on the card (the centre, and the top-left corner, where the
    zero padding and ReLU's zeros empty whole bands), then the
    reference's sweep shapes, an all-zero x, and a NaN in the weights of
    a skipped band."""
    import torch

    from repro_torch.engine.executor import _Dispatch, _run_conv, extract_patches
    from repro_torch.engine.lowering import conv_matrix

    disp = _Dispatch(dev)
    x = torch.as_tensor(images[:1], device=dev)
    cases = []
    with torch.no_grad():
        for op in prog.convs:
            patches = extract_patches(x, op.kernel)[0]  # [H, W, C_in*9]
            mid = patches.shape[0] // 2
            w = torch.as_tensor(
                np.ascontiguousarray(conv_matrix(params[op.name]["w"])),
                dtype=torch.float32, device=dev)
            for where, patch in (("centre", patches[mid, mid]),
                                 ("corner", patches[0, 0])):
                cases.append((f"{op.name}/{where}", patch.contiguous(), w,
                              OU_ROWS, OU_COLS))
            x, _ = _run_conv(op, x, disp, disp.prepare(op.bp, op.bias))
    rng = np.random.default_rng(7)
    for r, c, ou_r, ou_c in OU_SWEEP:
        xs = rng.normal(size=r).astype(np.float32)
        xs[:ou_r] = 0.0
        cases.append((f"sweep_{r}x{c}_ou{ou_r}x{ou_c}",
                      torch.as_tensor(xs, device=dev),
                      torch.as_tensor(rng.normal(size=(r, c)).astype(
                          np.float32), device=dev), ou_r, ou_c))
    w13 = cases[2 * len(prog.convs) - 1][2]
    cases.append(("all_zero_x", torch.zeros(w13.shape[0], device=dev), w13,
                  OU_ROWS, OU_COLS))
    xs = rng.normal(size=27).astype(np.float32)
    xs[9:18] = 0.0
    ws = rng.normal(size=(27, 8)).astype(np.float32)
    ws[12, 3] = np.nan
    cases.append(("nan_in_skipped_band", torch.as_tensor(xs, device=dev),
                  torch.as_tensor(ws, device=dev), OU_ROWS, OU_COLS))
    return cases


def ou_live_rows(x, ou_rows: int):
    """bool [R]: the rows of the bands the kernel does not skip."""
    from repro_torch.kernels.ou_mvm import band_flags

    return band_flags(x, ou_rows).repeat_interleave(ou_rows)[: x.shape[0]]


def ou_mvm_phase(prog, params, images, dev) -> dict:
    """``ops.ou_mvm`` on the card at every case of :func:`ou_cases`,
    each against its plain version.  Returns the launches, the largest
    difference and the cases (for timing)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ou_mvm as tou

    cases = ou_cases(prog, params, images, dev)
    # the ou_mvm path: counts from 0, every case through ops.ou_mvm, read
    tou.ou_mvm_cuda.launches = 0
    outs = [ops.ou_mvm(x, w, ou_rows=r, ou_cols=c)
            for _, x, w, r, c in cases]
    torch.cuda.synchronize()
    launches = tou.ou_mvm_cuda.launches
    plans = [ou_plan(x, w, r) for _, x, w, r, _ in cases]
    check(launches == len(cases),
          f"ou_mvm_cuda launches {launches} != {len(cases)} calls")
    rows, worst = [], 0.0
    for (name, x, w, r, c), y, plan in zip(cases, outs, plans):
        want = tou.ou_mvm_plain(x, w, r, c)
        live = ou_live_rows(x, r)
        mag = ((x * live)[:, None] * torch.where(live[:, None], w, 0.0)).abs()
        lim = OU_TOL * (1.0 + mag.sum(dim=0))
        d = (y - want).abs()
        row = {"case": name, "r": w.shape[0], "c": w.shape[1],
               "ou": [r, c], "skipped_band_share": float(
                   1.0 - tou.band_flags(x, r).float().mean()),
               "max_abs_diff": float(d.max()),
               "worst_over_limit": float((d / lim).max()),
               "finite": bool(torch.isfinite(y).all()),
               # no atomics: a second run is bit for bit the first
               "rerun_bit_identical": bool(torch.equal(
                   tou.ou_mvm_cuda(x, w, r, c), y)), **plan}
        row["ok"] = (row["worst_over_limit"] <= 1.0 and row["finite"]
                     and row["rerun_bit_identical"])
        if name == "all_zero_x":
            row["ok"] = row["ok"] and not y.any()
        rows.append(row)
        worst = max(worst, row["max_abs_diff"])
    emit("ou_mvm", limit=f"|d_c| <= {OU_TOL} * (1 + sum_r |x_r w_rc|) over "
                         "the live bands", calls=len(cases), launches=launches,
         cases=rows)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"ou_mvm_cuda disagrees with its plain version on {bad}")
    return {"launches": launches, "max_abs_err": worst,
            "cases": cases[:2 * len(prog.convs)]}


def ou_plan(x, w, ou_rows: int) -> dict:
    """The ``ou_mvm`` kernel's plan for one call (``_ou_plan`` of its
    shapes): columns a block, blocks, rows a row-lane walks, passes of x
    through shared memory."""
    from repro_torch.kernels import ou_mvm as tou

    plan = tou._ou_plan(w.shape[0], w.shape[1],
                        tou._ou_vec(w.float().contiguous()))
    return {"slab_cols": plan.cols, "blocks": plan.blocks,
            "rows_per_lane": plan.rows_per_lane, "chunks": plan.chunks}


def ou_cost(x, w, ou_rows: int) -> tuple[float, float]:
    """(bytes, operations) of one ``ou_mvm`` call: x read and y written
    once, and the weight rows of the live bands read once; two
    operations per weight read."""
    live = int(ou_live_rows(x, ou_rows).sum())
    c = w.shape[1]
    return 4.0 * (x.shape[0] + c + live * c), 2.0 * live * c


def serve_bursts(svc, reqs, bursts=BURSTS) -> float:
    """Submit ``reqs`` in ``bursts``, one service step after each burst,
    then drain; returns the host seconds it took."""
    import torch

    it = iter(reqs)
    t0 = time.perf_counter()
    for burst in bursts:
        for _ in range(burst):
            svc.submit(next(it))
        svc.step()
    svc.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def flash_pairs(sq: int, kv_len: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves visible: what the attention
    must compute, whatever tiles a kernel walks."""
    q = np.arange(sq)
    hi = np.minimum(q, kv_len - 1) if causal else np.full(sq, kv_len - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cost(b, hq, hkv, sq, kv_len, d, esize, causal, window):
    """(bytes, operations) of one call: q, the kv_len rows of k and v
    and the output, each moved once; 4 * D operations per visible pair
    (the q.k dot and the p.v update) per query head."""
    nbytes = esize * b * d * (2 * sq * hq + 2 * kv_len * hkv)
    ops = 4.0 * d * b * hq * flash_pairs(sq, kv_len, causal, window)
    return float(nbytes), ops


def flash_cases(dev, max_seq: int) -> list[dict]:
    """Every flash case on the card (see ``FLASH_SWEEP``): q, k, v, the
    mask arguments and, for the path's prefill calls, ``path=True``."""
    import torch

    rng = np.random.default_rng(11)
    cases = []

    def normal(*shape):
        return torch.as_tensor((0.5 * rng.normal(size=shape)).astype(
            np.float32), device=dev)

    for b, hq, hkv, sq, sk, d in FLASH_SWEEP:
        for causal in (True, False):
            for window in (None, 33):
                if causal and sq != sk:
                    continue
                q, k, v = normal(b, hq, sq, d), normal(b, hkv, sk, d), \
                    normal(b, hkv, sk, d)
                for dt in FLASH_TYPES:
                    tdt = getattr(torch, dt)
                    cases.append(dict(
                        case=f"sweep_{b}x{hq}/{hkv}x{sq}x{sk}x{d}_"
                             f"{'causal' if causal else 'full'}_w{window}_"
                             f"{dt}",
                        q=q.to(tdt), k=k.to(tdt), v=v.to(tdt), causal=causal,
                        window=window, kv_len=None, dtype=dt, path=False))
    hq, hkv, d = FLASH_HEADS
    for s in FLASH_PATH_S:
        q = normal(1, hq, s, d).bfloat16()
        kv = normal(2, max_seq, hkv, d).bfloat16()  # [k|v, T, Hkv, D]
        k, v = kv[0:1].transpose(1, 2), kv[1:2].transpose(1, 2)
        cases.append(dict(case=f"path_S{s}_bare", q=q,
                          k=k[:, :, :s].contiguous(),
                          v=v[:, :, :s].contiguous(), causal=True,
                          window=FLASH_WINDOW, kv_len=None, dtype="bfloat16",
                          path=False))
        cases.append(dict(case=f"path_S{s}_cache", q=q, k=k, v=v, causal=True,
                          window=FLASH_WINDOW, kv_len=s, dtype="bfloat16",
                          path=True))
    # padded keys inside the queries' span: kv_len < Sq = Sk
    s = FLASH_PATH_S[-2]
    kv = normal(2, 1, hkv, s, d).bfloat16()
    cases.append(dict(case=f"path_S{s}_kvlen{7 * s // 10}",
                      q=normal(1, hq, s, d).bfloat16(), k=kv[0], v=kv[1],
                      causal=True, window=FLASH_WINDOW, kv_len=7 * s // 10,
                      dtype="bfloat16", path=False))
    return cases


def flash_route(dtype: str) -> str:
    """The route the wrapper takes for an input type: 16-bit inputs the
    tensor cores, fp32 the SIMT kernel."""
    return "simt" if dtype == "float32" else "tensor_core"


def flash_row(c: dict, y) -> dict:
    """One flash case's check of the kernel's output ``y``: against the
    plain version at ``flash_tolerance`` and, for 16-bit inputs, against
    the plain version in fp32 at the rounding limit (``FLASH_HALF_ULP``)."""
    import torch

    from repro_torch.kernels import flash_attention as tfa

    kw = dict(causal=c["causal"], window=c["window"], kv_len=c["kv_len"])
    want = tfa.flash_attention_plain(c["q"], c["k"], c["v"], **kw).float()
    tol = flash_tolerance(c["dtype"])
    d = (y.float() - want).abs()
    lim = tol["atol"] + tol["rtol"] * want.abs()
    row = {"case": c["case"], "q": list(c["q"].shape),
           "k": list(c["k"].shape), "kv_len": c["kv_len"],
           "max_abs_diff": float(d.max()),
           "worst_over_limit": float((d / lim).max()),
           "finite": bool(torch.isfinite(y).all())}
    ok = row["worst_over_limit"] <= 1.0 and row["finite"]
    if c["dtype"] in FLASH_HALF_ULP:
        want32 = tfa.flash_attention_plain(
            c["q"].float(), c["k"].float(), c["v"].float(), **kw)
        d32 = (y.float() - want32).abs()
        mag = want32.abs()
        half = FLASH_HALF_ULP[c["dtype"]] * mag
        row_max = mag.amax(-1, keepdim=True)
        lim32 = half + FLASH_SUM_SLACK * row_max
        over = torch.where(d32 == 0, torch.zeros_like(d32), d32 / lim32)
        row["max_abs_diff_fp32"] = float(d32.max())
        row["max_abs_plain"] = float(mag.max())
        # the rounding alone may reach the first term (half an ulp); what
        # lies beyond it is the fp32 sums' difference, allowed
        # FLASH_SUM_SLACK of the row's largest |value|
        row["fp32_excess_over_row_max"] = float(
            ((d32 - half).clamp(min=0) / row_max.clamp(min=1e-30)).max())
        row["worst_over_rounding_limit"] = float(over.max())
        ok = ok and row["worst_over_rounding_limit"] <= 1.0
    row["ok"] = ok
    return row


def flash_rows(dev, max_seq: int) -> tuple[list[dict], list[dict]]:
    """(rows, cases): the flash kernel against its plain version at every
    case of :func:`flash_cases`, one :func:`flash_row` each."""
    import torch

    from repro_torch.kernels import flash_attention as tfa

    cases = flash_cases(dev, max_seq)
    rows = []
    for c in cases:
        tc0 = tfa.flash_attention_cuda.launches_tensor_core
        y = tfa.flash_attention_cuda(c["q"], c["k"], c["v"],
                                     causal=c["causal"], window=c["window"],
                                     kv_len=c["kv_len"])
        torch.cuda.synchronize()
        route = ("tensor_core" if tfa.flash_attention_cuda.launches_tensor_core
                 > tc0 else "simt")
        rows.append({**flash_row(c, y), "route": route})
    return rows, cases


def flash_phase(dev, max_seq: int) -> dict:
    """The flash kernel against its plain version (the oracle on folded
    heads) at every case of :func:`flash_cases`: at ``flash_tolerance``,
    and the 16-bit cases at the rounding limit too."""
    rows, cases = flash_rows(dev, max_seq)
    worst = max(r["max_abs_diff"] for r, c in zip(rows, cases) if c["path"])
    emit("flash", limit="|d| <= atol + rtol*|plain|, tests/test_kernels.py's "
                        "_tolerance (fp32 2e-5; bf16 and fp16 8e-2, 4e-2)",
         rounding_limit=f"16-bit inputs: |y - plain in fp32| <= half an ulp "
                        f"(bf16 2^-8, fp16 2^-11) x |plain in fp32| + "
                        f"{FLASH_SUM_SLACK} x the row's max |plain in fp32|",
         cases=rows)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"flash_attention_cuda disagrees with its plain version "
                   f"on {bad}")
    wrong = [r["case"] for r, c in zip(rows, cases)
             if r["route"] != flash_route(c["dtype"])]
    check(not wrong, f"flash cases {wrong} took the wrong route")
    return {"max_abs_err": worst, "cases": [c for c in cases if c["path"]]}


def build_lm(seed: int, dev):
    """(cfg, params, statics): full-width, full-depth h2o-danube-1.8B with
    the pattern-sparse MLPs, bf16 weights drawn on the card from the
    seed."""
    import torch

    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models.transformer import init_params

    cfg = h2o_danube_1_8b.config(sparse=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, statics = init_params(cfg, gen, device=dev)
    return cfg, params, statics


def gen_prompts(vocab: int, seed: int) -> list[np.ndarray]:
    """``GEN_REQUESTS`` seeded prompts of ``GEN_LENGTHS`` tokens (none a
    multiple of 128) and the ``GEN_LONG`` one at ``GEN_LONG_AT``."""
    rng = np.random.default_rng(seed)
    lo, hi = GEN_LENGTHS
    lengths = [int(n) + (n % 128 == 0) for n in
               rng.integers(lo, hi + 1, GEN_REQUESTS)]
    lengths.insert(GEN_LONG_AT, GEN_LONG)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def prefill_logits(params, statics, prompt, max_seq, cache_dtype, kernel,
                   dev):
    """float32 [L, vocab] logits of one prompt's prefill on a fresh cache,
    as the service prefills it, by the kernel route or the plain one
    (``apply_model``'s ``prefill`` flag: false keeps every layer on the
    attention's full or chunked route, and nothing else changes)."""
    import torch

    from repro_torch.models.transformer import apply_model, init_cache

    n = len(prompt)
    row = init_cache(statics, 1, max_seq, dtype=cache_dtype, device=dev)
    toks = torch.as_tensor(prompt[None].astype(np.int64), device=dev)
    with torch.no_grad():
        logits, _, _ = apply_model(
            params, statics, toks, positions=torch.arange(n, device=dev),
            cache=row, cache_pos=0, cache_len=n, prefill=kernel)
    return logits[0, :, : statics["cfg"].vocab].float()


def rel_diff(a, b) -> float:
    """max|a - b| relative to max(1, max|b|)."""
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def generate_phase(seed: int, dev) -> dict:
    """Token generation at full width and depth through ``DecodeService``:
    seeded prompts in bursts (slots refill mid-decode), every prefill
    through the flash kernel, then the checks and the report."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime.serve import DecodeService, ServeConfig
    from repro_torch.serve.api import Request

    t0 = time.perf_counter()
    cfg, params, statics = build_lm(seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(**GEN_SCFG)
    prompts = gen_prompts(cfg.vocab, seed + 6)
    tracer = Tracer()
    svc = DecodeService(cfg, statics, params, scfg, tracer=tracer, device=dev)
    svc.submit(Request(prompt=np.ones(4, np.int32), max_new_tokens=2))
    svc.run()  # warm-up through the real admit/decode path
    svc.reset_metrics()
    tracer.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the generate path: counts from 0, the bursts through the service, read
    tfa.flash_attention_cuda.launches = 0
    tfa.flash_attention_cuda.launches_tensor_core = 0
    tfa.flash_attention_cuda.launches_simt = 0
    reqs = [Request(prompt=p, max_new_tokens=GEN_NEW) for p in prompts]
    run_s = serve_bursts(svc, reqs, GEN_BURSTS)
    launches = tfa.flash_attention_cuda.launches
    routes = {"tensor_core": tfa.flash_attention_cuda.launches_tensor_core,
              "simt": tfa.flash_attention_cuda.launches_simt}
    peak = torch.cuda.max_memory_allocated()
    m = svc.metrics
    spans = tracer.spans()
    prefill_ms = {}
    for sp in spans:
        if sp.name == "serve.prefill":
            prefill_ms.setdefault(int(sp.args["len"]), []).append(
                sp.dur * 1e3)
    decode = [sp for sp in spans if sp.name == "serve.decode"]
    mid = sum(1 for e in tracer.events()
              if e.get("args", {}).get("event") == "admit_mid_decode")
    out_tokens = sum(len(r.output) for r in reqs)

    # co-batched against alone: two requests again, each alone
    alone = {}
    for i in (0, GEN_LONG_AT):
        r = Request(prompt=prompts[i], max_new_tokens=GEN_NEW)
        svc.submit(r)
        svc.run()
        alone[i] = r.output == reqs[i].output

    # prefill logits, kernel route against plain route, on the card
    bf16 = getattr(torch, scfg.cache_dtype)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    statics32 = {**statics, "cfg": cfg32}
    params32 = _map_tensors(params, lambda t: t.float())
    order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
    compare = [order[0], order[len(order) // 2], GEN_LONG_AT]
    parity, first_agree = [], 0
    for i, p in enumerate(prompts):
        plain = prefill_logits(params, statics, p, scfg.max_seq, bf16, False,
                               dev)
        first_agree += int(int(plain[-1].argmax()) == reqs[i].output[0])
        if i not in compare:
            continue
        kern = prefill_logits(params, statics, p, scfg.max_seq, bf16, True,
                              dev)
        ref32 = prefill_logits(params32, statics32, p, scfg.max_seq,
                               torch.float32, False, dev)
        kern32 = prefill_logits(params32, statics32, p, scfg.max_seq,
                                torch.float32, True, dev)
        noise = rel_diff(plain, ref32)
        row = {"prompt_len": len(p),
               "bf16_kernel_vs_plain": rel_diff(kern, plain),
               "bf16_plain_vs_fp32": noise,
               "bf16_kernel_vs_fp32": rel_diff(kern, ref32),
               "bf16_limit": GEN_BF16_NOISE_FACTOR * noise,
               "fp32_kernel_vs_plain": rel_diff(kern32, ref32),
               "last_token_argmax_equal": bool(
                   int(kern[-1].argmax()) == int(plain[-1].argmax())),
               "max_abs_logit": float(plain.abs().max())}
        row["ok"] = (row["bf16_kernel_vs_plain"] <= row["bf16_limit"]
                     and row["fp32_kernel_vs_plain"] <= GEN_FP32_REL)
        parity.append(row)
    del params32
    torch.cuda.empty_cache()

    prefills = len(reqs)
    dec_s = sum(sp.dur for sp in decode)
    dec_tokens = sum(int(sp.args["live"]) for sp in decode)
    res = dict(
        model=cfg.name, sparse=dataclasses.asdict(cfg.sparse),
        layers=cfg.n_layers, d_model=cfg.d_model, heads=[cfg.n_heads,
                                                          cfg.n_kv_heads],
        d_head=cfg.d_head, window=cfg.window, d_ff=cfg.d_ff, vocab=cfg.vocab,
        param_dtype=cfg.param_dtype, init_seconds=init_s,
        serve_config=GEN_SCFG, requests=len(reqs), new_tokens=GEN_NEW,
        bursts=list(GEN_BURSTS),
        prompt_lengths=[len(p) for p in prompts],
        all_done=all(r.done and len(r.output) == GEN_NEW for r in reqs),
        trace_count=svc.trace_count(),
        prefill_trace_count=svc.prefill_trace_count(),
        admitted_mid_decode=mid, prefills=prefills, launches=launches,
        launches_by_route=routes,
        launches_expected=cfg.n_layers * prefills,
        alone_vs_cobatched_equal=alone,
        logits_limit=(f"relative to max|plain logit|: bf16 kernel vs plain "
                      f"<= {GEN_BF16_NOISE_FACTOR} x (bf16 plain vs fp32 "
                      f"plain); fp32 kernel vs plain <= {GEN_FP32_REL}"),
        prefill_logits=parity,
        first_token_agreement_vs_plain=first_agree / len(prompts),
        prefill_ms_by_len={str(k): v for k, v in sorted(prefill_ms.items())},
        run_seconds=run_s, output_tokens=out_tokens,
        tokens_per_s=out_tokens / run_s,
        decode_steps=len(decode), decode_tokens=dec_tokens,
        decode_tokens_per_s=dec_tokens / dec_s if dec_s else None,
        ttft_p50_s=m["first_result_p50_s"], ttft_p99_s=m["first_result_p99_s"],
        latency_p50_s=m["latency_p50_s"], latency_p99_s=m["latency_p99_s"],
        occupancy_mean=m["occupancy_mean"], peak_memory_bytes=peak,
    )
    emit("generate", **res)
    check(res["all_done"], "a generation request did not complete")
    check(res["trace_count"] == 1,
          f"decode trace_count {res['trace_count']} != 1")
    check(mid > 0, "no slot was refilled mid-decode")
    check(launches == res["launches_expected"],
          f"flash_attention_cuda launches {launches} != {cfg.n_layers} "
          f"layers x {prefills} prefills")
    check(routes["tensor_core"] == launches and routes["simt"] == 0,
          f"flash launches by route {routes}: every prefill launch must go "
          f"through the tensor-core route")
    check(all(alone.values()), f"co-batched tokens differ from alone: {alone}")
    bad = [r["prompt_len"] for r in parity if not r["ok"]]
    check(not bad, f"prefill logits of the kernel route off the plain route "
                   f"for prompts of {bad} tokens")
    return {"launches": launches}


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(v, fn) for v in tree]
    return fn(tree)


def run(seed: int, dev) -> dict:
    import torch

    from repro_torch.core.quantize import quantize_bp
    from repro_torch.engine import (
        CompileOptions,
        InferenceService,
        compile_network,
        load_program,
        make_forward,
        save_program,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ou_mvm as tou
    from repro_torch.kernels import pattern_spmm as tk
    from repro_torch.models.cnn import cnn_apply, params_from_numpy
    from repro_torch.serve.api import Request

    # -- 1. device -------------------------------------------------------
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    ptxas = ([ln.split(":", 1)[1].strip() for ln in log.read_text().splitlines()
              if "Used" in ln] if log.exists() else [])
    emit("build", seconds=build_s, library=os.path.relpath(lib, ROOT),
         ptxas=ptxas)

    # -- 3. compile full-width VGG16, fp32 and int8; save and reload ----
    cfg, params, bits = build_model(seed)
    tparams = params_from_numpy(params, dev)
    t0 = time.perf_counter()
    prog32 = compile_network(cfg, tparams, bits, options=CompileOptions(),
                             device=dev)
    fp32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog8 = compile_network(cfg, tparams, bits,
                            options=CompileOptions(precision="int8"),
                            device=dev)
    int8_s = time.perf_counter() - t0
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = save_program(os.path.join(tmp, "vgg16_fp32"), prog32)
        loaded = load_program(path, device=dev)
        cpu_prog = load_program(path, device="cpu")
    mism = program_mismatches(prog32, loaded)
    check(not mism, f"save/load round trip changed {mism}")
    check(not program_mismatches(prog32, cpu_prog), "CPU load differs")
    emit("compile", model="vgg16 cifar10 (synthesize_network)",
         convs=len(prog32.convs), block=prog32.block, tile=prog32.tile,
         fp32_seconds=fp32_s, int8_seconds=int8_s,
         bricks={**{op.name: int(op.bp.nnz.sum()) for op in prog32.convs},
                 "fc": int(prog32.fc.bp.nnz.sum())},
         round_trip_bit_equal=True)

    # -- 4. each kernel against its plain version, on the card ----------
    rng = np.random.default_rng(seed + 2)
    cases = {
        "pattern_spmm_cuda": layer_cases(prog32, rng, dev),
        "pattern_spmm_quant_cuda": layer_cases(prog8, rng, dev),
    }
    extra = small_geometry_case(rng, dev)
    extras = {
        "pattern_spmm_cuda": [extra],
        "pattern_spmm_quant_cuda": [(extra[0], quantize_bp(extra[1]),
                                     extra[2])],
    }
    max_err = {}
    for kname in cases:
        rows, worst = [], 0.0
        for name, bp, x in cases[kname] + extras[kname]:
            kernel, plain = calls(kname, bp, x, dev)
            y = kernel()
            res = compare(kname, y, plain(), bp)
            # no atomics: a second run is bit for bit the first
            res["rerun_bit_identical"] = bool(torch.equal(kernel(), y))
            res["ok"] = res["ok"] and res["rerun_bit_identical"]
            res.update(spmm_plan(kname, bp, x.shape[0]))
            rows.append({"case": name, "m": x.shape[0], "k": bp.k_in,
                         "n": bp.n_out, "k_max": bp.k_max, **res})
            if name != extra[0]:
                worst = max(worst, res["max_abs_diff"])
        max_err[kname] = worst
        emit("kernels", kernel=kname, cases=rows)
        bad = [r["case"] for r in rows if not r["ok"]]
        check(not bad, f"{kname} disagrees with its plain version on {bad}")

    # -- 5. serve ----------------------------------------------------------
    n32 = sum(BURSTS)
    images = np.random.default_rng(seed + 3).normal(
        size=(n32, cfg.conv_channels[0][0], cfg.input_hw, cfg.input_hw)
    ).astype(np.float32)
    svc32 = InferenceService(loaded, batch_slots=BATCH_SLOTS, device=dev,
                             collect_stats=True)
    svc8 = InferenceService(prog8, batch_slots=BATCH_SLOTS, device=dev)
    svc32.warmup()
    svc8.warmup()
    # the main path: counts from 0, traffic through both services, read
    tk.pattern_spmm_cuda.launches = 0
    tk.pattern_spmm_cuda.reduce_launches = 0
    tk.pattern_spmm_quant_cuda.launches = 0
    tk.pattern_spmm_quant_cuda.reduce_launches = 0
    reqs32 = [Request(image=img) for img in images]
    serve_s = serve_bursts(svc32, reqs32)
    reqs8 = [Request(image=img) for img in images[:N_INT8]]
    svc8.serve(reqs8)
    torch.cuda.synchronize()
    launches = {"pattern_spmm_cuda": tk.pattern_spmm_cuda.launches,
                "pattern_spmm_quant_cuda": tk.pattern_spmm_quant_cuda.launches}
    reduce_launches = {
        "pattern_spmm_cuda": tk.pattern_spmm_cuda.reduce_launches,
        "pattern_spmm_quant_cuda": tk.pattern_spmm_quant_cuda.reduce_launches}
    spmms = len(loaded.convs) + 1
    batches = {"fp32": svc32.batches_run, "int8": svc8.batches_run}
    m32 = svc32.metrics

    logits32 = np.stack([r.logits for r in reqs32])
    labels32 = np.array([r.label for r in reqs32])
    logits8 = np.stack([r.logits for r in reqs8])
    with torch.no_grad():
        dense = cnn_apply(cfg, tparams,
                          torch.as_tensor(images, device=dev)).cpu().numpy()
        exact = cnn_apply(
            cfg, {k: {n: t.double() for n, t in v.items()}
                  for k, v in tparams.items()},
            torch.as_tensor(images, dtype=torch.float64, device=dev),
        ).cpu().numpy()
    top2 = np.sort(dense, axis=1)[:, -2:]
    cpu_logits = make_forward(cpu_prog, device="cpu")(images).numpy()
    parity = layer_parity(loaded, cpu_prog, images[:BATCH_SLOTS], dev)
    _, one_shot = make_forward(loaded, collect_stats=True, device=dev)(images)
    stats_exact = all(
        np.array_equal(svc32.activation_stats.layers[k].counts, st.counts)
        and svc32.activation_stats.layers[k].windows == st.windows
        for k, st in one_shot.layers.items()
    )
    alone = Request(image=images[10])
    svc32.serve([alone])
    alone8 = Request(image=images[10])
    svc8.serve([alone8])
    res = dict(
        requests_fp32=n32, requests_int8=N_INT8, batch_slots=BATCH_SLOTS,
        bursts=list(BURSTS), batches=batches,
        all_done=all(r.done for r in reqs32 + reqs8),
        trace_count=[svc32.trace_count(), svc8.trace_count()],
        launches=launches, spmms_per_forward=spmms,
        reduce_launches=reduce_launches,
        reduce_launches_expected={
            "pattern_spmm_cuda": reduce_launches_expected(
                loaded, batches["fp32"]),
            "pattern_spmm_quant_cuda": reduce_launches_expected(
                prog8, batches["int8"], "pattern_spmm_quant_cuda")},
        requests_per_s=n32 / serve_s,
        latency_p50_s=m32["latency_p50_s"],
        latency_p99_s=m32["latency_p99_s"],
        occupancy_mean=m32["occupancy_mean"],
        logits_finite=bool(np.isfinite(logits32).all()
                           and np.isfinite(logits8).all()),
        max_abs_logit=float(np.abs(logits32).max()),
        labels_match_dense=bool((labels32 == dense.argmax(1)).all()),
        max_logit_diff_vs_dense=float(np.abs(logits32 - dense).max()),
        min_dense_top2_margin=float((top2[:, 1] - top2[:, 0]).min()),
        max_logit_diff_vs_cpu=float(np.abs(logits32 - cpu_logits).max()),
        e2e_limit=f"max|d| <= {E2E_TOL} * max(1, max|cpu logit|)",
        e2e_rel_vs_cpu=float(np.abs(logits32 - cpu_logits).max()
                             / max(1.0, float(np.abs(cpu_logits).max()))),
        # fp32 noise of the network itself, against float64 dense
        max_logit_err_vs_float64={
            "served": float(np.abs(logits32 - exact).max()),
            "cpu_plain": float(np.abs(cpu_logits - exact).max()),
            "dense_fp32": float(np.abs(dense - exact).max())},
        layer_limit=f"max|d| <= {LAYER_TOL} * max(1, max|cpu layer|)",
        layer_parity_vs_cpu=parity,
        alone_vs_cobatched_bit_identical=bool(
            np.array_equal(alone.logits, reqs32[10].logits)),
        int8_alone_vs_cobatched_bit_identical=bool(
            np.array_equal(alone8.logits, reqs8[10].logits)),
        stats_exact=stats_exact,
        int8_top1_agreement_vs_fp32=float(
            (logits8.argmax(1) == labels32[:N_INT8]).mean()),
    )
    emit("serve", **res)
    check(res["all_done"], "a request was not served")
    check(res["trace_count"] == [1, 1], f"trace_count {res['trace_count']}")
    check(logits32.shape == (n32, cfg.num_classes) and res["logits_finite"],
          "logits not finite or misshaped")
    for kname, prec in (("pattern_spmm_cuda", "fp32"),
                        ("pattern_spmm_quant_cuda", "int8")):
        check(launches[kname] == spmms * batches[prec],
              f"{kname} launches {launches[kname]} != {spmms} x "
              f"{batches[prec]} {prec} batches")
    check(reduce_launches == res["reduce_launches_expected"],
          f"split reductions {reduce_launches} != "
          f"{res['reduce_launches_expected']}")
    check(res["labels_match_dense"], "served labels differ from the dense "
                                     "reference's")
    bad = [r["layer"] for r in parity if r["rel"] > LAYER_TOL]
    check(not bad, f"layers {bad} differ from the CPU plain path")
    check(res["e2e_rel_vs_cpu"] <= E2E_TOL,
          f"served logits differ from the CPU plain path by "
          f"{res['e2e_rel_vs_cpu']} (relative) > {E2E_TOL}")
    check(stats_exact, "accumulated skip statistics != one-shot forward")
    check(res["alone_vs_cobatched_bit_identical"],
          "logits served alone differ from co-batched")
    check(res["int8_alone_vs_cobatched_bit_identical"],
          "int8 logits served alone differ from co-batched")

    # -- 6. the mapping search, served and priced -----------------------
    searched = search_phase(seed, cfg, params, tparams, bits, images,
                            labels32, loaded, dev)
    max_err["pattern_spmm_cuda"] = max(max_err["pattern_spmm_cuda"],
                                       searched["max_abs_err"])

    # -- 7. the paper's flow: train, pattern-prune, certify, serve -------
    pruned = prune_phase(seed, dev)
    for kname, n in pruned["launches"].items():
        launches[kname] += n
        max_err[kname] = max(max_err[kname], pruned["max_abs_err"][kname])

    # -- 8. ou_mvm on every conv's weight at real inputs ----------------
    ou = ou_mvm_phase(loaded, params, images, dev)
    launches["ou_mvm_cuda"] = ou["launches"]
    max_err["ou_mvm_cuda"] = ou["max_abs_err"]

    # -- 9. flash attention against its plain version, on the card ------
    fl = flash_phase(dev, GEN_SCFG["max_seq"])
    max_err["flash_attention_cuda"] = fl["max_abs_err"]

    # -- 10. token generation, every prefill through the flash kernel ---
    launches["flash_attention_cuda"] = generate_phase(seed, dev)["launches"]

    # -- 11. times at the main paths' shapes -----------------------------
    summary = []
    per_layer = {}
    for kname in ("pattern_spmm_cuda", "pattern_spmm_quant_cuda"):
        meta = KERNELS[kname]
        peak = (PEAK_FP32_FLOPS if kname == "pattern_spmm_cuda"
                else PEAK_INT8_OPS)
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bytes": 0.0, "ops": 0.0}
        rows = []
        for name, bp, x in cases[kname]:
            kernel, plain_call = calls(kname, bp, x, dev)
            ms = device_ms(kernel, dev)
            plain = device_ms(plain_call, dev)
            lib_ms = None
            if kname == "pattern_spmm_cuda":
                wd = bp.dense()[:, torch.as_tensor(bp.new_order, device=dev)
                                .long()].contiguous()
                lib_ms = device_ms(lambda: x @ wd, dev)
                tot["library_ms"] += lib_ms
            nbytes, ops = cost(kname, bp, x.shape[0])
            tot["ms"] += ms
            tot["plain_ms"] += plain
            tot["bytes"] += nbytes
            tot["ops"] += ops
            row = {"layer": name, "m": x.shape[0], "k": bp.k_in,
                   "n": bp.n_out, "bricks": int(bp.nnz.sum()),
                   "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                   "bytes": nbytes, "ops": ops}
            row.update(spmm_plan(kname, bp, x.shape[0]),
                       bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                    ops / peak) * 1e3)
            if kname == "pattern_spmm_cuda":
                row["tflops"] = ops / (ms * 1e-3) / 1e12
            else:
                row["tops"] = ops / (ms * 1e-3) / 1e12
                row["gb_per_s"] = nbytes / (ms * 1e-3) / 1e9
            rows.append(row)
        bytes_ms = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = tot["ops"] / peak * 1e3
        per_layer[kname] = rows
        summary.append({
            "name": kname, **meta,
            "launches": launches[kname],
            "max_abs_err": max_err[kname],
            "ms": tot["ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": (tot["library_ms"] if kname == "pattern_spmm_cuda"
                           else None),
        })
    ou_rows_t, ou_tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                             "bytes": 0.0, "ops": 0.0}
    for name, x, w, r, c in ou["cases"]:
        ms = device_ms(lambda: tou.ou_mvm_cuda(x, w, r, c), dev)
        plain = device_ms(lambda: tou.ou_mvm_plain(x, w, r, c), dev)
        lib_ms = device_ms(lambda: x @ w, dev)
        nbytes, ops = ou_cost(x, w, r)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                       ("bytes", nbytes), ("ops", ops)):
            ou_tot[key] += v
        ou_rows_t.append({"case": name, "r": w.shape[0], "c": w.shape[1],
                          **ou_plan(x, w, r),
                          "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                          "bytes": nbytes, "ops": ops,
                          "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                          "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                          ops / PEAK_FP32_FLOPS) * 1e3})
    per_layer["ou_mvm_cuda"] = ou_rows_t
    bytes_ms = ou_tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = ou_tot["ops"] / PEAK_FP32_FLOPS * 1e3
    summary.append({
        "name": "ou_mvm_cuda", **KERNELS["ou_mvm_cuda"],
        "launches": launches["ou_mvm_cuda"],
        "max_abs_err": max_err["ou_mvm_cuda"],
        "ms": ou_tot["ms"], "plain_ms": ou_tot["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ou_tot["library_ms"],
    })
    fl_rows, fl_tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                           "bytes": 0.0, "ops": 0.0}
    hq, hkv, d = FLASH_HEADS
    for c in fl["cases"]:
        q, k, v, n = c["q"], c["k"], c["v"], c["kv_len"]
        kw = dict(causal=True, window=FLASH_WINDOW, kv_len=n)
        qpos = torch.arange(n, device=dev)[:, None]
        kpos = torch.arange(k.shape[2], device=dev)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - FLASH_WINDOW) & (kpos < n)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)

        ms = device_ms(lambda: tfa.flash_attention_cuda(q, k, v, **kw), dev)
        plain = device_ms(lambda: tfa.flash_attention_plain(q, k, v, **kw),
                          dev)
        lib_ms = device_ms(sdpa, dev)
        lib_diff = float((sdpa().float() - tfa.flash_attention_plain(
            q, k, v, **kw).float()).abs().max())
        nbytes, ops = flash_cost(1, hq, hkv, n, n, d, 2, True, FLASH_WINDOW)
        for key, val in (("ms", ms), ("plain_ms", plain),
                         ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", ops)):
            fl_tot[key] += val
        fl_rows.append({
            "case": c["case"], "route": flash_route(c["dtype"]),
            "q": list(q.shape), "k": list(k.shape),
            "kv_len": n, "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
            "library_max_abs_diff_vs_plain": lib_diff,
            "bytes": nbytes, "ops": ops, "visible_pairs_per_head": int(
                ops / (4 * d * hq)), "tflops": ops / (ms * 1e-3) / 1e12,
            "bound_ms_bf16": max(nbytes / HBM_BYTES_PER_S,
                                 ops / PEAK_BF16_FLOPS) * 1e3,
            "bound_ms_fp32_cuda_cores": max(nbytes / HBM_BYTES_PER_S,
                                            ops / PEAK_FP32_FLOPS) * 1e3})
    per_layer["flash_attention_cuda"] = fl_rows
    bytes_ms = fl_tot["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = fl_tot["ops"] / PEAK_BF16_FLOPS * 1e3
    summary.append({
        "name": "flash_attention_cuda", **KERNELS["flash_attention_cuda"],
        "launches": launches["flash_attention_cuda"],
        "max_abs_err": max_err["flash_attention_cuda"],
        "ms": fl_tot["ms"], "plain_ms": fl_tot["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": fl_tot["library_ms"],
    })
    # the searched program's bricks through the fp32 kernel, per forward
    searched_spmm = {"ms": 0.0, "bound_ms": 0.0}
    for name, bp, x in layer_cases(searched["program"],
                                   np.random.default_rng(seed + 5), dev):
        kernel, _ = calls("pattern_spmm_cuda", bp, x, dev)
        searched_spmm["ms"] += device_ms(kernel, dev)
        nbytes, ops = cost("pattern_spmm_cuda", bp, x.shape[0])
        searched_spmm["bound_ms"] += max(nbytes / HBM_BYTES_PER_S,
                                         ops / PEAK_FP32_FLOPS) * 1e3
    x8 = images[:BATCH_SLOTS]
    fwd32 = make_forward(loaded, device=dev)
    fwd8 = make_forward(prog8, device=dev)
    forward_ms = {"fp32": host_ms(lambda: fwd32(x8)),
                  "int8": host_ms(lambda: fwd8(x8))}
    # the same trace through a service that does not collect skip
    # statistics: what the per-batch statistics cost end to end
    bare = InferenceService(loaded, batch_slots=BATCH_SLOTS, device=dev)
    bare.warmup()
    bare_s = serve_bursts(bare, [Request(image=img) for img in images])
    service_without_stats = {
        "requests_per_s": n32 / bare_s,
        "latency_p50_s": bare.metrics["latency_p50_s"],
        "latency_p99_s": bare.metrics["latency_p99_s"]}
    emit("times", card=smi, unit=f"spmm: ms per forward of {BATCH_SLOTS} "
         f"images ({spmms} launches), summed over layers; ou_mvm: ms per "
         f"call, summed over the {len(ou['cases'])} conv cases, GB/s of its "
         f"bytes (HBM {HBM_BYTES_PER_S / 1e12} TB/s); flash: ms "
         f"per launch of the prefill's call at S in {list(FLASH_PATH_S)}, "
         f"summed; its bound at the bf16 tensor cores' rate",
         per_layer=per_layer, searched_fp32_spmm_per_forward=searched_spmm,
         forward_ms=forward_ms,
         service_without_stats=service_without_stats,
         spmm_share_of_forward={
             "fp32": summary[0]["ms"] / forward_ms["fp32"],
             "int8": summary[1]["ms"] / forward_ms["int8"]})
    return {"smi": smi, "kind": kind, "kernels": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    res = run(args.seed, torch.device("cuda", 0))
    print(res["smi"])
    print(json.dumps({"kernels": res["kernels"]}, default=_jsonable))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": res["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
