#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main paths at full width, through the entry points a
user calls: compile the synthetic pattern-pruned VGG16 (CIFAR-10, 13
convs, Table-II statistics) in fp32 and int8, save and reload the fp32
program, and serve seeded requests through ``InferenceService`` on
``cuda``; compile it again with the per-layer crossbar mapping search
(``optimize="auto"``), serve it with skip statistics and price the served
traffic with ``hardware_report``; run ``ops.ou_mvm`` on every conv's
dense weight at real inputs.  Before that it builds the CUDA kernels
from the sources in ``src/`` and holds each against its plain PyTorch
version on the card, at every shape the main paths give it.

Phases, one JSON line each: ``device``, ``build``, ``compile``,
``kernels`` (kernel vs plain), ``serve``, ``search``, ``ou_mvm``,
``times``.  Any failed check exits non-zero.  The last three lines are
the card's name and power limit as ``nvidia-smi`` prints them, the
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
}


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
    row), so a timed call is the launch alone."""
    import torch

    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels import pattern_spmm as tk

    nnz = torch.as_tensor(bp.nnz, dtype=torch.int32, device=dev)
    if kind == "pattern_spmm_cuda":
        args = (x, bp.w_comp, bp.block_ids, nnz, bp.block)
        kernel, plain = tk.pattern_spmm_cuda, tk.pattern_spmm_plain
    else:
        xq, _ = quantize_rows(x)
        args = (xq, bp.w_comp, bp.block_ids, bp.w_scales, nnz, bp.block)
        kernel = tk.pattern_spmm_quant_cuda
        plain = tk.pattern_spmm_quant_plain
    return lambda: kernel(*args), lambda: plain(*args)


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
    reqs = [Request(image=img) for img in images]
    serve_s = serve_bursts(svc, reqs)
    launches = tk.pattern_spmm_cuda.launches
    spmms = len(loaded.convs) + 1
    check(all(r.done for r in reqs), "a request was not served")
    check(launches == spmms * svc.batches_run,
          f"pattern_spmm_cuda launches {launches} != {spmms} x "
          f"{svc.batches_run} batches of the searched program")
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
    check(launches == len(cases),
          f"ou_mvm_cuda launches {launches} != {len(cases)} calls")
    rows, worst = [], 0.0
    for (name, x, w, r, c), y in zip(cases, outs):
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
               "finite": bool(torch.isfinite(y).all())}
        row["ok"] = row["worst_over_limit"] <= 1.0 and row["finite"]
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


def ou_cost(x, w, ou_rows: int) -> tuple[float, float]:
    """(bytes, operations) of one ``ou_mvm`` call: x read and y written
    once, and the weight rows of the live bands read once; two
    operations per weight read."""
    live = int(ou_live_rows(x, ou_rows).sum())
    c = w.shape[1]
    return 4.0 * (x.shape[0] + c + live * c), 2.0 * live * c


def serve_bursts(svc, reqs) -> float:
    """Submit ``reqs`` in ``BURSTS``, one service step after each burst,
    then drain; returns the host seconds it took."""
    import torch

    it = iter(reqs)
    t0 = time.perf_counter()
    for burst in BURSTS:
        for _ in range(burst):
            svc.submit(next(it))
        svc.step()
    svc.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


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
            res = compare(kname, kernel(), plain(), bp)
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
    tk.pattern_spmm_quant_cuda.launches = 0
    reqs32 = [Request(image=img) for img in images]
    serve_s = serve_bursts(svc32, reqs32)
    reqs8 = [Request(image=img) for img in images[:N_INT8]]
    svc8.serve(reqs8)
    torch.cuda.synchronize()
    launches = {"pattern_spmm_cuda": tk.pattern_spmm_cuda.launches,
                "pattern_spmm_quant_cuda": tk.pattern_spmm_quant_cuda.launches}
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
    res = dict(
        requests_fp32=n32, requests_int8=N_INT8, batch_slots=BATCH_SLOTS,
        bursts=list(BURSTS), batches=batches,
        all_done=all(r.done for r in reqs32 + reqs8),
        trace_count=[svc32.trace_count(), svc8.trace_count()],
        launches=launches, spmms_per_forward=spmms,
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

    # -- 6. the mapping search, served and priced -----------------------
    searched = search_phase(seed, cfg, params, tparams, bits, images,
                            labels32, loaded, dev)
    max_err["pattern_spmm_cuda"] = max(max_err["pattern_spmm_cuda"],
                                       searched["max_abs_err"])

    # -- 7. ou_mvm on every conv's weight at real inputs ----------------
    ou = ou_mvm_phase(loaded, params, images, dev)
    launches["ou_mvm_cuda"] = ou["launches"]
    max_err["ou_mvm_cuda"] = ou["max_abs_err"]

    # -- 8. times at the main paths' shapes ------------------------------
    summary = []
    per_layer = {}
    for kname in ("pattern_spmm_cuda", "pattern_spmm_quant_cuda"):
        meta = KERNELS[kname]
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
            rows.append({"layer": name, "m": x.shape[0], "k": bp.k_in,
                         "n": bp.n_out, "bricks": int(bp.nnz.sum()),
                         "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                         "bytes": nbytes, "ops": ops})
        peak = (PEAK_FP32_FLOPS if kname == "pattern_spmm_cuda"
                else PEAK_INT8_OPS)
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
                          "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                          "bytes": nbytes, "ops": ops,
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
         f"call, summed over the {len(ou['cases'])} conv cases",
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
