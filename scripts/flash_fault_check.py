#!/usr/bin/env python3
"""Planted faults in the flash-attention kernel against ``chip_smoke.py``'s
flash checks, on one GPU.

    python3 scripts/flash_fault_check.py [--out FILE]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it stands
and once per fault in ``FAULTS`` (a one-line edit of a copy in a
temporary directory; the source in the repository is never changed), all
``nvcc`` runs started together.  Each build then runs every case of
``chip_smoke.flash_cases`` through ``flash_attention_cuda`` and is held to
``chip_smoke.flash_row``: ``_tolerance`` against the plain version, and
for 16-bit inputs the rounding limit against the plain version in fp32.
For each build it reports the cases each limit fails and the worst
ratios, and apart the cases at head width 256 (the sweep's paligemma
shape and paligemma's prefills, the kernels' 256-wide builds).  Exits 0
when the unedited build passes every case and every fault fails at
least one case at D 256 and the 16-bit rounding limit at that width; one
JSON object on stdout, also written to ``--out``.  Needs a CUDA device
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "flash_attention.cu")

# name -> (line as it stands, line with the fault); None: the source as is.
# Each fault edits the tensor-core kernel (flash_mma_kernel), the route of
# every 16-bit case and of the generation path's prefills.
FAULTS = {
    "unedited": None,
    # one key too many at the far edge of the sliding window (rows >= 4096)
    "window_off_by_one": (
        "if (p.window > 0) vis = vis && kpos > qpos - p.window;",
        "if (p.window > 0) vis = vis && kpos >= qpos - p.window;"),
    # the first key tile of the window dropped when the window starts
    # inside it: rows past the window lose up to 63 of their oldest keys
    "window_first_tile_dropped": (
        "const int tile_lo = key_begin / BKV;",
        "const int tile_lo = (key_begin + BKV - 1) / BKV;"),
    # a ragged last key tile dropped: the last rows lose their newest keys
    "ragged_last_tile_dropped": (
        "const int tile_hi = (key_end + BKV - 1) / BKV;",
        "const int tile_hi = key_end / BKV;"),
    # the key at kv_len read and scored (a padded key let in)
    "kv_len_off_by_one": (
        "const int key_lim = min(p.kv_len, p.Sk);",
        "const int key_lim = min(p.kv_len + 1, p.Sk);"),
}


def build_all(tmp: str) -> dict:
    """{fault: ctypes library}: every build compiled in parallel."""
    from repro_torch.kernels import _build

    text = open(SOURCE).read()
    nvcc = _build.find_nvcc()
    procs = {}
    for name, edit in FAULTS.items():
        src = text
        if edit is not None:
            before, after = edit
            if text.count(before) != 1:
                raise RuntimeError(f"{name}: {before!r} is not one line of "
                                   f"{SOURCE}")
            src = text.replace(before, after)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(tmp, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = _build.declare(
            ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "flash_faults.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_fault_check: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi(),
           "rounding_limit": {"half_ulp": cs.FLASH_HALF_ULP,
                              "sum_slack": cs.FLASH_SUM_SLACK},
           "builds": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        for name, lib in libs.items():
            with mock.patch.object(tfa, "load_library", lambda lib=lib: lib):
                rows, _ = cs.flash_rows(dev, cs.GEN_SCFG["max_seq"])
            tol_bad = [r["case"] for r in rows
                       if r["worst_over_limit"] > 1.0 or not r["finite"]]
            rnd_bad = [r["case"] for r in rows
                       if r.get("worst_over_rounding_limit", 0.0) > 1.0]
            wide = [r for r in rows if r["q"][-1] == 256]
            path = [r for r in rows if r["case"].startswith("path_")]
            res["builds"][name] = {
                "failed": bool(tol_bad or rnd_bad),
                "failed_tolerance": tol_bad,
                "failed_rounding_limit": rnd_bad,
                "worst_over_limit": max(r["worst_over_limit"] for r in rows),
                "worst_over_rounding_limit": max(
                    r.get("worst_over_rounding_limit", 0.0) for r in rows),
                "path_max_abs_diff": max(r["max_abs_diff"] for r in path),
                "d256_cases": len(wide),
                "d256_failed_tolerance": [
                    r["case"] for r in wide
                    if r["worst_over_limit"] > 1.0 or not r["finite"]],
                "d256_failed_rounding_limit": [
                    r["case"] for r in wide
                    if r.get("worst_over_rounding_limit", 0.0) > 1.0],
                "d256_worst_over_rounding_limit": max(
                    r.get("worst_over_rounding_limit", 0.0) for r in wide),
                "path": {r["case"]: {k: r.get(k) for k in (
                    "max_abs_diff", "worst_over_limit", "max_abs_diff_fp32",
                    "max_abs_plain", "fp32_excess_over_row_max",
                    "worst_over_rounding_limit")}
                    for r in path},
            }
            torch.cuda.empty_cache()
    builds = res["builds"]
    res["ok"] = (not builds["unedited"]["failed"] and all(
        b["failed"] and b["d256_failed_rounding_limit"]
        for n, b in builds.items() if n != "unedited"))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
