#!/usr/bin/env python3
"""The generate phase of ``chip_smoke.py`` with or without
``CUBLAS_WORKSPACE_CONFIG`` set in its process.

    python3 scripts/cublas_workspace_ab.py with|without

Builds the kernels, runs ``chip_smoke.generate_phase`` (full-width,
full-depth h2o-danube-1.8B served through ``DecodeService``) and prints
one JSON line of its throughput and one of the seconds it took.  ``with``
keeps the workspace setting ``chip_smoke.DRILL_CUBLAS_WORKSPACE`` in the
environment before torch starts cuBLAS; ``without`` leaves the variable
unset.  Run the arms in turns in one call, on one card:

    for a in with without without with; do
        python3 scripts/cublas_workspace_ab.py $a
    done

Needs a CUDA device and ``nvcc``.
"""

import importlib.util
import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def main(arm: str) -> int:
    if arm not in ("with", "without"):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if arm == "with":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = cs.DRILL_CUBLAS_WORKSPACE
    else:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    import torch

    if not torch.cuda.is_available():
        print("cublas_workspace_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    _build.build()
    _build.load_library()
    keys = ("tokens_per_s", "decode_tokens_per_s", "run_seconds",
            "ttft_p50_s")
    cs.emit = lambda phase, **f: print(json.dumps({
        "arm": arm, "phase": phase, **{k: f[k] for k in keys if k in f}}),
        flush=True)
    t0 = time.perf_counter()
    cs.generate_phase(0, torch.device("cuda", 0))
    print(json.dumps({"arm": arm, "card": cs.nvidia_smi(),
                      "env": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ""))
