"""The port stands alone: no jax, no ``repro``, no silent CPU fallback."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro"}

# Runs in a fresh interpreter whose import system refuses jax and repro:
# imports every module of the port, then compiles, runs and serves the
# mini net on the CPU, and prints one JSON line.
_ISOLATED = """
import importlib, json, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())

import numpy as np
import torch
import repro_torch

modules = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in modules:
    importlib.import_module(name)

from repro_torch.engine import (
    CompileOptions, InferenceService, compile_network, make_forward)
from repro_torch.models.cnn import cnn_apply, init_cnn, mini_cnn_config

cfg = mini_cnn_config(4, 12, (8, 16, 16))
params = init_cnn(cfg, torch.Generator().manual_seed(0))
for name, layer in params.items():
    if name.startswith("conv"):
        w = layer["w"]
        cut = w.abs().flatten().kthvalue(int(0.7 * w.numel())).values
        layer["w"] = torch.where(w.abs() > cut, w, torch.zeros_like(w))
prog = compile_network(cfg, params, options=CompileOptions(block=16, tile=16),
                       device="cpu")
x = np.random.default_rng(0).normal(size=(5, 1, 12, 12)).astype(np.float32)
logits = make_forward(prog, device="cpu")(x)
err = float((logits - cnn_apply(cfg, params, torch.from_numpy(x))).abs().max())
svc = InferenceService(prog, batch_slots=4, device="cpu")
labels = svc.classify(x).tolist()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(json.dumps({{"modules": modules, "err": err, "labels": labels,
                   "argmax": logits.argmax(-1).tolist(), "leaked": leaked,
                   "traces": svc.trace_count()}}))
"""


def test_port_runs_with_jax_and_reference_refused():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"  # one worker per core runs the suite
    out = subprocess.run(
        [sys.executable, "-c",
         textwrap.dedent(_ISOLATED).format(forbidden=FORBIDDEN)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    expected = {
        "repro_torch." + os.path.relpath(path, PORT)[:-3].replace(os.sep, ".")
        for path in _port_files()
        if not path.endswith("__init__.py")
    }
    assert expected <= set(res["modules"])
    assert res["err"] < 1e-4
    assert res["labels"] == res["argmax"]
    assert res["traces"] == 1


def _port_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_port_imports_jax_or_reference():
    paths = [*_port_files(), os.path.join(ROOT, "chip_smoke.py")]
    assert len(paths) > 20
    offenders = {
        os.path.relpath(p, ROOT): sorted(set(_imported_roots(p)) & FORBIDDEN)
        for p in paths
    }
    assert {p: r for p, r in offenders.items() if r} == {}


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from repro_torch.engine import (
        InferenceService,
        compile_network,
        execute,
        load_program,
        make_forward,
        save_program,
    )
    from repro_torch.models.cnn import init_cnn, mini_cnn_config

    cfg = mini_cnn_config(4, 12, (8, 16, 16))
    params = init_cnn(cfg, torch.Generator().manual_seed(0))
    prog = compile_network(cfg, params, device="cpu")
    path = save_program(str(tmp_path / "prog"), prog)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((1, 1, 12, 12), np.float32)
    for call in (
        lambda: compile_network(cfg, params),
        lambda: load_program(path),
        lambda: make_forward(prog),
        lambda: execute(prog, x),
        lambda: InferenceService(prog),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
