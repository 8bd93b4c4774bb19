"""The port stands alone: no jax, no ``repro``, no silent CPU fallback."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro"}

# Runs in a fresh interpreter whose import system refuses jax and repro:
# imports every module of the port, then compiles, runs and serves the
# mini net on the CPU, prunes it and compiles it with verification and
# range certification, saves and reloads it (verifying), and prints one
# JSON line.
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
from repro_torch.core.pruning import magnitude_prune
from repro_torch.engine import load_program, save_program
pruned = magnitude_prune(params, ["conv1", "conv2", "conv3"], 0.7)
strict = compile_network(cfg, pruned, options=CompileOptions(
    block=16, tile=16, precision="int8", verify="strict"), device="cpu")
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    back = load_program(save_program(tmp + "/p", strict), device="cpu")
certified = (back.certificate is not None
             and back.certificate.to_manifest()
             == strict.certificate.to_manifest())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(json.dumps({{"modules": modules, "err": err, "labels": labels,
                   "argmax": logits.argmax(-1).tolist(), "leaked": leaked,
                   "traces": svc.trace_count(), "certified": certified}}))
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
    assert res["certified"]


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


def _example_twins():
    ex = os.path.join(ROOT, "examples")
    return sorted(os.path.join(ex, f) for f in os.listdir(ex)
                  if f.endswith("_torch.py"))


def test_no_module_of_the_port_imports_jax_or_reference():
    paths = [*_port_files(), os.path.join(ROOT, "chip_smoke.py"),
             *_example_twins()]
    assert len(_example_twins()) >= 5
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


def test_collection_without_torch_keeps_the_jax_suite(tmp_path):
    """With torch absent, as the reference's CI installs it, every
    ``tests/test_torch_*.py`` skips at collection and the JAX tests beside
    them are still collected (no collection error interrupts the run)."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch'] = None\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path),
                                         os.path.join(ROOT, "src")])
    env["JAX_PLATFORMS"] = "cpu"
    tests = sorted(
        os.path.join("tests", f) for f in os.listdir(os.path.join(ROOT, "tests"))
        if f.startswith("test_torch_") and f.endswith(".py"))
    assert len(tests) >= 10
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-rs",
         "-p", "no:cacheprovider", *tests, "tests/test_engine.py"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    ids = [ln for ln in out.stdout.splitlines() if "::" in ln]
    assert any(ln.startswith("tests/test_engine.py::") for ln in ids)
    assert not [ln for ln in ids if "test_torch_" in ln]
    skipped = [ln for ln in out.stdout.splitlines()
               if ln.startswith("SKIPPED") and "could not import 'torch'" in ln]
    assert len(skipped) == len(tests)


# Runs one of the port's entry points (``run_module`` or ``run_path``) in
# a fresh interpreter whose import system refuses jax and repro, with
# ``argv``; prints the modules of jax and repro it loaded.
_ENTRY = """
import json, runpy, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = {argv!r}
runpy.{how}({target!r}, run_name="__main__")
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in {forbidden!r})))
"""


@pytest.mark.parametrize("how,target,argv", [
    ("run_module", "repro_torch.launch.serve",
     ["--arch", "granite_3_2b", "--smoke", "--requests", "3",
      "--new-tokens", "3"]),
    ("run_path", "serve_decode_torch.py", ["--requests", "3",
                                           "--new-tokens", "3"]),
    ("run_path", "quickstart_torch.py", []),
    ("run_path", "serve_http_torch.py", ["--requests", "8"]),
])
def test_entry_points_run_with_jax_and_reference_refused(how, target, argv):
    """The launcher and the example twins import neither jax nor the JAX
    package, and run on the CPU when asked."""
    if how == "run_path":
        target = os.path.join(ROOT, "examples", target)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    code = textwrap.dedent(_ENTRY).format(
        forbidden=FORBIDDEN, argv=[target, *argv, "--device", "cpu"],
        how=how, target=target)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_launcher_and_examples_need_cuda_unless_asked(monkeypatch):
    """Without ``--device cpu`` the launcher and the example twins raise
    without a card; they never drop to the CPU on their own."""
    import importlib.util

    from repro_torch.launch import serve as tserve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "granite_3_2b", "--smoke"])
    for name in ("quickstart_torch", "serve_decode_torch",
                 "serve_http_torch"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        monkeypatch.setattr(sys, "argv", [name])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main()
