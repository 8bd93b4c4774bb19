"""Nothing the benchmark runs loads JAX or the JAX package, and the
yardstick takes nothing from the program."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from h100bench import run  # noqa: E402
from h100bench.registry import BENCH_DIR, ROOT  # noqa: E402

# modules that measure with, and must not lean on, the program
YARDSTICK = ["synth.py", "reference.py", "counts.py", "generator.py",
             "devtrace.py", "check.py", "registry.py"]


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return [p for p in BENCH_DIR.rglob("*.py")
            if "__pycache__" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & set(run.FORBIDDEN), path


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in _imports(BENCH_DIR / name)


def test_metric_readers_import_nothing_of_the_program():
    for path in (BENCH_DIR / "metrics").glob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_forbidden_names_compare_the_whole_top_level(monkeypatch):
    fake = {"repro_torch": object(), "repro_torch.engine": object(),
            "jaxtyping": object(), "repro.engine": object(),
            "jaxlib.xla": object(), "flax": object()}
    monkeypatch.setattr(sys, "modules", {**sys.modules, **fake})
    bad = run.forbidden_modules()
    assert "repro.engine" in bad and "jaxlib.xla" in bad and "flax" in bad
    assert not {"repro_torch", "repro_torch.engine", "jaxtyping"} & set(bad)


def test_a_run_on_the_cpu_loads_no_jax():
    """Import the run path and drive a tiny cell in a fresh process; then
    nothing whose top-level name is forbidden is loaded."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from h100bench.registry import Cell\n"
        "from h100bench.cell import run_cell\n"
        "from h100bench.run import forbidden_modules\n"
        "from h100bench.tests.tiny import TINY, BACKLOG\n"
        "cell = Cell({'name': 't', 'chips': 1}, TINY, BACKLOG, [], [])\n"
        "assert run_cell(cell, 1, 0.2, True, device='cpu')['correct']\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "vgg16_cifar10.bulk", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=env)


def test_run_without_a_card_prints_no_result():
    """Run from the checkout with no CUDA device visible: a nonzero exit
    and nothing on standard output."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(ROOT, env)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.gpu
def test_run_without_the_program_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    (no program): a nonzero exit and nothing on standard output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: without one every run refuses")
    shutil.copytree(BENCH_DIR, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
