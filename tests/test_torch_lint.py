"""The port's AST lint: each kept rule (L002, L003, L004 with torch
synchronisation, L006) fires on a planted violation and stays silent on
its fixed twin, ``# lint: allow(...)`` suppresses one rule, the
scoped-out rules (L001, L005) find nothing, and ``src/repro_torch`` is
clean (the CI contract)."""

import os
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.analysis.lint import lint_paths  # noqa: E402

PORT_SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")


def _lint(tmp_path, source, name="mod.py"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(source))
    return lint_paths([str(path)])


# (rule, planted violation, fixed twin)
CASES = [
    ("L002", """
        def compile_thing(x, tracer):
            return x
    """, """
        from repro_torch.obs.trace import NULL_TRACER

        def a(x, tracer=None):
            return x

        def b(x, tracer=NULL_TRACER):
            return x

        def _private(x, tracer):
            return x
    """),
    ("L003", """
        import dataclasses

        @dataclasses.dataclass
        class Mutable:
            n: int = 0

        def f(x, acc=[], table=dict(), cfg=Mutable()):
            return acc
    """, """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class Frozen:
            n: int = 0

        def f(x, pair=(1, 2), name="a", bits=frozenset({1}), cfg=Frozen()):
            return x
    """),
    ("L004", """
        import time
        import torch

        def bench(x, w):
            t0 = time.perf_counter()
            y = torch.matmul(x, w)
            return time.perf_counter() - t0
    """, """
        import time
        import torch

        def bench(x, w):
            t0 = time.perf_counter()
            y = torch.matmul(x, w)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
    """),
    ("L004", """
        import time
        import torch.nn.functional as F

        def bench(x, w):
            t0 = time.time()
            y = F.linear(x, w)
            return time.time() - t0
    """, """
        import time
        import torch.nn.functional as F

        def bench(x, w):
            t0 = time.time()
            y = F.linear(x, w).sum().item()  # reads the result back
            return time.time() - t0
    """),
    ("L004", """
        import time
        from repro_torch.kernels import ops

        def bench(x, bp):
            t0 = time.perf_counter()
            y = ops.pattern_spmm(x, bp)
            return time.perf_counter() - t0
    """, """
        import time
        import torch
        from repro_torch.kernels import ops

        def bench(x, bp):
            t0 = time.perf_counter()
            y = ops.pattern_spmm(x, bp)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return time.perf_counter() - t0
    """),
    ("L006", """
        import threading

        class Registry:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = {}

            def add(self, k, v):
                self._items[k] = v
    """, """
        import threading

        class Registry:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = {}

            def add(self, k, v):
                with self._lock:
                    self._items[k] = v
    """),
]


@pytest.mark.parametrize("rule,bad,good", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_rule_fires_and_fixed_twin_is_clean(tmp_path, rule, bad, good):
    report = _lint(tmp_path, bad)
    assert report.rules() == {rule}, report.format()
    assert all(d.severity == "error" for d in report)
    fixed = _lint(tmp_path, good, name="fixed.py")
    assert fixed.clean, fixed.format()


def test_l004_torch_work_outside_timed_region_passes(tmp_path):
    report = _lint(tmp_path, """
        import time
        import torch

        def bench(x):
            y = torch.zeros(4)  # before the timed region
            t0 = time.time()
            host_work(y)
            return time.time() - t0
    """)
    assert report.clean, report.format()


def test_l004_elapsed_time_alone_does_not_synchronize(tmp_path):
    report = _lint(tmp_path, """
        import time
        import torch

        def bench(x, start, end):
            t0 = time.perf_counter()
            torch.relu(x)
            ms = start.elapsed_time(end)
            return time.perf_counter() - t0, ms
    """)
    assert report.rules() == {"L004"}


def test_allow_comment_is_rule_specific(tmp_path):
    src = """
        import time
        import torch

        def bench(x):
            t0 = time.time()  # lint: allow({rule})
            torch.relu(x)
            return time.time() - t0
    """
    assert _lint(tmp_path, src.format(rule="L004")).clean
    assert _lint(tmp_path, src.format(rule="L002")).rules() == {"L004"}


def test_scoped_out_rules_find_nothing(tmp_path):
    """L001 (jit purity) and L005 (deprecated request shims) are out of
    the port's scope: the port never traces, and the shims were not
    copied."""
    report = _lint(tmp_path, """
        import time
        import jax
        from repro.engine.service import ClassifyRequest

        def forward(x):
            return x * time.time()

        fn = jax.jit(forward)
    """)
    assert report.clean, report.format()


def test_cli_lint(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x, acc=[]):\n    return acc\n")
    assert main(["lint", str(bad)]) == 1
    assert "L003" in capsys.readouterr().out
    good = tmp_path / "good.py"
    good.write_text("def f(x):\n    return x\n")
    assert main(["lint", str(good)]) == 0


def test_port_source_tree_is_clean():
    report = lint_paths([PORT_SRC])
    assert report.clean, report.format()
