"""The port's example twins, run as a user runs them (CPU).

  * ``examples/quickstart_torch.py``: its pricing lines (steps 1-3, the
    port's copy of the reference's host numpy) equal
    ``examples/quickstart.py``'s, and its ``pattern_spmm`` of step 4
    agrees with the reference's within the JAX suite's fp32 spmm
    tolerance (``tests/test_kernels.py``: 2e-5 + 2e-5 |y|);
  * ``examples/serve_http_torch.py --check`` passes for both backends on
    the CPU, and the generation trace passes the unchanged
    ``benchmarks/check_baseline.py --trace FILE --require-mid-decode``.
    Classification serves 24 requests.  Generation serves the 100 that
    ``ci.yml``'s ``serve-smoke`` job serves: at 24 requests the staggered
    budgets' tail holds the mean occupancy at 0.828 in both packages
    (the reference's ``--check`` fails there too), under the 0.90 floor;
  * ``examples/serve_decode_torch.py`` serves its requests.
"""

import importlib.util
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(ROOT, "examples")


def _run(args, cwd) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return out.stdout


def test_quickstart_prints_the_reference_pricing(capsys):
    want = runpy.run_path(os.path.join(EXAMPLES, "quickstart.py"))
    jlines = capsys.readouterr().out.splitlines()
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(EXAMPLES, "quickstart_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.main(["--device", "cpu"])
    tlines = capsys.readouterr().out.splitlines()
    assert tlines[:4] == jlines[:4]
    assert tlines[4].startswith(jlines[4] + " on cpu")
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(want["y"]),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend,requests", [("classify", 24),
                                              ("generate", 100)])
def test_serve_http_check_passes(backend, requests, tmp_path):
    trace = tmp_path / "trace.json"
    out = _run([os.path.join(EXAMPLES, "serve_http_torch.py"), "--backend",
                backend, "--check", "--device", "cpu", "--requests",
                str(requests), "--trace-out", str(trace)], tmp_path)
    assert "check ok" in out
    assert f"{requests}/{requests} requests ok over HTTP" in out
    if backend == "generate":
        assert "mid-decode admissions" in out
        _run([os.path.join(ROOT, "benchmarks", "check_baseline.py"),
              "--trace", str(trace), "--require-mid-decode"], tmp_path)


def test_serve_decode_serves_its_requests(tmp_path):
    out = _run([os.path.join(EXAMPLES, "serve_decode_torch.py"), "--device",
                "cpu", "--requests", "6", "--new-tokens", "6"], tmp_path)
    assert "6 requests x 6 tokens (4 slots): 36 tokens in" in out
