"""The port's serving launcher against the reference's (CPU).

``repro_torch.launch.serve.main`` fed the reference's own
``init_params(cfg, PRNGKey(0))`` (through
``models.convert.lm_params_from_numpy``) returns, for the same flags,
exactly the tokens ``repro.launch.serve.main`` returns, request by
request, on granite's and h2o-danube's smoke configs in float32; its
three report lines have the reference's shape.  Run as a user runs it
(``python -m repro_torch.launch.serve ... --device cpu``), it draws its
own params, serves every request to its budget and writes the report
``--metrics-out`` asks for.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.models.transformer import init_params as j_init

from repro_torch.launch import serve as tserve
from repro_torch.models.convert import lm_params_from_numpy

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FLAGS = ["--smoke", "--requests", "6", "--slots", "4", "--prompt-len", "12",
         "--new-tokens", "8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["granite_3_2b", "h2o_danube_1_8b"])
def test_launcher_returns_the_reference_launchers_tokens(arch, capsys):
    argv = ["--arch", arch, *FLAGS]
    want = jserve.main(argv)
    jout = capsys.readouterr().out.splitlines()
    jparams, _, _ = j_init(j_smoke(arch), jax.random.PRNGKey(0))
    got = tserve.main(argv + ["--device", "cpu"], params=lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"))
    tout = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert np.array_equal(g.prompt, w.prompt)
        assert [int(t) for t in g.output] == [int(t) for t in w.output]
        assert g.done and len(g.output) == 8
    # the report: the same lines, the wall-clock numbers aside
    assert len(tout) == len(jout) == 5
    assert tout[0].split(" in ")[0] == jout[0].split(" in ")[0]
    assert tout[1].split(", mean")[0] == jout[1].split(", mean")[0]
    assert tout[2:] == jout[2:]


def test_launcher_runs_as_a_module(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    report = tmp_path / "serve.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite_3_2b", *FLAGS, "--device", "cpu", "--metrics-out",
         str(report)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[0].startswith("6 requests, 48 tokens in ")
    with open(report) as f:
        rep = json.load(f)
    assert rep["requests"] == 6 and rep["tokens"] == 48
    assert [len(o) for o in rep["outputs"]] == [8] * 6
    assert rep["device"] == "cpu" and rep["tokens_per_s"] > 0
    assert 0 < rep["scheduler"]["occupancy_mean"] <= 1
    # on the CPU every wrapper takes its plain version: no launch
    assert rep["kernel_launches"] == dict.fromkeys(
        ("pattern_spmm_cuda", "pattern_spmm_quant_cuda", "ou_mvm_cuda",
         "flash_attention_cuda"), 0)
