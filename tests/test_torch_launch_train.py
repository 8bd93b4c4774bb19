"""The port's training launcher and example, run as a user runs them (CPU).

  * ``python -m repro_torch.launch.train --arch granite_3_2b --smoke
    --steps 4 --device cpu``: the loss falls, and a second run with more
    steps resumes from the first run's last checkpoint;
  * the same launch on a 2-rank ``gloo`` group (``torch.distributed.run
    --standalone --nproc-per-node 2``), each rank fed its rows of the
    batch: every step's loss within 1e-4 relative of the one-rank run's;
  * ``examples/train_lm_torch.py`` trains a few steps.
"""

import json
import os
import subprocess
import sys

import pytest
torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARGS = ["--arch", "granite_3_2b", "--smoke",
        "--device", "cpu", "--ckpt-every", "2"]
REL = 1e-4


def _run(cmd, cwd) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _launch(tmp_path, name, steps, ranks=1) -> dict:
    """Run the launcher into ``tmp_path/name``'s checkpoints; returns its
    metrics file."""
    metrics = tmp_path / f"{name}-{steps}.json"
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={ranks}"] if ranks > 1 else [sys.executable])
    _run(head + ["-m", "repro_torch.launch.train", *ARGS, "--steps",
                 str(steps), "--ckpt-dir", str(tmp_path / name),
                 "--metrics-out", str(metrics)], tmp_path)
    with open(metrics) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    return tmp, _launch(tmp, "one", 4)


def test_launcher_trains_then_resumes(one_rank):
    tmp, first = one_rank
    losses = [h["loss"] for h in first["history"]]
    assert first["resumed"] == 0 and len(losses) == 4
    assert losses[-1] < losses[0]
    second = _launch(tmp, "one", 6)
    assert second["resumed"] == 4
    assert [h["step"] for h in second["history"]] == [4, 5]


def test_two_ranks_match_one(one_rank, tmp_path):
    _, first = one_rank
    two = _launch(tmp_path, "two", 4, ranks=2)
    assert two["resumed"] == 0
    for a, b in zip(two["history"], first["history"], strict=True):
        assert abs(a["loss"] - b["loss"]) <= REL * abs(b["loss"])


def test_example_trains(tmp_path):
    out = _run([sys.executable, os.path.join(ROOT, "examples",
                                             "train_lm_torch.py"),
                "--steps", "3", "--batch", "2", "--seq", "32", "--device",
                "cpu", "--ckpt-dir", str(tmp_path / "ckpt")], tmp_path)
    assert "lm10m: 4.2M params" in out and "final loss" in out
