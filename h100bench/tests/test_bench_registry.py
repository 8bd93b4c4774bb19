"""The harness finds every part of a cell by name, and a new
configuration, mix or metric takes only new files and new entries."""

import hashlib
import json
import re
import shutil

import pytest

torch = pytest.importorskip("torch")

from h100bench.cell import run_cell  # noqa: E402
from h100bench.registry import (BENCH_DIR, ROOT, load_cell,  # noqa: E402
                                metric_reader, read_json)
from h100bench.tests.tiny import OPEN, TINY  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_benchmark_json_keeps_to_its_shape():
    bench = read_json(ROOT / "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100bench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"] == f"h100bench/configs/{c['name']}.json"
        assert read_json(ROOT / c["file"])["name"] == c["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = load_cell(w["name"])
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric, each of which moves one it reports
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert all(m["moves"] in names for m in cell.per_layer)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    for m in read_json(ROOT / "BENCHMARK.json")[kind]:
        assert callable(metric_reader(m["name"]).read)


def test_unknown_cell_and_metric_raise():
    with pytest.raises(KeyError):
        load_cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        metric_reader("no_such_metric")


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """Add a configuration, a mix and a per-layer metric to a copy of the
    benchmark: new files and new entries, no existing file edited, and
    the new cell runs (on the CPU) with the new metric in its line."""
    bench_dir = tmp_path / "h100bench"
    shutil.copytree(BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _hashes(bench_dir)

    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (bench_dir / "traffic" / "tiny-open.json").write_text(json.dumps(OPEN))
    (bench_dir / "metrics" / "steps_seen.tiny.py").write_text(
        "def read(run):\n    return run.window.steps\n")
    bench = read_json(tmp_path / "BENCHMARK.json")
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "h100bench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.open", "config": "tiny",
                               "traffic": "tiny-open", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "first_result_p95_ms":
            m["workloads"].append("tiny.open")
    bench["per_layer"].append({"name": "steps_seen.tiny", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "setup_s",
                               "workloads": ["tiny.open"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("tiny.open", benchmark=tmp_path / "BENCHMARK.json",
                     bench_dir=bench_dir)
    assert cell.config == TINY and cell.traffic == OPEN
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.tiny"]
    res = run_cell(cell, seed=2**31 + 7, seconds=0.3, trace=True,
                   device="cpu")
    assert res["correct"] and res["metrics"]["steps_seen.tiny"]["value"] > 0
    res = run_cell(cell, seed=2**31 + 7, seconds=0.3, trace=False,
                   device="cpu")
    assert set(res["metrics"]) == {"first_result_p95_ms", "setup_s"}

    after = _hashes(bench_dir)
    assert {k: after[k] for k in before} == before
