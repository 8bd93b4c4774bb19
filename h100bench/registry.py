"""Find a cell's parts by name: its ``BENCHMARK.json`` entries, its
configuration file, its traffic file and its per-layer metric readers.

Adding a configuration, a traffic mix or a metric takes a new file here
and a new ``BENCHMARK.json`` entry; nothing in this module names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell", "metric_reader"]


class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads``, with its parts."""

    def __init__(self, spec: dict, config: dict, traffic: dict,
                 end_to_end: list[dict], per_layer: list[dict],
                 bench_dir: Path = BENCH_DIR):
        self.name = spec["name"]
        self.bench_dir = bench_dir
        self.spec = spec
        self.config = config
        self.traffic = traffic
        self.end_to_end = end_to_end
        self.per_layer = per_layer

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])


def _reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: every cell when the
    metric lists none."""
    return "workloads" not in metric or cell in metric["workloads"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark: Path | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``benchmark`` (default: ``BENCHMARK.json`` at
    the repository root) with its configuration and traffic files read
    from ``bench_dir``.  Raises ``KeyError`` for an unknown cell and
    ``FileNotFoundError`` for a missing file."""
    bench = read_json(benchmark or bench_dir.parent / "BENCHMARK.json")
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {sorted(specs)})")
    spec = specs[name]
    config = read_json(bench_dir / "configs" / f"{spec['config']}.json")
    traffic = read_json(bench_dir / "traffic" / f"{spec['traffic']}.json")
    return Cell(
        spec, config, traffic,
        [m for m in bench["end_to_end"] if _reports(m, name)],
        [m for m in bench["per_layer"] if _reports(m, name)],
        bench_dir,
    )


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module of ``metrics/<name>.py`` (names may hold dots, so it is
    loaded from its path, not imported by name)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    mod_name = "h100bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
