"""``chip_smoke.py`` rehearsed on the CPU at mini-net size.

The smoke script runs only on a GPU.  Here its phases run end to end
with the CUDA calls faked (events on the host clock, no-op syncs, no
``nvcc``), the kernel wrappers replaced by counting plain versions, and
the full-width VGG16 swapped for the mini net, so a change to the
script's own logic (phases, checks, the JSON it prints) fails here
before it costs a run on the card.
"""

import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import ou_mvm as tou
from repro_torch.kernels import pattern_spmm as tk
from repro_torch.models.cnn import mini_cnn_config

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _HostEvent:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _counting(plain, name):
    def launch(*args, **kwargs):
        launch.launches += 1
        return plain(*args, **kwargs)

    launch.launches = 0
    launch.__name__ = name
    return launch


def _mini_model(seed):
    cfg = mini_cnn_config(4, 12, (8, 16, 16))
    rng = np.random.default_rng(seed)
    params = {}
    for i, (ci, co) in enumerate(cfg.conv_channels, start=1):
        w = rng.normal(size=(co, ci, 3, 3)) * np.sqrt(2 / (ci * 9))
        w[np.abs(w) < np.quantile(np.abs(w), 0.7)] = 0.0
        params[f"conv{i}"] = {"w": w.astype(np.float32),
                              "b": np.zeros(co, np.float32)}
    params["fc"] = {"w": (rng.normal(size=(16, 4)) / 4).astype(np.float32),
                    "b": np.zeros(4, np.float32)}
    return cfg, params, {}


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    for mod, name, plain in (
        (tk, "pattern_spmm_cuda", tk.pattern_spmm_plain),
        (tk, "pattern_spmm_quant_cuda", tk.pattern_spmm_quant_plain),
        (tou, "ou_mvm_cuda", tou.ou_mvm_plain),
    ):
        fake = _counting(plain, name)
        monkeypatch.setattr(mod, name, fake)
        monkeypatch.setattr(ops, name, fake)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    lib = tmp_path / "libpattern_spmm-fake.so"
    lib.write_text("")
    monkeypatch.setattr(_build, "build", lambda: lib)
    monkeypatch.setattr(_build, "load_library", lambda: None)
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "cpu rehearsal, 0 W")
    monkeypatch.setattr(cs, "build_model", _mini_model)
    monkeypatch.setattr(cs, "REPS", 2)
    # the fp32 and int8 switches must not leak out of the rehearsal
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)

    res = cs.run(0, torch.device("cpu"))

    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["phase"] for ln in lines] == [
        "device", "build", "compile", "kernels", "kernels", "serve", "search",
        "ou_mvm", "times"]
    serve = lines[5]
    assert serve["trace_count"] == [1, 1] and serve["all_done"]
    assert serve["stats_exact"] and serve["labels_match_dense"]
    assert serve["alone_vs_cobatched_bit_identical"]
    assert serve["e2e_rel_vs_cpu"] <= cs.E2E_TOL
    # 3 convs + FC per batch: 9 fp32 batches for 64 requests, 2 int8
    assert serve["launches"] == {"pattern_spmm_cuda": 36,
                                 "pattern_spmm_quant_cuda": 8}
    search = lines[6]
    assert search["bit_equal_vs_cpu_compile"] and search["never_worse"]
    assert set(search["chosen"]) == {"conv1", "conv2", "conv3"}
    assert search["launches"] == 4 * search["batches"]
    assert search["skip"]["measured_layers"] == ["conv1", "conv2", "conv3"]
    assert 0.0 <= search["skip"]["measured_discount"] <= 1.0
    assert {r["name"] for r in search["drift"]["layers"]} == {
        "conv1", "conv2", "conv3"}
    assert search["searched"]["area_cells"] <= search["fixed"]["area_cells"]
    assert search["searched"]["energy_pj"] <= search["fixed"]["energy_pj"]
    ou = lines[7]
    # 3 convs x 2 patches, the 3 sweep shapes, all-zero x, NaN case
    assert ou["calls"] == ou["launches"] == 11
    assert all(c["ok"] and c["finite"] for c in ou["cases"])
    assert ou["cases"][-2]["skipped_band_share"] == 1.0
    times = lines[8]
    assert len(times["per_layer"]["ou_mvm_cuda"]) == 6
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in res["kernels"]] == list(cs.KERNELS)
    for k in res["kernels"]:
        assert set(k) == keys
        assert k["launches"] > 0 and k["bound_ms"] > 0
        assert os.path.exists(os.path.join(ROOT, k["source"]))
        path, line = k["replaces"].rsplit(":", 1)
        with open(os.path.join(ROOT, path)) as f:
            text = f.readlines()[int(line) - 1]
        assert text.startswith("def ") and "_pallas" in text
    assert res["kernels"][1]["library_ms"] is None
    assert res["kernels"][2]["library_ms"] > 0
