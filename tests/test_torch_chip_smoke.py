"""``chip_smoke.py`` rehearsed on the CPU at mini-net size.

The smoke script runs only on a GPU.  Here its phases run end to end
with the CUDA calls faked (events on the host clock, no-op syncs, no
``nvcc``), the kernel wrappers replaced by counting plain versions, and
the full-width VGG16 swapped for the mini net, so a change to the
script's own logic (phases, checks, the JSON it prints) fails here
before it costs a run on the card.
"""

import dataclasses
import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import h2o_danube_1_8b
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ou_mvm as tou
from repro_torch.kernels import pattern_spmm as tk
from repro_torch.models.cnn import mini_cnn_config
from repro_torch.models.layers import PatternSparseConfig
from repro_torch.models.transformer import init_params

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


def _smoke_lm(seed, dev):
    """h2o-danube's smoke config (window 16) with pattern-sparse MLPs in
    bf16: the generate phase's model at CPU size."""
    cfg = dataclasses.replace(
        h2o_danube_1_8b.smoke_config(), d_ff=384, model_shards=4,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        sparse=PatternSparseConfig(density=0.5, num_patterns=3, block=32,
                                   tile=32))
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    return cfg, params, statics


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    for mod, name, plain in (
        (tk, "pattern_spmm_cuda", tk.pattern_spmm_plain),
        (tk, "pattern_spmm_quant_cuda", tk.pattern_spmm_quant_plain),
        (tou, "ou_mvm_cuda", tou.ou_mvm_plain),
        (tfa, "flash_attention_cuda", tfa.flash_attention_plain),
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
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    # the generate phase at smoke size: 6 prompts of 5-30 tokens and one
    # of 40 (longer than the window of 16) in 4 bursts, 4 new tokens each
    monkeypatch.setattr(cs, "build_lm", _smoke_lm)
    monkeypatch.setattr(cs, "GEN_SCFG", dict(batch_slots=3, max_seq=64,
                                             eos_id=-1))
    monkeypatch.setattr(cs, "GEN_REQUESTS", 6)
    monkeypatch.setattr(cs, "GEN_LENGTHS", (5, 30))
    monkeypatch.setattr(cs, "GEN_LONG", 40)
    monkeypatch.setattr(cs, "GEN_LONG_AT", 2)
    monkeypatch.setattr(cs, "GEN_NEW", 4)
    monkeypatch.setattr(cs, "GEN_BURSTS", (1, 3, 2, 1))
    monkeypatch.setattr(cs, "FLASH_HEADS", (4, 2, 80))
    monkeypatch.setattr(cs, "FLASH_PATH_S", (17, 40))
    monkeypatch.setattr(cs, "FLASH_WINDOW", 16)
    # the fp32 and int8 switches must not leak out of the rehearsal
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)

    res = cs.run(0, torch.device("cpu"))

    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["phase"] for ln in lines] == [
        "device", "build", "compile", "kernels", "kernels", "serve", "search",
        "ou_mvm", "flash", "generate", "times"]
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
    flash = lines[8]
    # 14 sweep cases x 3 types, each path length bare and from a cache,
    # and kv_len < S
    assert len(flash["cases"]) == 14 * 3 + 2 * 2 + 1
    assert flash["cases"][-1]["kv_len"] == 11
    assert all(c["ok"] and c["finite"] for c in flash["cases"])
    half = [c for c in flash["cases"] if "float32" not in c["case"]]
    assert half and all(c["worst_over_rounding_limit"] <= 1.0 for c in half)
    gen = lines[9]
    assert gen["all_done"] and gen["trace_count"] == 1
    assert gen["requests"] == gen["prefills"] == 7
    assert gen["launches"] == gen["launches_expected"] == 2 * 7
    assert gen["admitted_mid_decode"] > 0
    assert all(gen["alone_vs_cobatched_equal"].values())
    lens = [r["prompt_len"] for r in gen["prefill_logits"]]
    assert len(lens) == 3 and 40 in lens
    assert all(r["ok"] for r in gen["prefill_logits"])
    assert 0.0 <= gen["first_token_agreement_vs_plain"] <= 1.0
    assert gen["output_tokens"] == 7 * 4
    times = lines[10]
    assert len(times["per_layer"]["ou_mvm_cuda"]) == 6
    assert [r["kv_len"] for r in times["per_layer"]["flash_attention_cuda"]
            ] == [17, 40]
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
    assert res["kernels"][3]["library_ms"] > 0
    assert res["kernels"][3]["launches"] == 2 * 7


@pytest.mark.parametrize("fault", ["none", "window", "kv_len"])
def test_flash_rounding_limit_fails_one_key_too_many(fault):
    """``flash_row``'s rounding limit fails an output that lets one key
    too many in (the window's far edge, or the key at ``kv_len``), which
    ``_tolerance`` alone passes: at 300 keys the change is ~1e-3, under
    its 4e-2 but far over half a bf16 ulp of |o| ~ 0.03."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.default_rng(3)

    def normal(*shape):
        return torch.as_tensor(0.5 * rng.normal(size=shape),
                               dtype=torch.float32).bfloat16()

    s, window, kv_len = 300, 256, 280
    c = dict(case=fault, q=normal(1, 4, s, 80), k=normal(1, 2, s, 80),
             v=normal(1, 2, s, 80), causal=True, window=window,
             kv_len=kv_len, dtype="bfloat16")
    kw = dict(causal=True, window=window, kv_len=kv_len)
    if fault == "window":
        kw["window"] = window + 1
    if fault == "kv_len":
        kw["kv_len"] = kv_len + 1
    y = tfa.flash_attention_plain(c["q"], c["k"], c["v"], **kw)
    row = cs.flash_row(c, y)
    assert row["worst_over_limit"] <= 1.0  # _tolerance alone passes it
    assert row["ok"] == (fault == "none")
