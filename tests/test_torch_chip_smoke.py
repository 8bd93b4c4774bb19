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
import sys
import time

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config, granite_3_2b, h2o_danube_1_8b
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ou_mvm as tou
from repro_torch.kernels import pattern_spmm as tk
from repro_torch.kernels._grad_guard import refuse_grad
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


def _counting(plain, name, **counters):
    """A plain version counting launches as the wrapper ``name`` does (and
    refusing inputs that require grad, as it does); each of ``counters``
    (name -> predicate of the call's arguments) grows by one per call for
    which its predicate holds."""
    def launch(*args, **kwargs):
        refuse_grad(name, **{f"arg{i}": a for i, a in enumerate(args)})
        launch.launches += 1
        for key, pred in counters.items():
            setattr(launch, key, getattr(launch, key)
                    + bool(pred(*args, **kwargs)))
        return plain(*args, **kwargs)

    launch.launches = 0
    for key in counters:
        setattr(launch, key, 0)
    launch.__name__ = name
    return launch


def _splits(x, w_comp, *rest, **kwargs):
    t, k_max, _, tile = w_comp.shape
    return tk._split_plan(x.shape[0], t, tile, k_max).splits > 1


def _quant_splits(xq, w_comp, *rest, **kwargs):
    t, k_max, _, tile = w_comp.shape
    return tk._quant_plan(xq.shape[0], t, tile, k_max).splits > 1


def _quant_plain(*args, w_kmajor=None, plan=None):
    """The int8 plain version, taking the kernel wrapper's keywords."""
    if w_kmajor is not None:
        assert torch.equal(w_kmajor, tk.kmajor_bricks(args[1]))
    return tk.pattern_spmm_quant_plain(*args)


def _fakes():
    """(module, wrapper name, counting plain version) for every kernel."""
    out = []
    for mod, name, plain, counters in (
        (tk, "pattern_spmm_cuda", tk.pattern_spmm_plain,
         dict(reduce_launches=_splits)),
        (tk, "pattern_spmm_quant_cuda", _quant_plain,
         dict(reduce_launches=_quant_splits)),
        (tou, "ou_mvm_cuda", tou.ou_mvm_plain, {}),
        (tfa, "flash_attention_cuda", tfa.flash_attention_plain,
         dict(launches_tensor_core=lambda q, *r, **k: q.dtype != torch.float32,
              launches_simt=lambda q, *r, **k: q.dtype == torch.float32)),
    ):
        out.append((mod, name, _counting(plain, name, **counters)))
    return out


def _rank_fakes():
    """What each spawned rank of the shard phase runs first: the counting
    plain versions in place of the kernels and a no-op device sync (the
    rank is a fresh process, which the parent's monkeypatches miss), on
    one thread as the rest of the suite runs."""
    torch.set_num_threads(1)
    for mod, name, fake in _fakes():
        setattr(mod, name, fake)
        setattr(ops, name, fake)
    torch.cuda.synchronize = lambda *a, **k: None


def _smoke_decode_lm(seed, dev):
    """The shard phase's decode model at CPU size: granite-3-2b (no
    window) in bf16 with flash-decode, 2 layers of d_model 512 (8 heads
    over 2 key heads of 64), vocabulary 2000.  The smoke config's 515
    logits of ~8 are too few for the phase's bf16 rule: there both
    distances it compares are one or two bf16 steps of the largest
    logit (2^-5 at 8), and their ratio is that of two small integers."""
    cfg = dataclasses.replace(
        granite_3_2b.config(), n_layers=2, layer_types=(("attn", "mlp"),) * 2,
        d_model=512, n_heads=8, n_kv_heads=2, d_head=64, d_ff=1024,
        vocab=2000, decode_strategy="flash")
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    return cfg, params, statics


def _smoke_lm_config(arch):
    """The lm_configs phase's models at CPU size: each architecture's
    smoke config, qwen's with pattern-sparse MLPs, phi3's at
    ``model_shards=16`` (6 q heads pad to 16 over 3 kv heads: the
    kv-repeat route, as phi3's 48 over 10 at full width)."""
    cfg = get_smoke_config(arch)
    if arch == "qwen2_5_32b":
        cfg = dataclasses.replace(cfg, sparse=PatternSparseConfig(
            density=0.5, num_patterns=3, block=32, tile=32))
    if arch == "phi3_medium_14b":
        cfg = dataclasses.replace(cfg, model_shards=16)
    return cfg


def _smoke_ssm_config(arch):
    """The ssm_whisper phase's models at CPU size: each smoke config,
    jamba's cut to its first 5 layers as the phase cuts the published one,
    whisper's with 6 heads of 6 kv heads padded to 16 (``model_shards=16``):
    ungrouped, the kv-repeat route, as whisper-small's 12 over 12 padded
    to 16."""
    cfg = get_smoke_config(arch)
    if arch == "jamba_1_5_large_398b":
        cfg = dataclasses.replace(cfg, n_layers=5,
                                  layer_types=cfg.layer_types[:5])
    if arch == "whisper_small":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=6,
                                  model_shards=16)
    return cfg


def _smoke_vlm_config():
    """The vlm phase's model at CPU size: paligemma's smoke config (8
    patches, 4 heads over 1 of 16) at ``model_shards=16``, so its 4 q
    heads pad to 16 over the one kv head as the published 8 do."""
    return dataclasses.replace(get_smoke_config("paligemma_3b"),
                               model_shards=16)


def _smoke_train_config():
    """The train phase's model at CPU size: the generate phase's smoke
    h2o-danube (bf16, pattern-sparse MLPs, window 16)."""
    return dataclasses.replace(
        h2o_danube_1_8b.smoke_config(), d_ff=384, model_shards=4,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        sparse=PatternSparseConfig(density=0.5, num_patterns=3, block=32,
                                   tile=32))


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
    cfg = _smoke_train_config()
    params, statics = init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    return cfg, params, statics


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    for mod, name, fake in _fakes():
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
    # the prune phase on the mini net: 3 dense steps, then ADMM 4 steps
    # (projection every 2), 2 retrain steps
    monkeypatch.setattr(cs, "prune_model_config",
                        lambda: mini_cnn_config(4, 12, (8, 16, 16)))
    monkeypatch.setattr(cs, "PRUNE_BATCH", 32)
    monkeypatch.setattr(cs, "PRUNE_DENSE_STEPS", 3)
    monkeypatch.setattr(cs, "PRUNE_CFG", dict(
        target_sparsity=0.7, num_patterns=4, admm_steps=4, admm_every=2,
        retrain_steps=2))
    # the shard phase: part (b) on a group of 2 spawned ranks (1 x 2),
    # flash-decode on a narrow granite, 2 prompts of 100 tokens in a cache
    # of 128 slots, 3 steps
    monkeypatch.setattr(cs, "SHARD_MESH", (1, 2))
    monkeypatch.setattr(cs, "SHARD_PREPARE", _rank_fakes)
    monkeypatch.setattr(cs, "build_decode_lm", _smoke_decode_lm)
    monkeypatch.setattr(cs, "DECODE_BATCH", 2)
    monkeypatch.setattr(cs, "DECODE_PROMPT", 100)
    monkeypatch.setattr(cs, "DECODE_MAX_SEQ", 128)
    monkeypatch.setattr(cs, "DECODE_STEPS", 3)
    # the lm_configs phase at smoke size: DeepSeek-V2 served from 6 prompts
    # of 5-30 tokens through 4 slots of 64, 4 new tokens each; the MTP
    # head on 2 x 16 tokens; qwen and phi3 prefills of 17 and 40 tokens
    monkeypatch.setattr(cs, "lm_config", _smoke_lm_config)
    monkeypatch.setattr(cs, "LM_SCFG", dict(batch_slots=4, max_seq=64,
                                            eos_id=-1))
    monkeypatch.setattr(cs, "LM_REQUESTS", 6)
    monkeypatch.setattr(cs, "LM_LENGTHS", (5, 30))
    monkeypatch.setattr(cs, "LM_NEW", 4)
    monkeypatch.setattr(cs, "LM_BURSTS", (1, 3, 2))
    monkeypatch.setattr(cs, "LM_MTP_SHAPE", (2, 16))
    monkeypatch.setattr(cs, "LM_DENSE_PROMPTS", (17, 40))
    monkeypatch.setattr(cs, "LM_DENSE_MAX_SEQ", 64)
    # the ssm_whisper phase at smoke size: the SSD at 13 and 21 tokens (chunk
    # 8: a padded tail), mamba2's handoff at 17 and 30 and served as the
    # generate phase serves; jamba (5 layers) from 6 prompts of 5-30 tokens
    # through 4 slots of 64, 4 new each; whisper 12 prompt tokens and 4
    # greedy steps on 24 frames, a bf16 batch of 2
    monkeypatch.setattr(cs, "ssm_config", _smoke_ssm_config)
    monkeypatch.setattr(cs, "SSD_S", {"mamba2_780m": (13, 21),
                                      "jamba_1_5_large_398b": (13,)})
    monkeypatch.setattr(cs, "HANDOFF_PROMPTS", (17, 30))
    monkeypatch.setattr(cs, "JAMBA_SCFG", dict(batch_slots=4, max_seq=64,
                                               eos_id=-1))
    monkeypatch.setattr(cs, "JAMBA_REQUESTS", 6)
    monkeypatch.setattr(cs, "JAMBA_LENGTHS", (5, 30))
    monkeypatch.setattr(cs, "JAMBA_NEW", 4)
    monkeypatch.setattr(cs, "JAMBA_BURSTS", (1, 3, 2))
    monkeypatch.setattr(cs, "WHISPER_PROMPT", 12)
    monkeypatch.setattr(cs, "WHISPER_STEPS", 4)
    monkeypatch.setattr(cs, "WHISPER_BATCH", 2)
    # the vlm phase at smoke size: 8 patches in front of prompts of 5 and
    # 12 tokens (Sq 13 and 20) in a cache of 64, 3 handoff steps, 4 decode
    # steps; 4 text-only requests of 5-20 tokens through 2 slots, 3 new each
    monkeypatch.setattr(cs, "vlm_config", _smoke_vlm_config)
    monkeypatch.setattr(cs, "VLM_PROMPTS", (5, 12))
    monkeypatch.setattr(cs, "VLM_MAX_SEQ", 64)
    monkeypatch.setattr(cs, "VLM_HANDOFF_STEPS", 3)
    monkeypatch.setattr(cs, "VLM_DECODE", 4)
    monkeypatch.setattr(cs, "VLM_SCFG", dict(batch_slots=2, max_seq=64,
                                             eos_id=-1))
    monkeypatch.setattr(cs, "VLM_REQUESTS", 4)
    monkeypatch.setattr(cs, "VLM_LENGTHS", (5, 20))
    monkeypatch.setattr(cs, "VLM_NEW", 3)
    monkeypatch.setattr(cs, "VLM_BURSTS", (1, 2, 1))
    # the train phase at smoke size: 8 steps of 2 x 32 tokens from a
    # 64-token corpus, the drill at 1 of 2 layers; 6 prompts of 5-30 tokens
    # through 3 slots of 64, 3 new tokens each
    monkeypatch.setattr(cs, "train_config", _smoke_train_config)
    monkeypatch.setattr(cs, "TRAIN_BATCH", (2, 32))
    monkeypatch.setattr(cs, "TRAIN_CORPUS_VOCAB", 64)
    monkeypatch.setattr(cs, "TRAIN_LR", 3e-3)
    monkeypatch.setattr(cs, "DRILL_LAYERS", 1)
    monkeypatch.setattr(cs, "TRAIN_SCFG", dict(batch_slots=3, max_seq=64,
                                               eos_id=-1))
    monkeypatch.setattr(cs, "TRAIN_REQUESTS", 6)
    monkeypatch.setattr(cs, "TRAIN_LENGTHS", (5, 30))
    monkeypatch.setattr(cs, "TRAIN_NEW", 3)
    monkeypatch.setattr(cs, "TRAIN_BURSTS", (1, 3, 2))
    # the train_shard phase at smoke size: the 2 x 2 mesh trains 4 layers
    # of the smoke danube on 4 x 32 tokens; the pipeline's microbatches
    # are 1 x 16 tokens
    monkeypatch.setattr(cs, "SHARD_TRAIN_BATCH", (4, 32))
    monkeypatch.setattr(cs, "PIPE_TOKENS", 16)
    # (h): jamba's smoke config (as on the card) on 4 x 32 tokens
    monkeypatch.setattr(cs, "JAMBA_SHARD_BATCH", (4, 32))
    # the entry_points phase: the launcher on the smoke danube, 4 requests
    # through 2 slots; the twins at their own sizes on the CPU
    monkeypatch.setattr(cs, "ENTRY_SERVE_ARGS", [
        "--arch", "h2o_danube_1_8b", "--smoke", "--requests", "4",
        "--slots", "2", "--prompt-len", "8", "--new-tokens",
        str(cs.ENTRY_NEW)])
    # the ranks find shard_rank by name: chip_smoke, importable
    monkeypatch.syspath_prepend(ROOT)
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    # the fp32 and int8 switches must not leak out of the rehearsal
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)

    res = cs.run(0, torch.device("cpu"))

    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["phase"] for ln in lines] == [
        "device", "build", "compile", "kernels", "kernels", "serve", "shard",
        "search", "prune", "ou_mvm", "flash", "generate", "lm_configs",
        "ssm_whisper", "vlm", "train", "train_shard", "entry_points",
        "times"]
    serve = lines[5]
    assert serve["trace_count"] == [1, 1] and serve["all_done"]
    assert serve["stats_exact"] and serve["labels_match_dense"]
    assert serve["alone_vs_cobatched_bit_identical"]
    assert serve["int8_alone_vs_cobatched_bit_identical"]
    assert serve["e2e_rel_vs_cpu"] <= cs.E2E_TOL
    # 3 convs + FC per batch: 9 fp32 batches for 64 requests, 2 int8
    assert serve["launches"] == {"pattern_spmm_cuda": 36,
                                 "pattern_spmm_quant_cuda": 8}
    assert serve["reduce_launches"] == serve["reduce_launches_expected"]
    assert set(serve["reduce_launches"]) == {"pattern_spmm_cuda",
                                             "pattern_spmm_quant_cuda"}
    for kern, name in zip(lines[3:5], ("pattern_spmm_cuda",
                                       "pattern_spmm_quant_cuda")):
        assert kern["kernel"] == name
        assert all(c["ok"] and c["rerun_bit_identical"] and c["splits"] >= 1
                   and c["blocks"] >= 1 for c in kern["cases"])
    assert all(c["single_brick_exact"] and c["rel"] <= cs.QUANT_REL
               for c in lines[4]["cases"])
    shard = lines[6]
    a, b = shard["part_a"], shard["part_b"]
    assert a["bit_equal"] == {"fp32": True, "int8": True}
    assert a["service_labels_equal"] and a["service_logits_bit_equal"]
    assert a["service_stats_equal"] and a["trace_count"] == 1
    # 3 convs + FC: the fp32 and int8 mesh forwards, 9 served batches
    assert a["launches"] == a["launches_expected"] == {
        "pattern_spmm_cuda": 4 * 10, "pattern_spmm_quant_cuda": 4}
    for part in (a, b):
        assert part["decode_limit"] == cs.DECODE_LIMIT
        assert [r["step"] for r in part["decode"]] == [0, 1, 2]
        assert all(r["fp32_flash_vs_gather"] <= cs.GEN_FP32_REL
                   and r["bf16_flash_vs_fp32"] <= r["bf16_limit"]
                   for r in part["decode"])
        assert all(r["ok"] for r in part["decode"])
        assert part["flash_decode_calls"] == part[
            "flash_decode_calls_expected"] == 2 * 4
        assert part["make_decode_step_token_is_argmax"]
    assert b["mesh"] == [1, 2] and b["ranks"] == 2 and b["ranks_agree"]
    assert b["backend"] == "gloo" and "host memory" in b["transport"]
    assert [r["layer"] for r in b["layer_parity"]] == [
        "conv1", "conv2", "conv3", "fc"]
    assert all(r["rel"] <= cs.LAYER_TOL for r in b["layer_parity"])
    assert b["e2e_rel"] <= cs.E2E_TOL and b["labels_fp32_equal"]
    assert b["int8_max_abs_diff"] <= cs.INT8_SHARD_ATOL
    assert b["int8_argmax_agreement"] >= cs.INT8_SHARD_AGREE
    assert b["stats_equal"] == {"fp32": True, "int8": True}
    assert b["launches_per_rank"] == [b["launches_expected_per_rank"]] * 2
    assert b["launches_expected_per_rank"] == {
        "pattern_spmm_cuda": 36, "pattern_spmm_quant_cuda": 36}
    assert set(b["forward_ms"]) == {"fp32", "int8"}
    assert b["moe"]["sharded_calls"] == 1 and b["moe"]["shape"][:2] == list(
        cs.SHARD_MOE_SHAPE)
    assert b["moe"]["rel_vs_per_shard"] <= cs.MOE_REL
    search = lines[7]
    assert search["bit_equal_vs_cpu_compile"] and search["never_worse"]
    assert set(search["chosen"]) == {"conv1", "conv2", "conv3"}
    assert search["launches"] == 4 * search["batches"]
    assert search["skip"]["measured_layers"] == ["conv1", "conv2", "conv3"]
    assert 0.0 <= search["skip"]["measured_discount"] <= 1.0
    assert {r["name"] for r in search["drift"]["layers"]} == {
        "conv1", "conv2", "conv3"}
    assert search["searched"]["area_cells"] <= search["fixed"]["area_cells"]
    assert search["searched"]["energy_pj"] <= search["fixed"]["energy_pj"]
    prune = lines[8]
    assert set(prune["seconds"]) == {
        "dense_training", "magnitude_prune", "dictionaries", "admm",
        "project", "retrain", "prune_total"}
    assert all(v >= 0 for v in prune["seconds"].values())
    assert all(r["patterns_outside_dictionary"] == 0
               and r["kernels_with_weights_outside_pattern"] == 0
               and r["kernels_below_pattern"] >= 0
               and r["nonzero_patterns"] <= 4
               for r in prune["layers"].values())
    assert 0.7 <= prune["sparsity"] < 1.0
    assert {p: c["exit_code"] for p, c in prune["analysis_cli"].items()} == {
        "fp32": 0, "int8": 0}
    assert all(c["certificate_equal"] for c in prune["analysis_cli"].values())
    assert set(prune["verify_ranges_span_seconds"]["int8"]) == {
        "verify", "ranges"}
    # 3 convs + FC per batch of 8: 64 requests in 9 batches, each program
    assert prune["launches"] == {"pattern_spmm_cuda": 36,
                                 "pattern_spmm_quant_cuda": 36}
    assert [r["bound"] for r in prune["conv1_bound"]] == ["pre_hi", "pre_lo"]
    assert all(r["ok"] and r["distance"] <= r["limit"]
               for r in prune["conv1_bound"])
    assert all(r["inside"] for rows in prune["layers_inside_certificate"]
               .values() for r in rows)
    assert [r["layer"] for r in prune["layers_inside_certificate"]["int8"]
            ] == ["conv1", "conv2", "conv3", "fc"]
    assert prune["e2e_rel_vs_cpu"] <= cs.E2E_TOL
    assert 0.0 <= prune["int8_top1_agreement_vs_fp32"] <= 1.0
    ou = lines[9]
    # 3 convs x 2 patches, the 3 sweep shapes, all-zero x, NaN case
    assert ou["calls"] == ou["launches"] == 11
    assert all(c["ok"] and c["finite"] and c["rerun_bit_identical"]
               and c["slab_cols"] >= 1 and c["blocks"] >= 1
               for c in ou["cases"])
    assert ou["cases"][-2]["skipped_band_share"] == 1.0
    flash = lines[10]
    # 18 sweep cases (4 of them at D 256) x 3 types, each path length bare
    # and from a cache, kv_len < S, qwen's two prefill lengths from its
    # cache, paligemma's two in bf16 and fp32 from its cache, and
    # paligemma's heads with kv_len < S
    assert len(flash["cases"]) == 18 * 3 + 2 * 2 + 1 + 2 + 2 * 2 + 1
    assert sum(c["q"][-1] == 256 for c in flash["cases"]) == 4 * 3
    assert flash["cases"][-8]["kv_len"] == 11
    assert [c["case"] for c in flash["cases"][-7:]] == [
        "qwen_S17_cache", "qwen_S40_cache", "paligemma_S13_cache",
        "paligemma_S13_cache_float32", "paligemma_S20_cache",
        "paligemma_S20_cache_float32", "paligemma_S20_kvlen14"]
    assert [c["q"] for c in flash["cases"][-5:]] == [
        [1, 16, 13, 16]] * 2 + [[1, 16, 20, 16]] * 3
    assert all(c["ok"] and c["finite"] for c in flash["cases"])
    assert all(c["route"] == ("simt" if "float32" in c["case"]
                              else "tensor_core") for c in flash["cases"])
    half = [c for c in flash["cases"] if "float32" not in c["case"]]
    assert half and all(c["worst_over_rounding_limit"] <= 1.0 for c in half)
    gen = lines[11]
    assert gen["all_done"] and gen["trace_count"] == 1
    assert gen["requests"] == gen["prefills"] == 7
    assert gen["launches"] == gen["launches_expected"] == 2 * 7
    assert gen["launches_by_route"] == {"tensor_core": 14, "simt": 0}
    assert gen["admitted_mid_decode"] > 0
    assert all(gen["alone_vs_cobatched_equal"].values())
    lens = [r["prompt_len"] for r in gen["prefill_logits"]]
    assert len(lens) == 3 and 40 in lens
    assert all(r["ok"] for r in gen["prefill_logits"])
    assert 0.0 <= gen["first_token_agreement_vs_plain"] <= 1.0
    assert gen["output_tokens"] == 7 * 4
    lm = lines[12]
    ds2, ds3 = lm["deepseek_v2"], lm["deepseek_v3"]
    assert lm["seconds"] > 0 and set(lm["depth"]) == set(cs.LM_LAYERS)
    assert ds2["mla_absorbed_vs_expanded"]["ok"]
    assert ds2["mla_absorbed_vs_expanded"]["rel"] <= cs.MLA_REL
    assert [r["case"] for r in ds2["moe_layer"]] == ["prefill", "decode"]
    for r in ds2["moe_layer"]:
        assert r["ok"] and r["top_k_equal_host_stable_sort"]
        assert r["no_drop"]["dropped_pairs"] == 0
        assert r["published"]["kept_equal_host_recount"]
    # 4 tokens of top-2 over 8 experts at 1.25: capacity 1
    assert ds2["moe_layer"][1]["published"]["capacity"] == 1
    assert ds2["all_done"] and ds2["trace_count"] == 1
    assert ds2["admitted_mid_decode"] > 0 and ds2["requests"] == 6
    assert len(ds2["first_token_vs_fp32"]) == 6
    assert all(r["finite"] and 0.0 <= r["route_flip_share"] <= 1.0
               for r in ds2["first_token_vs_fp32"])
    assert set(ds2["drop_share"]) == {"prefill", "decode"}
    assert ds2["routed_pairs"]["decode"] > 0
    assert set(ds2["weight_bytes"]) == {"float32", "bfloat16"}
    assert ds2["bf16_weights_are_fp32_rounded"]
    assert set(ds2["peak_memory_bytes"]) == {"float32", "bfloat16"}
    assert ds3["ok"] and ds3["mtp_logits_shape"] == [2, 16, 512]
    assert ds3["bf16_mtp_vs_fp32"] <= ds3["bf16_limit"]
    qwen, phi3 = lm["qwen2_5_32b"], lm["phi3_medium_14b"]
    assert qwen["grouped"] and not phi3["grouped"]
    assert qwen["launches"] == qwen["launches_expected"] == 2 * 2
    assert qwen["launches_by_route"] == {"tensor_core": 4, "simt": 0}
    assert qwen["launch_head_dims"] == [32]
    assert phi3["launches"] == phi3["launches_expected"] == 0
    for r in (qwen, phi3):
        assert [x["prompt_len"] for x in r["prefill_logits"]] == [17, 40]
        assert all(x["ok"] for x in r["prefill_logits"])
    sw = lines[13]
    assert sw["seconds"] > 0 and set(sw["depth"]) == {
        "mamba2_780m", "jamba_1_5_large_398b", "whisper_small"}
    assert [(r["model"], r["S"], r["pad"]) for r in sw["ssd"]] == [
        ("mamba2_780m", 13, 3), ("mamba2_780m", 21, 3),
        ("jamba_1_5_large_398b", 13, 3)]
    assert all(r["ok"] and r["out"]["rel"] <= cs.SSD_OUT_REL
               and r["state"]["worst_over_elementwise"] <= 1.0
               for r in sw["ssd"])
    mamba, jamba, whisper = (sw["mamba2_780m"], sw["jamba_1_5_large_398b"],
                             sw["whisper_small"])
    assert [r["prompt_len"] for r in mamba["handoff"]] == [17, 30]
    assert all(r["ok"] and r["rel"] <= cs.HANDOFF_REL and r["steps"] == 4
               for r in mamba["handoff"])
    assert mamba["all_done"] and mamba["trace_count"] == 1
    assert mamba["requests"] == 7 and mamba["admitted_mid_decode"] > 0
    assert all(mamba["alone_vs_cobatched_equal"].values())
    assert len(mamba["first_tokens"]) == 7
    assert all(r["first_token_is_argmax"] and r["finite"]
               for r in mamba["first_tokens"])
    # 4 layers of conv (3 x (128 + 2 x 16) float32) and state (8 x 16 x 16)
    assert mamba["ssm_cache_bytes_per_slot"] == 4 * 4 * (3 * 160 + 8 * 16 * 16)
    assert mamba["flash_launches"] == 0
    for r in (mamba, jamba):
        assert r["prefills"] == r["requests"] and r["decode_steps"] > 0
        assert 0 < r["prefill_seconds"] + r["decode_seconds"]
    assert jamba["layers"] == 5 and jamba["grouped"]
    assert [t[0] for t in jamba["layer_types"]] == ["ssm"] * 4 + ["attn"]
    assert jamba["all_done"] and jamba["admitted_mid_decode"] > 0
    assert jamba["launches"] == jamba["launches_expected"] == 6
    assert jamba["launches_by_route"] == {"tensor_core": 6, "simt": 0}
    assert jamba["launch_head_dims"] == [16]
    assert len(jamba["flash_vs_plain"]) == 6
    assert all(r["ok"] for r in jamba["flash_vs_plain"])
    assert all(jamba["first_token_is_bf16_prefill_argmax"])
    assert set(jamba["drop_share"]) == {"prefill", "decode"}
    assert jamba["reckoned_peak_bytes"] > jamba["weight_bytes"] > 0
    assert whisper["layers"] == {"encoder": 2, "decoder": 2}
    assert not whisper["grouped"] and whisper["flash_launches"] == 0
    assert whisper["handoff"]["ok"] and whisper["handoff"]["steps"] == 4
    assert len(whisper["handoff"]["greedy_tokens"]) == 4
    assert whisper["prefill_step_token_is_handoff_first"]
    assert whisper["bf16_batch"]["finite"]
    assert whisper["bf16_batch"]["shape"] == [2, 12, 512]
    vlm = lines[14]
    assert vlm["seconds"] > 0 and vlm["layers"] == 2 and vlm["prefix_len"] == 8
    assert vlm["q_heads_padded"] == 16 and vlm["grouped"]
    assert vlm["prefill_lengths"] == [13, 20]
    assert vlm["params"] == vlm["reckoned"]["params"]
    assert vlm["reckoned"]["float32_bytes"] == vlm["weight_bytes"]["float32"]
    assert [r["prompt_len"] for r in vlm["handoff"]] == [5, 12]
    assert all(r["ok"] and r["steps"] == 3 for r in vlm["handoff"])
    assert all(r <= cs.GEN_FP32_REL for r in vlm["fp32_kernel_vs_plain"])
    assert [r["prefill_len"] for r in vlm["prefill_logits"]] == [13, 20]
    assert all(r["ok"] and r["first_token_is_bf16_prefill_argmax"]
               and r["decoded_tokens"] == 4 for r in vlm["prefill_logits"])
    assert [len(t) for t in vlm["prefix_served_tokens"]] == [5, 5]
    assert vlm["all_done"] and vlm["trace_count"] == 1
    assert all(vlm["alone_vs_cobatched_equal"].values())
    assert vlm["requests"] == vlm["prefills"] == 4
    assert vlm["prefills_with_prefix"] == 2
    assert vlm["launches"] == vlm["launches_expected"] == 2 * 6
    assert vlm["launches_by_route"] == {"tensor_core": 12, "simt": 0}
    assert vlm["flash_shapes"] == [[1, 16, 13, 16], [1, 16, 20, 16]]
    for dt in ("bfloat16", "float32"):
        assert vlm["flash_vs_plain"][dt]["calls"] == 2 * 2
        assert vlm["flash_vs_plain"][dt]["failed"] == []
    assert vlm["flash_vs_plain"]["bfloat16"]["worst_over_rounding_limit"] <= 1
    train = lines[15]
    full, drill = train["full"], train["drill"]
    assert len(full["losses"]) == cs.TRAIN_STEPS
    assert full["loss_fell"] > cs.TRAIN_FALL
    assert full["checkpoint"]["bytes"] >= full["reckoned"]["state_bytes"]
    assert len(full["checkpoint"]["seconds"]) == 1
    assert full["reckoned"]["update_peak_bytes"] == (
        4 * full["reckoned"]["params_bytes"]
        + 2 * full["reckoned"]["moments_bytes"])
    assert drill["failure_raised"] and drill["restored_step"] == 4
    assert drill["losses_bit_equal"] and drill["final_state_bit_equal"]
    assert len(drill["losses_interrupted"]) == cs.TRAIN_STEPS
    assert len(drill["async_save_blocking_seconds"]) == 2
    assert drill["checkpoint_bytes"] >= drill["reckoned_checkpoint_bytes"]
    served = train["serve"]
    assert served["all_done"] and served["tokens_below_vocab"]
    assert all(served["first_token_is_prefill_argmax"])
    assert served["launches"] == served["launches_expected"] == 2 * 6
    assert served["launches_by_route"] == {"tensor_core": 12, "simt": 0}
    assert served["flash_calls_checked"] == 12
    assert served["flash_failed"] == []
    guards = train["guards"]
    assert guards["refused"] == {k: True for k in cs.KERNELS}
    assert max(guards["smoke_step_rel"].values()) <= cs.GUARD_REL
    assert drill["deterministic_algorithms"]
    assert drill["cublas_workspace_config"] == ":4096:8"
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    one = drill["one_rank_mesh"]
    assert one["mesh"] == [1, 1] and one["backend"] == "gloo"
    assert one["losses_bit_equal"] and one["state_bit_equal"]
    assert len(one["losses_sharded"]) == cs.ONE_RANK_STEPS
    ts = lines[16]
    f, g, h = ts["part_f"], ts["part_g"], ts["part_h"]
    assert f["layers"] == "4 of 2" and h["width"] == "smoke"
    assert h["model"] == "jamba_smoke"
    for part in (f, h):
        assert part["mesh"] == [2, 2]
        assert part["ranks_losses_equal"]
        assert len(part["losses_float32"]) == 2
        assert max(part["loss_rel_float32"]) <= cs.SHARD_TRAIN_REL
        assert [r["off_where_posed"] for r in part["params_rule"]] == [0,
                                                                       None]
        assert all(r["share_off"] <= cs.MAX_ILL for r in part["params_rule"])
        assert part["resident_bytes"] == [
            {k: r[k] for k in ("params", "moments")}
            for r in part["reckoned_bytes"]]
        # ZeRO-1: each rank holds less than the whole state
        assert all(r["params"] < r["whole_params"]
                   for r in part["reckoned_bytes"])
        assert sorted(tuple(c.values()) for c in part["coords"]) == [
            (0, 0), (0, 1), (1, 0), (1, 1)]
        assert part["restore"]["bit_equal"]
        assert part["restore"]["restored_step"] == 2
        assert len(part["checkpoint_seconds"]) == 1
        assert max(part["bf16"]["rel_vs_unsharded_bf16"]) <= (
            cs.SHARD_TRAIN_BF16_REL)
        # tensor-parallel compute: only the embedding and the head (and,
        # for jamba, its SSM, routers and norms' split leaves) gathered,
        # each step; activations all-reduced over model
        for comm, reck in zip(part["comm_per_step"], part["reckoned_bytes"]):
            assert [c["param_gather_bytes"] for c in comm] == [
                reck["gathered_params"]] * 2
            assert all(c["model_reduce_bytes"] > 0 for c in comm)
            assert reck["gathered_params"] < reck["whole_params"]
    # danube's sparse MLPs gather their tiles' columns; jamba's are dense
    assert all(c["model_gather_bytes"] > 0
               for comm in f["comm_per_step"] for c in comm)
    # danube: the embedding and the head are its only split leaves left
    assert {r["gathered_leaves"] for r in f["reckoned_bytes"]} == {2}
    assert g["layers"] == 8 and g["stages"] == 4 and g["microbatches"] == 6
    assert g["finite"] and g["ranks_equal"]
    assert g["max_abs_diff"] <= cs.PIPE_REL * g["fold_max_abs"]
    ep = lines[17]
    assert set(ep["runs"]) == {"launch_serve", "serve_decode", "quickstart",
                               "serve_http_classify", "serve_http_generate",
                               "check_baseline_trace"}
    assert all(r["exit_code"] == 0 for r in ep["runs"].values())
    served = ep["launch_serve"]
    assert served["model"] == "h2o_danube_1_8b_smoke"
    assert served["requests"] == 4 and served["tokens_per_request"] == [16]
    assert served["flash_launches"] == served["flash_launches_expected"] == 0
    assert served["device"] == "cpu" and served["tokens_per_s"] > 0
    assert any("check ok" in ln
               for ln in ep["runs"]["serve_http_generate"]["stdout_tail"])
    times = lines[18]
    assert len(times["per_layer"]["ou_mvm_cuda"]) == 6
    assert [r["kv_len"] for r in times["per_layer"]["flash_attention_cuda"]
            ] == [17, 40, 17, 40, 13, 20]
    assert set(times["flash_by_model"]) == {"h2o_danube_1_8b", "qwen2_5_32b",
                                            "paligemma_3b"}
    assert all(r["route"] == "tensor_core"
               for r in times["per_layer"]["flash_attention_cuda"])
    assert all(r["splits"] >= 1 and r["tflops"] > 0 and r["bound_ms"] > 0
               for r in times["per_layer"]["pattern_spmm_cuda"])
    assert all(r["splits"] >= 1 and r["tops"] > 0 and r["bound_ms"] > 0
               for r in times["per_layer"]["pattern_spmm_quant_cuda"])
    assert all(r["gb_per_s"] > 0 and r["blocks"] >= 1
               for r in times["per_layer"]["ou_mvm_cuda"])
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
    # the generate phase's prefills, then the shard phase's: gather's and
    # flash's in (a) and one on each rank of (b), 2 layers each; qwen's 2
    # prefills of 2 layers; jamba's 6 served prefills of its attention
    # layer; paligemma's 2 prefix prefills and 4 requests of 2 layers; the
    # trained danube's 6 requests of 2 layers
    assert res["kernels"][3]["launches"] == (2 * 7 + 2 * (2 + 2) + 2 * 2 + 6
                                             + 2 * 6 + 2 * 6)
    # the spmm launches of the serve, shard (a, then 2 ranks of b) and
    # prune phases
    assert res["kernels"][0]["launches"] == 36 + 40 + 2 * 36 + 36
    assert res["kernels"][1]["launches"] == 8 + 4 + 2 * 36 + 36


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
    # the train phase's limit, its slack from the sum of |terms|, too
    term = cs.flash_term_limit(c, y)["worst_over_term_limit"]
    assert (term <= 1.0) == (fault == "none")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_bound_rounding_limit_counts_the_patch_and_the_bias():
    cs = _load_chip_smoke()
    w = np.full((3, 3, 3), -0.5, np.float32)
    # 27 products and the bias: 28 terms of at most 2^-24 relative each
    assert cs.bound_rounding_limit(2.0, w, 3.0) == 28 * 2.0 ** -24 * (
        2.0 + 3.0 * 13.5)
    assert cs.bound_rounding_limit(-1.0, w[:1], 1.0) == 10 * 2.0 ** -24 * 5.5


@pytest.mark.parametrize("which", ["pre_hi", "pre_lo"])
def test_attaining_patch_reaches_the_certified_bound(which):
    """On the CPU's plain spmm: conv1's output at the centre pixel of the
    attaining image equals the certificate's bound within the rounding
    limit, and the same patch one pixel off the centre (a dropped brick
    row, as a faulty kernel would compute it) misses it by more."""
    from repro_torch.engine import CompileOptions, compile_network
    from repro_torch.models.cnn import CNNConfig

    cs = _load_chip_smoke()
    cfg = CNNConfig(((3, 8), (8, 16)), frozenset({2}), 4, 12)
    rng = np.random.default_rng(4)
    params = {}
    for i, (ci, co) in enumerate(cfg.conv_channels, start=1):
        w = rng.normal(size=(co, ci, 3, 3)).astype(np.float32)
        w[np.abs(w) < 0.5] = 0.0
        params[f"conv{i}"] = {"w": w, "b": rng.normal(size=co).astype(
            np.float32)}
    params["fc"] = {"w": rng.normal(size=(16, 4)).astype(np.float32),
                    "b": np.zeros(4, np.float32)}
    prog = compile_network(cfg, params, options=CompileOptions(
        block=16, tile=8, verify="strict"), device="cpu")
    entry = prog.certificate.layer("conv1")
    w1 = params["conv1"]["w"]
    b1 = params["conv1"]["b"].astype(np.float64)
    reach = 3.0 * np.abs(w1.astype(np.float64)).reshape(8, -1).sum(axis=1)
    sign, j, bound = ((1.0, int(np.argmax(b1 + reach)), entry.pre_hi)
                      if which == "pre_hi"
                      else (-1.0, int(np.argmin(b1 - reach)), entry.pre_lo))
    img = cs.attaining_image(w1, j, sign, 3.0, 12)
    assert img.shape == (1, 3, 12, 12)
    assert np.abs(img).max() == 3.0 and np.count_nonzero(img) <= 27
    pre = cs.pre_activations(prog, img, torch.device("cpu"))
    assert [n for n, _ in pre] == ["conv1", "conv2", "fc"]
    centre = 6 * 12 + 6
    got = float(pre[0][1][centre, j])
    limit = cs.bound_rounding_limit(b1[j], w1[j], 3.0)
    assert abs(got - bound) <= limit
    off = float(pre[0][1][centre + 1, j])
    assert abs(off - bound) > limit


def test_ssd_recurrence_oracle_matches_reference():
    """``chip_smoke.ssd_recurrence`` (the token-by-token oracle of the
    ``ssm_whisper`` phase) against the reference's ``ssm_apply`` on the
    same float32 layer: two groups of B and C, 21 tokens over chunks of
    8, every value of the output, the conv window and the state within
    ``tests/test_models.py``'s elementwise bound (the phase's for the
    state and the window; at chunk 8 the output meets it too)."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    from repro_torch.models.convert import lm_params_from_numpy

    cs = _load_chip_smoke()
    jcfg = jssm.SSMConfig(d_model=32, d_state=8, head_dim=8, n_groups=2,
                          chunk=8, model_shards=1)
    params, _ = jssm.ssm_init(jax.random.PRNGKey(0), jcfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 16))
    params = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(next(keys), a.shape), params)
    x = np.random.default_rng(2).normal(size=(2, 21, 32)).astype(np.float32)
    want, cache = jssm.ssm_apply(params, jcfg, jnp.asarray(x),
                                 jssm.init_ssm_cache(jcfg, 2))
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    from repro_torch.models.ssm import SSMConfig

    got = cs.ssd_recurrence(tparams, SSMConfig(**dataclasses.asdict(jcfg)),
                            torch.from_numpy(x))
    for g, w in zip(got, (want, cache["conv"], cache["state"])):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert (np.abs(g.numpy() - w)
                <= cs.SSD_ATOL + cs.SSD_RTOL * np.abs(w)).all()


def test_jamba_cut_keeps_every_layer_kind():
    """The phase's jamba: the published config's widths, its first 5
    layers (4 SSM, the attention layer at position 4, MoE on the odd
    ones), structured as a prefix of 4 and a period of 1."""
    from repro_torch.configs import jamba_1_5_large_398b
    from repro_torch.models.transformer import find_structure

    cs = _load_chip_smoke()
    cfg = cs.ssm_config("jamba_1_5_large_398b")
    full = jamba_1_5_large_398b.config()
    assert cfg.n_layers == cs.JAMBA_LAYERS == 5
    assert cfg.layer_types == full.layer_types[:5]
    assert dataclasses.replace(cfg, n_layers=72,
                               layer_types=full.layer_types) == full
    assert [m for m, _ in cfg.layer_types] == ["ssm"] * 4 + ["attn"]
    assert [f for _, f in cfg.layer_types] == ["mlp", "moe"] * 2 + ["mlp"]
    assert find_structure(cfg.layer_types) == (4, 1)
    for arch in ("mamba2_780m", "whisper_small"):
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        assert cs.ssm_config(arch) == mod.config()
