"""The int8 cell's parts: its configuration, cell and metrics found by
name, the int8 byte count, the plain quantized reference and its
control."""

import copy
import types

import pytest

torch = pytest.importorskip("torch")

from h100bench import counts, counts_i8, reference, reference_quant  # noqa: E402
from h100bench import synth  # noqa: E402
from h100bench.devtrace import parse_chrome  # noqa: E402
from h100bench.registry import BENCH_DIR, load_cell, metric_reader  # noqa: E402
from h100bench.registry import read_json  # noqa: E402
from h100bench.tests.test_bench_imports import _imports  # noqa: E402
from h100bench.tests.tiny import TINY  # noqa: E402

CELL = "vgg16_imagenet_int8.bulk"
METRICS = ["spmm_i8_roofline", "mfu_i8", "glue_i8_device_ms.bulk"]
WALK = ("void (anonymous namespace)::i8::pattern_spmm_i8_kernel<64, 128, 32,"
        " 16>(signed char const*)")
MINI = {"conv_channels": [[1, 2], [2, 3]], "pool_after": [1], "kernel": 3,
        "input_hw": 4, "num_classes": 5}


def test_the_int8_cell_and_its_metrics_are_found_by_name():
    cell = load_cell(CELL)
    assert cell.config["engine"]["precision"] == "int8"
    assert cell.traffic == read_json(BENCH_DIR / "traffic" / "bulk.json")
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == METRICS
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "images_per_s"
        assert callable(metric_reader(m["name"]).read)


def test_the_int8_config_is_the_imagenet_config_in_int8():
    fp32 = read_json(BENCH_DIR / "configs" / "vgg16_imagenet.json")
    int8 = read_json(BENCH_DIR / "configs" / "vgg16_imagenet_int8.json")
    differ = {k for k in fp32 if fp32[k] != int8[k]}
    assert differ == {"name", "engine", "limits", "assumed"}
    assert int8["engine"] == {**fp32["engine"], "precision": "int8"}
    assert "precision" in int8["assumed"]


def test_i8_counts_match_a_hand_count():
    """Two convs (4x4, pool, 2x2) and an FC 3 -> 5 over 2 images, with
    7, 20 and 15 nonzero weights: one byte an input map element and a
    weight, four an output."""
    nnz = {"conv1": 7, "conv2": 20, "fc": 15}
    got = counts_i8.layer_counts_i8(MINI, nnz, batch=2)
    assert [c.name for c in got] == ["conv1", "conv2", "fc"]
    assert (got[0].rows, got[0].ops, got[0].bytes) == (
        32, 2 * 32 * 7, 32 * 1 + 7 + 4 * 32 * 2)
    assert (got[1].rows, got[1].ops, got[1].bytes) == (
        8, 2 * 8 * 20, 8 * 2 + 20 + 4 * 8 * 3)
    assert (got[2].rows, got[2].ops, got[2].bytes) == (
        2, 2 * 2 * 15, 2 * 3 + 15 + 4 * 2 * 5)
    assert [c.ops for c in got] == [
        c.ops for c in counts.layer_counts(MINI, nnz, 2)]
    peaks = {"int8_ops_per_s": 100.0, "hbm_bytes_per_s": 1000.0}
    assert counts_i8.least_seconds_i8(got[0], peaks) == max(
        448 / 100, 103 / 1000)


def _x(name, ts_us, dur_us, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us}


def _run(events, steps=1):
    tr = parse_chrome({"traceEvents": events}, steps=steps,
                      window_s=200e-6)
    cfg = {**TINY, "conv_channels": [[1, 2]], "pool_after": [],
           "input_hw": 2, "num_classes": 3}
    return types.SimpleNamespace(
        trace=tr, config=cfg, nnz={"conv1": 5, "fc": 6}, batch_slots=1,
        peaks={"int8_ops_per_s": 1e9, "hbm_bytes_per_s": 1e8},
        window=types.SimpleNamespace(seconds=2.0, images=4, due=None))


def _events():
    """A step of two int8 calls (a split one), the quantization's ops
    and a copy, in a stretch of 200 us."""
    return [
        _x("Memcpy HtoD", 20, 10, "gpu_memcpy"),
        _x("void at::native::reduce_kernel<512, 1>(float)", 30, 6),
        _x(WALK, 40, 30),
        _x("void (anonymous namespace)::split_reduce_kernel(float*)", 70,
           10),
        _x("void at::native::elementwise_kernel<128, 2>(int)", 100, 14),
        _x(WALK, 120, 4),
        _x("Memcpy DtoH", 200, 10, "gpu_memcpy"),
    ]


def test_i8_readers_over_a_hand_made_trace():
    run = _run(_events())
    calls = counts_i8.layer_counts_i8(run.config, run.nnz, 1)
    least = sum(counts_i8.least_seconds_i8(c, run.peaks) for c in calls)
    got = metric_reader("spmm_i8_roofline").read(run)
    assert got == pytest.approx(100 * least / 44e-6)
    glue = metric_reader("glue_i8_device_ms.bulk").read(run)
    assert glue == pytest.approx((10 + 6 + 14 + 10) * 1e-3)
    mfu = metric_reader("mfu_i8").read(run)
    assert mfu == pytest.approx(
        100 * 4 * counts.image_flops(run.config, run.nnz) / (2.0 * 1e9))
    # an fp32 stretch (no int8 walk), or one walk short: no roofline
    assert metric_reader("spmm_i8_roofline").read(_run(_events()[:5])) is None
    fp32 = [_x("void (anonymous namespace)::f32::pattern_spmm_f32_kernel"
               "<64>(float*)", 40, 30)]
    assert metric_reader("spmm_i8_roofline").read(_run(fp32)) is None


def test_i8_readers_read_nothing_without_a_trace_or_peaks():
    run = _run(_events())
    run.trace, run.peaks = None, None
    for name in METRICS:
        assert metric_reader(name).read(run) is None


@pytest.mark.parametrize("name", ["reference_quant.py", "counts_i8.py"])
def test_quantized_yardstick_imports_nothing_of_the_program(name):
    assert _imports(BENCH_DIR / name) <= {"__future__", "torch",
                                          "dataclasses", "h100bench"}


def _tiny(seed=5, n=6):
    bits = synth.network_patterns(TINY)
    params = synth.device_weights(TINY, bits, seed, "cpu")
    x = torch.randn(n, 3, 8, 8, generator=torch.Generator().manual_seed(seed))
    return params, x


def test_unquantized_forward_equals_the_reference_to_float64_rounding():
    params, x = _tiny()
    want = reference.logits(TINY, params, x)
    got = reference_quant.logits(TINY, params, x, bits=None)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_32_bit_forward_equals_the_reference_to_its_step():
    """At 32 bits each operand moves by at most half of 2**-31 of its
    group's largest magnitude (5e-10): three convs, channel_norm and the
    FC keep the logits within 1e-8 of the unquantized ones."""
    params, x = _tiny(seed=6)
    want = reference.logits(TINY, params, x)
    got = reference_quant.logits(TINY, params, x, bits=32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-8)
    assert not torch.equal(got, want)


def test_rows_round_half_to_even_per_row():
    x = torch.tensor([[7.0, 3.5, -1.5, 0.5], [0.0, 0.0, 0.0, 0.0],
                      [-14.0, 2.5, 1.0, 3.0]], dtype=torch.float64)
    # 4 bits: qmax 7; row 0 steps of 1, row 2 steps of 2
    got = reference_quant.quantize_rows(x, 4)
    want = torch.tensor([[7.0, 4.0, -2.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                         [-14.0, 2.0, 0.0, 4.0]], dtype=torch.float64)
    assert torch.equal(got, want)
    w = torch.tensor([[7.0, -14.0], [3.5, 5.0]], dtype=torch.float64)
    # per output channel = per column of an FC's [in, out]
    assert torch.equal(reference_quant.quantize_out_channels(w, 4, 1),
                       torch.tensor([[7.0, -14.0], [4.0, 4.0]],
                                    dtype=torch.float64))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tiny_int8_program_passes_a_limit_the_int4_control_fails(seed):
    """The control on the CPU at the tiny net's size: the program and
    the 8-bit reference read under a limit that the 4-bit one exceeds
    (on 12 seeds: program <= 0.033, 8 bits <= 0.024, 4 bits >= 0.167)."""
    from h100bench.control_quant import readings

    config = copy.deepcopy(TINY)
    config["engine"]["precision"] = "int8"
    row = readings(config, {"image_pool_batches": 4}, seed, "cpu")
    assert max(row["program"], row["ref_q8"]) <= 0.07 < row["ref_q4"], row
