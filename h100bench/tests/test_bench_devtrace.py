"""The reduction from a device trace to the per-layer metrics, on a
hand-made trace."""

import types

import pytest

from h100bench import counts
from h100bench.devtrace import parse_chrome, short_name
from h100bench.registry import metric_reader
from h100bench.tests.tiny import TINY

WALK = "void (anonymous namespace)::f32::pattern_spmm_f32_kernel<64>(float*)"


def _x(name, cat, ts_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us}


def _trace():
    """A stretch of 200 us ending with its last operation at 210 us."""
    return {"traceEvents": [
        _x("Memcpy HtoD", "gpu_memcpy", 20, 10),
        _x(WALK, "kernel", 30, 40),
        _x("void (anonymous namespace)::split_reduce_kernel(float*)",
           "kernel", 70, 10),
        _x("void at::native::im2col_kernel<float>(int)", "kernel", 100, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 85, 10),
        _x("Memcpy DtoH", "gpu_memcpy", 200, 10),
        _x("Memset", "gpu_memset", 0, 5),  # before the stretch: not read
    ]}


def _parse(trace):
    return parse_chrome(trace, steps=1, window_s=200e-6)


def test_busy_idle_and_sums_of_a_stretch():
    tr = _parse(_trace())
    assert tr.window_s == pytest.approx(200e-6)
    assert tr.busy_s() == pytest.approx(100e-6)
    spmm, n = tr.seconds_where(lambda s: "pattern_spmm_f32_kernel" in s)
    assert (spmm, n) == (pytest.approx(40e-6), 1)
    assert tr.top_ops(2) == [["(anonymous namespace)::f32::"
                              "pattern_spmm_f32_kernel", pytest.approx(40e-6)],
                             ["at::native::im2col_kernel",
                              pytest.approx(30e-6)]]
    gaps = dict(tr.idle_gaps())
    # 10-20 and 130-200 with nothing open on the host, 80-100 in a launch
    assert gaps == {"python": pytest.approx(80e-6),
                    "cudaLaunchKernel": pytest.approx(20e-6)}


def test_short_name():
    assert short_name("void ns::k<4, 2>(float*)") == "ns::k"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def _run(trace, steps=1, batch=1):
    cfg = {**TINY, "conv_channels": [[1, 2]], "pool_after": [],
           "input_hw": 2, "num_classes": 3}
    nnz = {"conv1": 5, "fc": 6}
    trace.steps = steps
    return types.SimpleNamespace(
        trace=trace, config=cfg, nnz=nnz, batch_slots=batch,
        peaks={"fp32_flops_per_s": 1e9, "hbm_bytes_per_s": 1e9},
        window=types.SimpleNamespace(seconds=2.0, images=4, due=None))


def test_spmm_roofline_counts_nonzeros_over_the_spmm_kernels():
    ev = _trace()["traceEvents"]
    ev.insert(3, _x(WALK, "kernel", 82, 2))  # a step holds 2 calls here
    tr = _parse({"traceEvents": ev})
    run = _run(tr)
    calls = counts.layer_counts(run.config, run.nnz, 1)
    least = sum(counts.least_seconds(c, run.peaks) for c in calls)
    got = metric_reader("spmm_roofline").read(run)
    assert got == pytest.approx(100 * least / 52e-6)
    # one walk missing from the stretch: nothing is read
    assert metric_reader("spmm_roofline").read(
        _run(_parse(_trace()))) is None


def test_glue_mfu_and_idle_readers():
    tr = _parse(_trace())
    run = _run(tr)
    glue = metric_reader("glue_device_ms.bulk").read(run)
    # the two copies and im2col
    assert glue == pytest.approx((10 + 30 + 10) * 1e-3)
    idle = metric_reader("device_idle_pct.bulk").read(run)
    assert idle == pytest.approx(100 * (1 - 100 / 200))
    mfu = metric_reader("mfu").read(run)
    assert mfu == pytest.approx(
        100 * 4 * counts.image_flops(run.config, run.nnz) / (2.0 * 1e9))
