"""The program's spans against a device trace (``h100bench.spantrace``),
on hand-made traces; the span run on a tiny cell on the CPU; on the card,
the launches inside their spans."""

import ast

import pytest

from h100bench import spantrace
from h100bench.devtrace import parse_chrome
from h100bench.registry import BENCH_DIR, Cell, metric_reader
from h100bench.spantrace import parse_spans
from h100bench.tests.test_bench_devtrace import WALK, _trace, _x
from h100bench.tests.tiny import BACKLOG, OPEN, TINY


def _corr_x(name, cat, ts_us, dur_us, corr):
    return {**_x(name, cat, ts_us, dur_us), "args": {"correlation": corr}}


DTOH = "Memcpy DtoH (Device -> Pageable)"


def _linked_trace():
    """A stretch of 250 us ending at 210 us, each device operation paired
    with its runtime call by correlation id.  Busy 20-70, 100-130 and
    200-210; idle -40-20, 70-100 and 130-200."""
    return {"traceEvents": [
        _corr_x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20, 10, 1),
        _corr_x(WALK, "kernel", 30, 40, 2),
        _corr_x("void at::native::im2col_kernel<float>(int)", "kernel",
                100, 30, 3),
        _corr_x(DTOH, "gpu_memcpy", 200, 10, 4),
        _corr_x("void at::native::reduce_kernel<512>(float*)", "kernel",
                100, 5, 5),
        _corr_x("void at::native::elementwise_kernel<128>(int)", "kernel",
                60, 5, 99),  # its call is not in the trace
        _corr_x("cudaMemcpyAsync", "cuda_runtime", 12, 9, 1),
        _corr_x("cudaLaunchKernel", "cuda_runtime", 25, 4, 2),
        _corr_x("cudaLaunchKernel", "cuda_runtime", 85, 10, 3),
        _corr_x("cudaMemcpyAsync", "cuda_runtime", 180, 31, 4),
        _corr_x("cudaLaunchKernel", "cuda_runtime", -30, 2, 5),
    ]}


def _us(name, start, end):
    return (name, start * 1e-6, (end - start) * 1e-6)


# two steps' program spans on the trace's clock; the first lies before
# the stretch
SPANS = [
    _us("service.stage", -1010, -1000), _us("service.step", -1000, -850),
    _us("forward", -1000, -900), _us("service.complete", -850, -840),
    _us("service.stage", 0, 11), _us("service.step", 11, 215),
    _us("forward", 11, 96), _us("forward.upload", 11, 22),
    _us("layer:conv1", 22, 60), _us("layer:fc", 80, 96),
    _us("service.readback", 170, 215), _us("service.complete", 215, 230),
]

BASE_NS = 10**15


def _linked():
    return parse_spans(_linked_trace(), steps=1, window_s=250e-6)


def _placed():
    """The linked stretch with the host clock read 101.0 s and the wall
    clock at 215 us on the trace's clock together at its end."""
    return parse_spans(_linked_trace() | {"baseTimeNanoseconds": BASE_NS},
                       steps=1, window_s=250e-6, host_end=101.0,
                       wall_end_ns=BASE_NS + 215_000)


@pytest.mark.parametrize("make", [_trace, _linked_trace])
def test_parse_spans_keeps_what_parse_chrome_reads(make):
    """The same stretch, operations and calls in the same order, and so
    the same readings, with correlation ids beside them."""
    plain = parse_chrome(make(), steps=1, window_s=200e-6)
    span = parse_spans(make(), steps=1, window_s=200e-6)
    assert (span.t0, span.t1) == (plain.t0, plain.t1)
    assert span.device == plain.device and span.host == plain.host
    assert span.busy_s() == plain.busy_s()
    assert span.idle_gaps() == plain.idle_gaps()
    assert span.top_ops() == plain.top_ops()
    assert len(span.device_corr) == len(span.device)
    assert len(span.host_corr) == len(span.host)
    assert span.clock is None and span.to_trace(1.0) is None


def test_idle_by_span_shares_out_the_idle_time():
    """Each gap is cut at the span edges inside it; each piece goes to
    the innermost span over it."""
    tr = _linked()
    got = tr.idle_by_span(SPANS)
    assert [n for n, _ in got] == [
        "service.step", "outside", "service.readback", "layer:fc",
        "service.stage", "forward", "forward.upload"]
    # -40-20 us: before the stage (40), the stage (11), the upload (9);
    # 70-100: forward (10), layer:fc (16), the step (4); 130-200: the
    # step (40), the readback (30)
    assert dict(got) == {
        "service.step": pytest.approx(44e-6),
        "outside": pytest.approx(40e-6),
        "service.readback": pytest.approx(30e-6),
        "layer:fc": pytest.approx(16e-6),
        "service.stage": pytest.approx(11e-6),
        "forward": pytest.approx(10e-6),
        "forward.upload": pytest.approx(9e-6)}
    assert sum(s for _, s in got) == pytest.approx(
        tr.window_s - tr.busy_s())
    # the host-call view of the same gaps
    assert dict(tr.idle_gaps()) == {"python": pytest.approx(130e-6),
                                    "cudaLaunchKernel": pytest.approx(30e-6)}


def test_device_by_layer_follows_correlation_ids():
    spmm = metric_reader("spmm_roofline").is_spmm
    got = _linked().device_by_layer(SPANS, spmm)
    want = {"forward.upload": [0, 10], "layer:conv1": [40, 0],
            "layer:fc": [0, 30], "service.readback": [0, 10],
            "outside": [0, 5], "unmatched": [0, 5]}
    assert set(got) == set(want)
    for name, (a, b) in want.items():
        assert got[name] == [pytest.approx(a * 1e-6), pytest.approx(b * 1e-6)]


def test_span_checks_count_calls_inside_their_spans():
    """Placed, the forward's least-lagging launch (the walk, 5 us after
    its call) anchors the device clock: every operation moves 5 us
    earlier, and the idle time stays 160 us."""
    tr = _placed()
    c = spantrace.span_checks(tr, SPANS, tr.aligned(SPANS, "forward"))
    assert c["launches_in_forward"] == [2, 3]  # the call at -30 us is not
    assert c["readbacks_in_readback"] == [1, 1]
    assert c["offset_s"] == [pytest.approx(5e-6), pytest.approx(5e-6)]
    assert c["idle_by_span_s"] == pytest.approx(160e-6)
    assert c["idle_s"] == pytest.approx(160e-6)
    assert c["idle_recorded_s"] == pytest.approx(160e-6)
    # a trace that cannot be placed gives the counts alone
    assert "idle_s" not in spantrace.span_checks(_linked(), SPANS, None)


class _Span:
    def __init__(self, name, ts, dur):
        self.name, self.ts, self.dur = name, ts, dur


class _Tracer:
    """What the program's tracer offers: its spans, ``ts`` relative to
    ``origin`` on the host clock."""

    def __init__(self, origin, spans):
        self.origin = origin
        self._spans = [_Span(*s) for s in spans]

    def spans(self):
        return self._spans


def test_program_spans_land_on_the_trace_clock():
    """A span's host-clock start goes where the wall clock read with the
    stretch's end puts it against the trace's base."""
    tracer = _Tracer(100.0, [("forward", 0.5, 0.1)])
    tr = _placed()
    assert tr.to_trace(101.0) == pytest.approx(215e-6)
    assert tr.host_stretch() == (pytest.approx(-35e-6),
                                 pytest.approx(215e-6))
    (name, start, dur), = spantrace.program_spans(tracer, tr)
    assert name == "forward"
    assert start == pytest.approx(215e-6 - 0.5)
    assert dur == pytest.approx(0.1)
    # without a trace: the host clock; without an origin, or a trace
    # that cannot be placed: nothing
    assert spantrace.program_spans(tracer, None)[0][1] == pytest.approx(
        100.5)
    assert spantrace.program_spans(_Tracer(None, [("forward", 0, 1)]),
                                   tr) == []
    assert spantrace.program_spans(tracer, _linked()) == []


def test_program_spans_of_the_programs_tracer():
    """The program's tracer gives the origin its ``ts`` values count
    from."""
    from repro_torch.obs.trace import Tracer

    reads = iter([100.0, 100.5, 100.6])
    tracer = Tracer(clock=lambda: next(reads))
    with tracer.span("forward"):
        pass
    (name, start, dur), = spantrace.program_spans(tracer, None)
    assert (name, start, dur) == ("forward", pytest.approx(100.5),
                                  pytest.approx(0.1))


def _drifting():
    """Two forwards (0-100 and 200-300 us on the trace's clock) whose
    launches' operations truly run 15-35, 60-80, 215-235 and 270-290 us,
    each 5 us or more after its call; the device clock reads them at
    1.5 t + 92.5 us (offset 100 us at 15 us, drifting by half the time
    elapsed).  The host timed the stretch 0-320 us."""
    dev = lambda t: 1.5 * t + 92.5  # noqa: E731
    events = []
    for corr, (call, start, end) in enumerate(
            [(10, 15, 35), (50, 60, 80), (210, 215, 235), (250, 270, 290)],
            1):
        events.append(_corr_x(WALK, "kernel", dev(start),
                              dev(end) - dev(start), corr))
        events.append(_corr_x("cudaLaunchKernel", "cuda_runtime", call, 3,
                              corr))
    trace = {"traceEvents": events, "baseTimeNanoseconds": BASE_NS}
    return parse_spans(trace, steps=2, window_s=320e-6, host_end=50.0,
                       wall_end_ns=BASE_NS + 320_000)


DRIFT_SPANS = [_us("forward", 0, 100), _us("service.stage", 100, 200),
               _us("forward", 200, 300)]


def test_aligned_moves_the_device_onto_the_host_clock():
    """Each forward's least-lagging launch anchors the device clock to
    the host's; between anchors the offset moves linearly, so every
    operation lands 5 us (the anchors' own lag) before its true start."""
    tr = _drifting()
    # as recorded, the device runs 207.5-527.5 us: the first operation
    # is not even in the recorded stretch
    assert tr.t0 == pytest.approx(207.5e-6) and len(tr.device) == 3
    al = tr.aligned(DRIFT_SPANS, "forward")
    assert (al.t0, al.t1) == (pytest.approx(0.0), pytest.approx(320e-6))
    got = [(pytest.approx(s * 1e6), pytest.approx(d * 1e6))
           for _, _, s, d in al.device]
    assert got == [(10, 20), (55, 20), (210, 20), (265, 20)]
    assert al.offsets == [(pytest.approx(10e-6), pytest.approx(105e-6)),
                          (pytest.approx(210e-6), pytest.approx(205e-6))]
    # its gaps: 0-10, 30-55, 75-210, 230-265 and 285-320 us
    assert dict(al.idle_by_span(DRIFT_SPANS)) == {
        "forward": pytest.approx(120e-6),
        "service.stage": pytest.approx(100e-6),
        "outside": pytest.approx(20e-6)}
    assert al.window_s - al.busy_s() == pytest.approx(240e-6)
    assert spantrace.forward_idle_ms(tr, DRIFT_SPANS) == pytest.approx(
        120e-6 / 2 * 1e3)
    # nothing to anchor on, or a trace that cannot be placed
    assert tr.aligned(DRIFT_SPANS, "layer:fc") is None
    assert _linked().aligned(SPANS, "forward") is None


def test_span_readings_on_a_hand_made_window():
    assert spantrace.enqueue_ms(SPANS) == pytest.approx(
        (100 + 85) / 2 * 1e-3)
    assert spantrace.service_host_ms(SPANS) == pytest.approx(
        (10 + 11 + 10 + 15) / 2 * 1e-3)
    # aligned 5 us earlier, the idle inside the forward span 11-96 us:
    # 11-15 and 65-95
    assert spantrace.forward_idle_ms(_placed(), SPANS) == pytest.approx(
        34e-3)


@pytest.mark.parametrize("reading", ["enqueue_ms", "service_host_ms",
                                     "forward_idle_ms"])
def test_span_readings_without_their_spans(reading):
    """A program whose tracer records only ``service.step``, or nothing,
    reads nothing."""
    def read(spans, trace):
        fn = getattr(spantrace, reading)
        return fn(trace, spans) if reading == "forward_idle_ms" else fn(spans)

    assert read([_us("service.step", 0, 10)], _placed()) is None
    assert read([], None) is None


def test_spantrace_imports_nothing_of_the_program():
    tree = ast.parse((BENCH_DIR / "spantrace.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "repro_torch" not in names and "h100bench" in names


@pytest.mark.parametrize("mix", [BACKLOG, OPEN], ids=["backlog", "open"])
def test_span_run_of_a_tiny_cell_on_the_cpu(mix):
    """On the CPU: no profiled stretch, the span readings on the host
    clock, each phase once a step."""
    from h100bench.spanrun import run_spans

    cell = Cell({"name": "t", "chips": 1}, TINY, mix, [], [])
    out = run_spans(cell, 2**31 + 5, 0.3, device="cpu")
    assert out["device"] == "cpu" and out["images"] > 0
    assert out["steps"] == 0 and out["forward_idle_ms"] is None
    assert "checks" not in out
    assert 0 < out["enqueue_ms"] < out["step_ms"]
    assert out["service_host_ms"] > 0


@pytest.mark.gpu
def test_program_spans_hold_the_launches_on_the_card():
    """On the card, served steps of the tiny net under the profiler: the
    kernel launches lie inside ``forward`` spans once the spans are put
    on the trace's clock, the readbacks inside ``service.readback``; and
    the traced forward's ``observed_times`` reads each layer's stream
    time."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from h100bench import cell, generator, synth
    from repro_torch.engine.executor import make_forward
    from repro_torch.obs.trace import Tracer

    dev = torch.device("cuda", 0)
    slots = TINY["service"]["batch_slots"]
    bits = synth.network_patterns(TINY)
    params = synth.device_weights(TINY, bits, 1, dev)
    program = cell.build_program(TINY, params, bits, dev)
    pool = generator.image_pool(2 * slots, (3, 8, 8), 2, dev).cpu().numpy()
    tracer = cell.SpanTracer()
    svc = cell.build_service(program, TINY, dev, tracer)
    cell._warm(svc, pool, slots, True)
    tracer.reset()
    prof = cell._Profile(True, 20)
    prof.stretch = spantrace.SpanStretch()
    win = cell.serve_backlog(svc, pool,
                             generator.image_indices(len(pool), 3), 0.5,
                             2 * slots, prof)
    spans = spantrace.program_spans(tracer, win.trace)
    c = spantrace.span_checks(win.trace, spans,
                              win.trace.aligned(spans, "forward"))
    inside, of = c["launches_in_forward"]
    assert of > 0 and inside >= 0.99 * of, c
    assert c["readbacks_in_readback"][0] == c["readbacks_in_readback"][1] > 0
    assert c["idle_by_span_s"] == pytest.approx(c["idle_s"], rel=0.01)

    fn = make_forward(program, tracer=Tracer(), device=dev)
    for _ in range(3):
        fn(pool[:slots])
    got = fn.observed_times()
    assert set(got) == {op.name for op in program.convs} | {"fc"}
    assert all(0 < t < 1 for t in got.values())
