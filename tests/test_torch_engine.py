"""Port's executor against the JAX reference on the mini net (CPU).

The same numpy params, bits and images go through the reference's
``make_forward(backend='xla')`` and the port's ``make_forward`` on the
CPU (the plain PyTorch path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.pruning import build_dictionaries, magnitude_prune, project_params
from repro.engine import CompileOptions as JCompileOptions
from repro.engine import compile_network as j_compile
from repro.engine import extract_patches as j_extract_patches
from repro.engine import make_forward as j_make_forward
from repro.models import cnn as jcnn

from repro_torch.engine import CompileOptions, compile_network, execute
from repro_torch.engine import extract_patches, make_forward
from repro_torch.models import cnn as tcnn
from repro_torch.obs.trace import Tracer

GEOMETRIES = [(9, 8), (16, 16), (128, 128)]
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# int8: an ulp of fp32 noise can flip one activation's int8 rounding in the
# next layer (repro/engine/executor.py:32-36), so logits agree to one
# quantization step, and top-1 exactly
INT8_LOGIT_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    cfg = jcnn.mini_cnn_config(num_classes=4, input_hw=12, widths=(8, 16, 16))
    params = jcnn.init_cnn(cfg, jax.random.PRNGKey(0))
    names = jcnn.conv_weight_names(cfg)
    params = magnitude_prune(params, names, 0.7)
    params, bits = project_params(params, build_dictionaries(params, names, 4))
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tcnn.CNNConfig(cfg.conv_channels, cfg.pool_after, cfg.num_classes,
                          cfg.input_hw, cfg.kernel)
    return cfg, tcfg, params, bits


@pytest.fixture(scope="module")
def programs(net):
    """(jax, port) program pairs per (precision, block, tile)."""
    cfg, tcfg, params, bits = net
    tparams = tcnn.params_from_numpy(params)
    out = {}
    for precision in ("fp32", "int8"):
        for block, tile in GEOMETRIES:
            geo = dict(block=block, tile=tile, precision=precision)
            out[(precision, block, tile)] = (
                j_compile(cfg, params, bits, options=JCompileOptions(**geo)),
                compile_network(tcfg, tparams, bits,
                                options=CompileOptions(**geo), device="cpu"),
            )
    return out


def _images(n, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 1, 12, 12)).astype(
        np.float32)


@pytest.mark.parametrize("block,tile", GEOMETRIES)
def test_fp32_logits_match_reference(programs, block, tile):
    jprog, tprog = programs[("fp32", block, tile)]
    x = _images(6)
    want = np.asarray(j_make_forward(jprog, backend="xla")(jnp.asarray(x)))
    got = make_forward(tprog, device="cpu")(x)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("block,tile", [(9, 8), (128, 128)])
def test_stats_counts_and_windows_exact(programs, block, tile):
    """Skip counters and window totals equal the reference's exactly,
    with and without a validity mask that has dead rows."""
    jprog, tprog = programs[("fp32", block, tile)]
    x = _images(6, seed=7)
    x[4] = 0.0  # a dead slot's zero padding
    x[5] = 0.0
    valid = np.array([True, True, True, True, False, False])
    jfn = j_make_forward(jprog, backend="xla", collect_stats=True)
    tfn = make_forward(tprog, collect_stats=True, device="cpu")
    for v in (None, valid):
        (jl, js), (tl, ts) = jfn(jnp.asarray(x), v), tfn(x, v)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert set(ts.layers) == set(js.layers)
        for name, st in js.layers.items():
            got = ts.layers[name]
            assert got.windows == st.windows
            assert got.patterns == st.patterns
            np.testing.assert_array_equal(got.counts, st.counts)
            np.testing.assert_array_equal(got.occurrences, st.occurrences)
            assert got.mean_skip() == st.mean_skip()
    assert tfn.trace_count() == 2  # with and without a mask


@pytest.mark.parametrize("block,tile", [(16, 16), (128, 128)])
def test_int8_top1_matches_reference(programs, block, tile):
    jprog, tprog = programs[("int8", block, tile)]
    x = _images(16, seed=3)
    want = np.asarray(j_make_forward(jprog, backend="xla")(jnp.asarray(x)))
    got = make_forward(tprog, device="cpu")(x).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_LOGIT_ATOL)


def test_extract_patches_matches_reference(rng):
    """``F.unfold``'s feature order is the reference's c*k*k + dy*k + dx."""
    x = rng.normal(size=(2, 3, 6, 5)).astype(np.float32)
    for k in (1, 3, 5):
        got = extract_patches(torch.from_numpy(x), k).numpy()
        want = np.asarray(j_extract_patches(jnp.asarray(x), k))
        assert got.shape == want.shape == (2, 6, 5, 3 * k * k)
        np.testing.assert_array_equal(got, want)


def test_cnn_apply_matches_reference(net):
    cfg, tcfg, params, _ = net
    x = _images(4, seed=9)
    want = np.asarray(jcnn.cnn_apply(cfg, params, jnp.asarray(x)))
    got = tcnn.cnn_apply(tcfg, tcnn.params_from_numpy(params),
                         torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_channel_norm_uses_population_std(rng):
    x = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tcnn.channel_norm(torch.from_numpy(x)).numpy(),
        np.asarray(jcnn.channel_norm(jnp.asarray(x))), rtol=1e-6, atol=1e-6,
    )


def test_instrumented_forward_observes_layers(programs):
    _, tprog = programs[("fp32", 16, 16)]
    x = _images(3)
    plain = make_forward(tprog, device="cpu")(x)
    tracer = Tracer()
    fn = make_forward(tprog, tracer=tracer, device="cpu")
    np.testing.assert_array_equal(fn(x).numpy(), plain.numpy())
    assert fn.trace_count() == 1
    names = {op.name for op in tprog.convs} | {"fc"}
    assert set(fn.observed_times()) == names
    spans = {e["name"] for e in tracer.events() if e.get("ph") == "X"}
    assert {"forward", "layer:gap", "layer:fc"} <= spans


def test_disabled_spans_are_one_shared_no_op(programs):
    """A disabled tracer's ``span()`` hands out one shared context manager
    that records nothing and lets an exception through; a forward run
    without a tracer, or with a disabled one, leaves an enabled tracer it
    was never given empty and writes no args on the shared record."""
    from repro_torch.obs import trace

    off = Tracer(enabled=False)
    first = off.span("forward", cat="execute", batch=2)
    assert off.span("layer:conv1") is first
    assert trace.NULL_TRACER.span("layer:fc", op="fc") is first
    with pytest.raises(KeyError):
        with first as sp:
            assert sp is trace._NULL_SPAN
            raise KeyError("through")
    assert off.events() == [] and off.spans() == []
    _, tprog = programs[("int8", 16, 16)]
    unused = Tracer()
    x = _images(2)
    plain = make_forward(tprog, device="cpu")(x)
    off_fn = make_forward(tprog, tracer=off, device="cpu")
    assert torch.equal(off_fn(x), plain)
    assert unused.events() == [] and off.events() == []
    # the forward's own args never land on the shared record
    assert not {"batch", "layers", "rows"} & set(trace._NULL_SPAN.args)
    assert trace._NULL_SPAN.dur == 0.0
    assert off_fn.observed_times() == {}


class _StepClock:
    """A clock that moves one second each time it is read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_traced_forward_never_synchronises(programs, monkeypatch):
    """The instrumented path enqueues every layer without waiting: it
    calls neither ``torch.cuda.synchronize`` nor the executor's sync."""
    from repro_torch.engine import executor

    def refuse(*a, **k):
        raise AssertionError("the traced forward synchronised")

    _, tprog = programs[("fp32", 16, 16)]
    x = _images(3)
    plain = make_forward(tprog, device="cpu")(x)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(executor, "_sync", refuse)
    fn = make_forward(tprog, tracer=Tracer(), device="cpu")
    np.testing.assert_array_equal(fn(x).numpy(), plain.numpy())


def test_traced_forward_spans_and_observed_times(programs):
    """One ``forward`` span holds ``forward.upload`` and each layer's
    span in order; on the CPU ``observed_times()`` is each conv's and the
    FC's mean span duration, under the same keys as before."""
    _, tprog = programs[("fp32", 16, 16)]
    tracer = Tracer(clock=_StepClock())
    fn = make_forward(tprog, tracer=tracer, device="cpu")
    for _ in range(2):
        fn(_images(2))
    convs = [op.name for op in tprog.convs]
    layers = [f"layer:{n}" for n in convs] + ["layer:gap", "layer:fc"]
    spans = sorted(tracer.spans(), key=lambda s: s.ts)
    assert [s.name for s in spans] == 2 * (["forward", "forward.upload"]
                                           + layers)
    fwd = [s for s in spans if s.name == "forward"]
    for s in spans:
        outer = [f for f in fwd if f.ts <= s.ts][-1]
        assert s.ts + s.dur <= outer.ts + outer.dur
    assert all(s.cat == "execute" for s in spans)
    obs = fn.observed_times()
    assert set(obs) == set(convs) | {"fc"}
    for name in convs + ["fc"]:
        durs = [s.dur for s in spans if s.name == f"layer:{name}"]
        assert obs[name] == sum(durs) / len(durs)


def test_int8_traced_forward_spans_quantize_and_walk(programs):
    """An int8 program's traced forward runs each conv's and the FC's
    spmm as ``layer:<name>.quantize`` then ``layer:<name>.spmm_i8``
    inside ``layer:<name>``, each with the call's rows, K and the
    quantization's bytes: what it reads (a conv's input map, quantized
    inside the patch kernel; the FC's float rows) and the int8 rows and
    scales it writes; ``forward`` carries the step's totals."""
    _, tprog = programs[("int8", 16, 16)]
    tracer = Tracer(clock=_StepClock())
    fn = make_forward(tprog, tracer=tracer, device="cpu")
    x = _images(3)
    fn(x)
    spans = sorted(tracer.spans(), key=lambda s: s.ts)
    byname = {s.name: s for s in spans}
    rows, reads, hw = {}, {}, 12
    for op in tprog.convs:
        rows[op.name] = 3 * hw * hw
        reads[op.name] = 4 * 3 * op.c_in * hw * hw  # the input map
        if op.pool_after:
            hw //= 2
    rows["fc"] = 3
    ks = {op.name: op.bp.k_in for op in tprog.convs}
    ks["fc"] = tprog.fc.bp.k_in
    reads["fc"] = 4 * rows["fc"] * ks["fc"]  # the float rows
    for name in rows:
        layer = byname[f"layer:{name}"]
        quant = byname[f"layer:{name}.quantize"]
        walk = byname[f"layer:{name}.spmm_i8"]
        assert layer.ts < quant.ts < walk.ts
        assert walk.ts + walk.dur <= layer.ts + layer.dur
        m, k = rows[name], ks[name]
        want = {"rows": m, "k": k, "bytes_in": reads[name],
                "bytes_out": m * k + 4 * m}
        assert quant.args == want and walk.args == want
    fwd = byname["forward"].args
    assert fwd["rows"] == sum(rows.values())
    assert fwd["bytes_in"] == sum(reads.values())
    assert fwd["bytes_out"] == sum(rows[n] * (ks[n] + 4) for n in rows)
    fn(x)  # totals are a step's, not the process's
    fwds = [s for s in tracer.spans() if s.name == "forward"]
    assert fwds[1].args["rows"] == fwds[0].args["rows"]


@pytest.mark.parametrize("block,tile", [(16, 16), (128, 128)])
def test_fp32_traced_forward_has_no_int8_spans(programs, block, tile):
    _, tprog = programs[("fp32", block, tile)]
    tracer = Tracer()
    make_forward(tprog, tracer=tracer, device="cpu")(_images(2))
    names = {s.name for s in tracer.spans()}
    assert not [n for n in names if n.endswith((".quantize", ".spmm_i8"))]
    fwd = [s for s in tracer.spans() if s.name == "forward"][0]
    assert set(fwd.args) == {"batch", "layers"}


@pytest.mark.parametrize("block,tile", [(16, 16), (128, 128)])
def test_int8_spans_change_no_launch_and_no_logit(programs, monkeypatch,
                                                  block, tile):
    """The traced int8 forward quantizes and walks as often as the
    untraced one: each conv's rows in the fused patch kernel, the FC's
    with ``quantize_rows``; its logits are the untraced forward's bits."""
    from repro_torch.engine import executor
    from repro_torch.kernels import ops

    calls = {"quantize": 0, "fused": 0, "walk": 0}

    def counted(key, f):
        def wrapped(*a, **k):
            calls[key] += 1
            return f(*a, **k)
        return wrapped

    quant = counted("quantize", ops.quantize_rows)
    monkeypatch.setattr(ops, "quantize_rows", quant)
    monkeypatch.setattr(executor, "quantize_rows", quant)
    monkeypatch.setattr(executor, "conv_patches_q8_cuda",
                        counted("fused", executor.conv_patches_q8_cuda))
    monkeypatch.setattr(ops, "pattern_spmm_quant_cuda",
                        counted("walk", ops.pattern_spmm_quant_cuda))
    _, tprog = programs[("int8", block, tile)]
    x = _images(4, seed=11)
    plain = make_forward(tprog, device="cpu")(x)
    untraced = dict(calls)
    traced = make_forward(tprog, tracer=Tracer(), device="cpu")(x)
    layers = len(tprog.convs) + 1
    assert untraced == {"quantize": 1, "fused": len(tprog.convs),
                        "walk": layers}
    assert {k: calls[k] - untraced[k] for k in calls} == untraced
    assert torch.equal(traced, plain)


class _FakeEvent:
    def __init__(self, t):
        self.t, self.done = t, False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3  # ms, as CUDA events give it


def test_layer_events_fold_only_completed_sets_and_reuse_them():
    """Per-layer stream time: a set of boundary events is folded into
    seconds once its last event has completed (a call never waits), and
    ``fold(wait=True)`` waits; folded sets are handed out again."""
    from repro_torch.engine.executor import _LayerEvents

    seen = []
    marks = _LayerEvents(["conv1", None, "fc"])
    first = [_FakeEvent(t) for t in (0.0, 2.0, 3.0, 7.0)]
    second = [_FakeEvent(t) for t in (10.0, 11.0, 12.0, 14.0)]
    marks.recorded(first)
    marks.recorded(second)
    marks.fold(lambda n, s: seen.append((n, s)), wait=False)
    assert seen == []  # nothing completed: nothing folded, nothing waited
    first[-1].done = True
    assert marks.take(lambda n, s: seen.append((n, s))) is first
    assert seen == [("conv1", 2.0), ("fc", 4.0)]
    marks.fold(lambda n, s: seen.append((n, s)), wait=True)
    assert seen[2:] == [("conv1", 1.0), ("fc", 2.0)]
    assert marks.take(lambda n, s: None) is second


def test_execute_caches_per_device(programs):
    _, tprog = programs[("fp32", 9, 8)]
    x = _images(2)
    a = execute(tprog, x, device="cpu")
    b = execute(tprog, x, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert len(tprog._forward_cache) == 1


def test_mesh_is_not_ported_yet(programs):
    """``partition=`` without ``mesh=`` raises as the reference's does
    (the sharded path itself: ``tests/test_torch_sharded.py``)."""
    from repro.engine import NetworkPartition as JNetworkPartition
    from repro_torch.engine import NetworkPartition

    jprog, tprog = programs[("fp32", 9, 8)]
    with pytest.raises(ValueError, match="partition= requires mesh=") as want:
        j_make_forward(jprog, partition=JNetworkPartition(model=2))
    with pytest.raises(ValueError, match="partition= requires mesh=") as got:
        make_forward(tprog, partition=NetworkPartition(model=2), device="cpu")
    assert str(got.value) == str(want.value)
