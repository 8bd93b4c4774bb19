"""Port's InferenceService against the JAX reference's (CPU).

One request stream, submitted in bursts, goes through both services;
inside the port, a request's logits do not depend on what shares its
batch, the fixed slot shape runs one input signature, and the
accumulated skip statistics equal one stats forward over the served
images.
"""

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.pruning import build_dictionaries, magnitude_prune, project_params
from repro.engine import InferenceService as JInferenceService
from repro.engine import compile_network as j_compile
from repro.models import cnn as jcnn
from repro.serve import Request as JRequest

from repro_torch.engine import (
    InferenceService,
    SchedulerFull,
    compile_network,
    make_forward,
)
from repro_torch.models import cnn as tcnn
from repro_torch.obs.trace import Tracer
from repro_torch.serve.api import Request

BURSTS = (1, 7, 19, 2, 5)  # bench_engine.py's SERVICE_BURSTS, shortened


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def progs():
    cfg = jcnn.mini_cnn_config(num_classes=4, input_hw=12, widths=(8, 16, 16))
    params = jcnn.init_cnn(cfg, jax.random.PRNGKey(0))
    names = jcnn.conv_weight_names(cfg)
    params = magnitude_prune(params, names, 0.7)
    params, bits = project_params(params, build_dictionaries(params, names, 4))
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tcnn.CNNConfig(cfg.conv_channels, cfg.pool_after, cfg.num_classes,
                          cfg.input_hw, cfg.kernel)
    return (j_compile(cfg, params, bits),
            compile_network(tcfg, tcnn.params_from_numpy(params), bits,
                            device="cpu"))


def _images(n, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 1, 12, 12)).astype(
        np.float32)


def _serve_bursts(svc, reqs):
    it = iter(reqs)
    for burst in BURSTS:
        for _ in range(burst):
            svc.submit(next(it))
        svc.step()
    svc.run()


def test_same_stream_same_answers(progs):
    jprog, tprog = progs
    images = _images(sum(BURSTS))
    jsvc = JInferenceService(jprog, batch_slots=8, backend="xla")
    tsvc = InferenceService(tprog, batch_slots=8, device="cpu")
    jreqs = [JRequest(image=img) for img in images]
    treqs = [Request(image=img) for img in images]
    _serve_bursts(jsvc, jreqs)
    _serve_bursts(tsvc, treqs)
    assert all(r.done for r in treqs)
    assert [r.label for r in treqs] == [r.label for r in jreqs]
    np.testing.assert_allclose(
        np.stack([r.logits for r in treqs]),
        np.stack([r.logits for r in jreqs]), rtol=1e-5, atol=1e-5,
    )
    assert tsvc.batches_run == jsvc.batches_run
    assert tsvc.trace_count() == jsvc.trace_count() == 1
    m = tsvc.metrics
    assert m["completed"] == len(images) and m["steps"] == tsvc.batches_run


def test_alone_and_cobatched_bit_identical(progs):
    _, tprog = progs
    images = _images(11, seed=8)
    svc = InferenceService(tprog, batch_slots=8, device="cpu")
    alone = Request(image=images[0])
    svc.serve([alone])
    crowd = [Request(image=img) for img in images]
    svc.serve(crowd)
    np.testing.assert_array_equal(alone.logits, crowd[0].logits)
    assert svc.trace_count() == 1


def test_accumulated_stats_equal_one_shot(progs):
    _, tprog = progs
    images = _images(sum(BURSTS), seed=4)
    svc = InferenceService(tprog, batch_slots=8, collect_stats=True,
                           device="cpu")
    svc.warmup()
    reqs = [Request(image=img) for img in images]
    _serve_bursts(svc, reqs)
    assert svc.trace_count() == 1
    _, ref = make_forward(tprog, collect_stats=True, device="cpu")(images)
    for name, st in ref.layers.items():
        got = svc.activation_stats.layers[name]
        assert got.windows == st.windows
        np.testing.assert_array_equal(got.counts, st.counts)


def test_bounded_queue_raises_scheduler_full(progs):
    _, tprog = progs
    svc = InferenceService(tprog, batch_slots=2, max_queue=3, device="cpu")
    images = _images(4)
    for img in images[:3]:
        svc.submit(Request(image=img))
    with pytest.raises(SchedulerFull):
        svc.submit(Request(image=images[3]))
    assert not svc.try_submit(Request(image=images[3]))
    assert svc.metrics["rejected"] == 2
    assert len(svc.run()) == 3
    assert "engine_service_completed_total 3" in svc.metrics_text()
    with pytest.raises(ValueError):
        svc.submit(Request(image=np.zeros((1, 5, 5), np.float32)))


class _StepClock:
    """A clock that moves one second each time it is read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _inside(inner, outer):
    return outer.ts <= inner.ts and \
        inner.ts + inner.dur <= outer.ts + outer.dur


def test_traced_step_records_its_phases_once_a_step(progs):
    """A traced service hands its tracer to the forward and splits each
    step: ``service.stage``, then ``service.step`` holding ``forward``
    (``forward.upload`` and every layer) and ``service.readback``, then
    ``service.complete``; the logits are bit-equal to an untraced
    service's."""
    _, tprog = progs
    images = _images(sum(BURSTS), seed=6)
    tracer = Tracer(clock=_StepClock())
    traced = InferenceService(tprog, batch_slots=8, tracer=tracer,
                              device="cpu")
    plain = InferenceService(tprog, batch_slots=8, device="cpu")
    treqs = [Request(image=img) for img in images]
    preqs = [Request(image=img) for img in images]
    _serve_bursts(traced, treqs)
    _serve_bursts(plain, preqs)
    np.testing.assert_array_equal(np.stack([r.logits for r in treqs]),
                                  np.stack([r.logits for r in preqs]))
    assert traced.trace_count() == plain.trace_count() == 1

    layers = [f"layer:{op.name}" for op in tprog.convs] + ["layer:gap",
                                                           "layer:fc"]
    one_step = (["service.stage", "service.step", "forward",
                 "forward.upload"] + layers
                + ["service.readback", "service.complete"])
    spans = sorted(tracer.spans(), key=lambda s: s.ts)
    assert [s.name for s in spans] == traced.batches_run * one_step
    n = len(one_step)
    for k in range(traced.batches_run):
        by = {s.name: s for s in spans[k * n:(k + 1) * n]}
        assert _inside(by["forward"], by["service.step"])
        assert _inside(by["service.readback"], by["service.step"])
        for name in ["forward.upload"] + layers:
            assert _inside(by[name], by["forward"])
        assert by["service.stage"].ts + by["service.stage"].dur \
            <= by["service.step"].ts
        assert by["service.step"].ts + by["service.step"].dur \
            <= by["service.complete"].ts


# The ops an untraced step of 5 live requests in 8 slots dispatches on the
# CPU (the mini net's 3 convs): pinned, so a change to the served path's
# ops shows here and is made on purpose.
UNTRACED_STEP_OPS = {
    "aten._to_copy.default": 4, "aten._unsafe_view.default": 3,
    "aten.add.Tensor": 12, "aten.bmm.default": 5, "aten.clone.default": 3,
    "aten.constant_pad_nd.default": 4, "aten.detach.default": 1,
    "aten.div.Tensor": 3, "aten.im2col.default": 3,
    "aten.index.Tensor": 5, "aten.index_select.default": 4,
    "aten.lift_fresh.default": 2,
    "aten.max_pool2d_with_indices.default": 1, "aten.mean.dim": 1,
    "aten.permute.default": 28, "aten.relu.default": 3,
    "aten.select.int": 10, "aten.slice.Tensor": 4,
    "aten.std.correction": 3, "aten.transpose.int": 3,
    "aten.unsqueeze.default": 10, "aten.view.default": 34,
    "aten.zeros.default": 4,
}


def _step_ops(svc, images):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    for img in images:
        svc.submit(Request(image=img))
    rec = Record()
    with rec:
        svc.step()
    return rec.ops


def test_untraced_step_dispatches_the_pinned_ops(progs):
    """With tracing off a step dispatches the pinned ops; traced, the
    same ops in the same order (spans and events are no torch ops)."""
    import collections

    _, tprog = progs
    images = _images(5)
    plain = _step_ops(InferenceService(tprog, batch_slots=8, device="cpu"),
                      images)
    assert dict(collections.Counter(plain)) == UNTRACED_STEP_OPS
    traced = _step_ops(InferenceService(tprog, batch_slots=8,
                                        tracer=Tracer(), device="cpu"),
                       images)
    assert traced == plain
