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
import torch

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
