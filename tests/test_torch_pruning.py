"""The port's pattern pruning and optimizers against the JAX reference.

The host-numpy steps (magnitude pruning, the pattern dictionaries, the
hard projection) give the reference's results exactly on the same numpy
params.  The optimizers, given the same grads, give the same params to
fp32 rounding.  ADMM pattern pruning on the mini net, from the same
numpy params and the same numpy batches, chooses the same pattern for
every kernel and lands within ``ADMM_ATOL`` of the reference's params:
the two packages' convolution gradients differ by fp32 reassociation
only (measured: at most ~1e-7 after 4 ADMM and 2 retrain steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pruning as jpr  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402

from repro_torch.core import pruning as tpr  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.cnn import params_from_numpy  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

ADMM_ATOL = 1e-4
OPT_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mini():
    cfg = jcnn.mini_cnn_config(num_classes=4, input_hw=12, widths=(8, 16, 16))
    params = jax.tree_util.tree_map(
        np.asarray, jcnn.init_cnn(cfg, jax.random.PRNGKey(0)))
    tcfg = tcnn.CNNConfig(cfg.conv_channels, cfg.pool_after, cfg.num_classes,
                          cfg.input_hw, cfg.kernel)
    return cfg, tcfg, params, jcnn.conv_weight_names(cfg)


def _host(tree):
    return {n: {k: np.asarray(v.detach().cpu().numpy()
                              if isinstance(v, torch.Tensor) else v)
                for k, v in layer.items()}
            for n, layer in tree.items()}


def _assert_params_equal(jparams, tparams):
    for n, layer in _host(tparams).items():
        for k, v in layer.items():
            want = np.asarray(jparams[n][k])
            assert v.dtype == want.dtype, (n, k)
            np.testing.assert_array_equal(v, want, err_msg=f"{n}.{k}")


def _dict_manifest(d):
    return (d.k, tuple(d.patterns))


def test_magnitude_prune_dictionaries_projection_equal(mini):
    _, _, params, names = mini
    jp = jpr.magnitude_prune(params, names, 0.7)
    tp = tpr.magnitude_prune(params_from_numpy(params), names, 0.7)
    _assert_params_equal(jp, tp)
    assert isinstance(tp["conv1"]["w"], torch.Tensor)
    assert tpr.sparsity_of(tp, names) == jpr.sparsity_of(jp, names)

    jd = jpr.build_dictionaries(jp, names, 4)
    td = tpr.build_dictionaries(tp, names, 4)
    assert {n: _dict_manifest(d) for n, d in td.items()} == {
        n: _dict_manifest(d) for n, d in jd.items()}

    for metric in ("magnitude", "hamming"):
        jq, jbits = jpr.project_params(jp, jd, metric)
        tq, tbits = tpr.project_params(tp, td, metric)
        _assert_params_equal(jq, tq)
        assert set(tbits) == set(jbits)
        for n in jbits:
            assert tbits[n].dtype == jbits[n].dtype
            np.testing.assert_array_equal(tbits[n], jbits[n])


def test_numpy_params_stay_on_the_cpu(mini):
    _, _, params, names = mini
    out = tpr.magnitude_prune(params, names, 0.5)
    assert out["conv1"]["w"].device.type == "cpu"
    assert out["fc"]["w"] is params["fc"]["w"]  # untouched layers pass through


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return {n: {k: rng.normal(size=v.shape).astype(np.float32)
                for k, v in layer.items()} for n, layer in params.items()}


@pytest.mark.parametrize("name,kwargs", [
    ("adamw", dict()),
    ("adamw", dict(weight_decay=0.0, b2=0.999)),
    ("lion", dict()),
    ("sgd", dict(momentum=0.8)),
])
def test_optimizer_update_matches_reference(mini, name, kwargs):
    _, _, params, _ = mini
    jo = getattr(jopt, name)(**kwargs)
    to = getattr(topt, name)(**kwargs)
    jp, js = params, jo.init(params)
    tp = params_from_numpy(params)
    ts = to.init(tp)
    for step in range(3):
        g = _grads_like(params, step)
        jp, js = jo.update(g, js, jp, 3e-3)
        tp, ts = to.update(params_from_numpy(g), ts, tp, 3e-3)
    for n, layer in _host(tp).items():
        for k, v in layer.items():
            np.testing.assert_allclose(v, np.asarray(jp[n][k]), rtol=0,
                                       atol=OPT_ATOL, err_msg=f"{n}.{k}")
    assert not any(t.requires_grad for layer in tp.values()
                   for t in layer.values())


def test_norm_clip_and_schedules_match_reference(mini):
    _, _, params, _ = mini
    g = _grads_like(params, 7)
    jn = float(jopt.global_norm(g))
    assert float(topt.global_norm(params_from_numpy(g))) == pytest.approx(
        jn, rel=1e-6)
    jc, _ = jopt.clip_by_global_norm(g, 0.5 * jn)
    tc, tn = topt.clip_by_global_norm(params_from_numpy(g), 0.5 * jn)
    assert float(tn) == pytest.approx(jn, rel=1e-6)
    for n, layer in _host(tc).items():
        for k, v in layer.items():
            np.testing.assert_allclose(v, np.asarray(jc[n][k]), rtol=1e-6,
                                       atol=1e-7)
    for make in (lambda m: m.cosine_schedule(1e-3, 100),
                 lambda m: m.linear_warmup_cosine(1e-3, 10, 100)):
        js, ts = make(jopt), make(topt)
        for step in (0, 1, 5, 10, 11, 55, 100, 150):
            assert ts(step) == pytest.approx(float(js(step)), rel=1e-6)


def _batches(seed, n=32):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(4, 1, 12, 12)).astype(np.float32)
    while True:
        y = rng.integers(0, 4, size=n)
        x = (protos[y] + 0.7 * rng.normal(size=(n, 1, 12, 12))).astype(
            np.float32)
        yield x, y


def test_admm_pattern_prune_matches_reference(mini):
    cfg, tcfg, params, names = mini
    pcfg = jpr.PruneConfig(target_sparsity=0.7, num_patterns=4,
                           admm_steps=4, admm_every=2, retrain_steps=2)

    def jloss(p, x, y):
        logits = jcnn.cnn_apply(cfg, p, x)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y])

    def tloss(p, x, y):
        logits = tcnn.cnn_apply(tcfg, p, x)
        return -torch.mean(torch.log_softmax(logits, -1)[
            torch.arange(y.shape[0]), y])

    jbatches = ((jnp.asarray(x), jnp.asarray(y)) for x, y in _batches(5))
    tbatches = ((torch.as_tensor(x), torch.as_tensor(y))
                for x, y in _batches(5))
    jres = jpr.admm_pattern_prune(
        jax.tree_util.tree_map(jnp.asarray, params), names, jloss, jbatches,
        pcfg, jopt.adamw(weight_decay=0.0), lr=3e-3)
    tres = tpr.admm_pattern_prune(
        params_from_numpy(params), names, tloss, tbatches,
        tpr.PruneConfig(**vars(pcfg)), topt.adamw(weight_decay=0.0), lr=3e-3)

    assert set(tres.pattern_bits) == set(jres.pattern_bits)
    for n in names:
        np.testing.assert_array_equal(tres.pattern_bits[n],
                                      jres.pattern_bits[n], err_msg=n)
        assert _dict_manifest(tres.dictionaries[n]) == _dict_manifest(
            jres.dictionaries[n])
    dist = 0.0
    for n, layer in _host(tres.params).items():
        for k, v in layer.items():
            want = np.asarray(jres.params[n][k])
            dist = max(dist, float(np.abs(v - want).max()))
            if n in names and k == "w":
                np.testing.assert_array_equal(v == 0, want == 0, err_msg=n)
    assert dist <= ADMM_ATOL, dist
    for n in names:
        assert tres.layer_sparsity(n) == pytest.approx(
            jres.layer_sparsity(n), abs=0)
    assert tpr.sparsity_of(tres.params, names) >= 0.7
