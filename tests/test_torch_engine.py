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
    assert fn.trace_count() == 0
    names = {op.name for op in tprog.convs} | {"fc"}
    assert set(fn.observed_times()) == names
    spans = {e["name"] for e in tracer.events() if e.get("ph") == "X"}
    assert {"forward", "layer:gap", "layer:fc"} <= spans


def test_execute_caches_per_device(programs):
    _, tprog = programs[("fp32", 9, 8)]
    x = _images(2)
    a = execute(tprog, x, device="cpu")
    b = execute(tprog, x, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert len(tprog._forward_cache) == 1


def test_mesh_is_not_ported_yet(programs):
    _, tprog = programs[("fp32", 9, 8)]
    with pytest.raises(NotImplementedError, match="item 10"):
        make_forward(tprog, mesh=object(), device="cpu")
