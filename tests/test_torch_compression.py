"""The port's int8 gradient compression against the JAX reference (CPU).

``optim/compression.py`` quantizes as the reference does, step for step
(``torch.round`` and ``jnp.round`` both round half to even), so over 50
error-feedback steps the int8 trees, the scales and the residuals are
equal bit for bit, from float32 and from bf16 gradients.  Then a twin of
``tests/test_train.py::test_grad_compression_error_feedback``, and
``error_feedback_allreduce`` on a one-rank group, which must equal
``decompress_gradients``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.optim import compression as jc

from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import (
    compress_gradients,
    decompress_gradients,
    error_feedback_allreduce,
    init_compression_state,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(seed):
    """A nested tree (dict, list) of gradients of mixed scales, as numpy."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(64, 33)) * 1e-3).astype(np.float32),
            "blocks": [rng.normal(size=(7,)).astype(np.float32),
                       (rng.standard_cauchy(size=(5, 4)) * 1e-2
                        ).astype(np.float32)],
            "b": np.zeros((3,), np.float32)}


def _flat(tree):
    """Leaves in the reference's order (dict keys sorted) as numpy."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    return [np.asarray(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_gradients_bit_equal_over_50_steps(dtype):
    """Fresh gradients each step, the residuals carried: the int8 values,
    the float32 scales and the residuals equal the reference's bits."""
    jstate = tstate = None
    for step in range(50):
        g = _grads(step)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), g)
        tg = jax.tree.map(lambda a: torch.from_numpy(a).to(
            getattr(torch, dtype)), g)
        if jstate is None:
            jstate = jc.init_compression_state(jg)
            tstate = init_compression_state(tg)
        (jq, js), jstate = jc.compress_gradients(jg, jstate)
        (tq, ts), tstate = compress_gradients(tg, tstate)
        for name, a, b in (("int8", jq, tq), ("scale", js, ts),
                           ("residual", jstate, tstate)):
            for x, y in zip(_flat(a), _flat(b)):
                assert x.dtype == y.dtype and x.shape == y.shape, name
                assert x.tobytes() == y.tobytes(), (name, step)
        for x, y in zip(_flat(jc.decompress_gradients((jq, js))),
                        _flat(decompress_gradients((tq, ts)))):
            assert x.tobytes() == y.tobytes()


def test_grad_compression_error_feedback(rng):
    """Twin of the reference's test: the *accumulated* applied gradient
    tracks the true gradient (residual stays bounded)."""
    g_true = torch.as_tensor(rng.normal(size=(256,)) * 1e-3)
    state = init_compression_state({"g": g_true})
    applied = torch.zeros_like(g_true)
    for _ in range(50):
        comp, state = compress_gradients({"g": g_true}, state)
        applied = applied + decompress_gradients(comp)["g"]
    np.testing.assert_allclose(
        applied.numpy() / 50, g_true.numpy(), atol=2e-6
    )


def test_error_feedback_allreduce_one_rank_equals_decompress():
    make_mesh((1, 1), ("data", "model"), device_type="cpu")
    g = jax.tree.map(torch.from_numpy, _grads(3))
    state = init_compression_state(g)
    reduced, new_state = error_feedback_allreduce(g, state)
    comp, want_state = compress_gradients(g, state)
    for x, y in zip(_flat(reduced), _flat(decompress_gradients(comp))):
        assert x.tobytes() == y.tobytes()
    for x, y in zip(_flat(new_state), _flat(want_state)):
        assert x.tobytes() == y.tobytes()
