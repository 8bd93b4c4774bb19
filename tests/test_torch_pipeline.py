"""The port's GPipe pipeline against the sequential fold and the JAX
reference (CPU).

The reference's case (``tests/test_pipeline.py``): ``L = 8`` layers of
``tanh(x @ w)`` at ``D = 16`` over a ``stage`` mesh of 4, input ``(6, 2,
16)``, weights and input from a numpy seed.  ``pipeline_apply`` runs on
a spawned 4-rank ``gloo`` group (``tests/torch_mesh_worker.py``'s
``pipeline`` job): every rank returns the outputs, within 1e-6 of the
sequential fold and of the reference's ``pipeline_apply`` on 4 virtual
devices.  Also one microbatch, one stage (a one-rank mesh in this
process), and the ``ValueError`` of a stack the stages do not divide.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from conftest import run_virtual_devices
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.pipeline import pipeline_apply
from test_torch_sharded import _run_ranks

L, D = 8, 16
STAGES = 4
TOL = 1e-6


def _layer(w, x):
    return torch.tanh(x @ w)


def _case(seed: int, n_layers: int, n_micro: int):
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(n_layers, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_micro, 2, D)).astype(np.float32)
    return ws, x


def _fold(ws, x) -> np.ndarray:
    """Each microbatch through every layer in order."""
    out = []
    for xm in torch.as_tensor(x):
        for w in torch.as_tensor(ws):
            xm = _layer(w, xm)
        out.append(xm)
    return torch.stack(out).numpy()


CASES = {"reference": _case(0, L, 6), "one_micro": _case(1, L, 1),
         "indivisible": _case(2, 6, 3)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    return _run_ranks(tmp, STAGES, [{
        "name": "pipe", "kind": "pipeline",
        "cases": [(name, ws, x) for name, (ws, x) in CASES.items()]}])


@pytest.mark.parametrize("case", ["reference", "one_micro"])
def test_pipeline_matches_sequential_fold(case, ranks):
    ws, x = CASES[case]
    want = _fold(ws, x)
    outs = [r["pipe"][case] for r in ranks]
    for y in outs:
        assert y.shape == x.shape
        np.testing.assert_array_equal(y, outs[0])  # every rank returns them
    assert np.abs(outs[0] - want).max() <= TOL


def test_pipeline_raises_when_stages_do_not_divide_the_stack(ranks):
    for r in ranks:
        assert "6 layers do not split over 4 pipeline stages" in \
            r["pipe"]["indivisible"]


def test_pipeline_matches_reference(ranks, tmp_path):
    ws, x = CASES["reference"]
    np.savez(tmp_path / "case.npz", ws=ws, x=x)
    res = run_virtual_devices(STAGES, f"""
    import jax.numpy as jnp
    from repro.launch.mesh import make_mesh
    from repro.parallel.pipeline import pipeline_apply
    case = np.load({str(tmp_path / "case.npz")!r})
    mesh = make_mesh(({STAGES},), ('stage',))
    y = pipeline_apply(lambda w, x: jnp.tanh(x @ w), jnp.asarray(case["ws"]),
                       jnp.asarray(case["x"]), mesh, 'stage')
    print(json.dumps({{"y": np.asarray(y).tolist()}}))
    """)
    want = np.asarray(res["y"], np.float32)
    assert np.abs(ranks[0]["pipe"]["reference"] - want).max() <= TOL


def test_one_stage_is_the_fold():
    mesh = make_mesh((1,), ("stage",), device_type="cpu")
    ws, x = CASES["reference"]
    y = pipeline_apply(_layer, torch.as_tensor(ws), torch.as_tensor(x), mesh)
    np.testing.assert_array_equal(y.numpy(), _fold(ws, x))
