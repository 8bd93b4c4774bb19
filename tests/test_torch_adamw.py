"""The port's AdamW update, piece by piece (CPU).

``optim.adamw``'s update writes each leaf's new params and moments a
piece of at most ``optimizers.UPDATE_CHUNK`` elements at a time (set
small here):

  * its params and moments equal the whole-leaf expression (the
    reference's, written out here) bit for bit, for float32 and bfloat16
    params, float32 and bfloat16 moments, leaves cut into many pieces,
    one piece, a row wider than the piece, 0-d and empty leaves;
  * the tensors it is given are unchanged;
  * they equal the JAX reference's update within float32 rounding;
  * ``launch.op_stats`` counts its peak above its inputs as its outputs
    and a piece's temporaries, not a leaf's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.optim import adamw as j_adamw
from repro_torch.launch.op_stats import OpStats
from repro_torch.optim import adamw, optimizers
from repro_torch.optim.optimizers import _leaves

B1, B2, EPS, WD, LR = 0.9, 0.95, 1e-8, 0.1, 3e-3
SHAPES = {"stacked": (6, 5, 7), "wide": (3, 40), "vector": (11,),
          "scalar": (), "empty": (0, 4)}
CHUNK = 16


def _whole_leaf(g, m, v, p, count, lr):
    """The reference's per-leaf expression, whole leaves at once."""
    c = count.float()
    g = g.float()
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    mhat = m / (1 - B1**c)
    vhat = v / (1 - B2**c)
    step = mhat / (torch.sqrt(vhat) + EPS) + WD * p.float()
    return (p - lr * step.to(p.dtype)).to(p.dtype), m, v


def _trees(pdtype, mdtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, dtype, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=torch.float32).to(dtype)

    params = {k: t(s, pdtype) for k, s in SHAPES.items()}
    grads = {k: t(s, pdtype, 1e-2) for k, s in SHAPES.items()}
    mu = {k: t(s, mdtype, 1e-2) for k, s in SHAPES.items()}
    nu = {k: t(s, mdtype, 1e-4).abs() for k, s in SHAPES.items()}
    return params, grads, mu, nu


@pytest.mark.parametrize("pdtype,mdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("chunk", [CHUNK, 1, 1 << 24])
def test_pieces_equal_the_whole_leaf(pdtype, mdtype, chunk, monkeypatch):
    monkeypatch.setattr(optimizers, "UPDATE_CHUNK", chunk)
    params, grads, mu, nu = _trees(pdtype, mdtype)
    count = torch.tensor(2, dtype=torch.int32)
    kept = [t.clone() for t in _leaves([params, grads, mu, nu])]
    opt = adamw(B1, B2, EPS, WD, mu_dtype=mdtype)
    new_p, st = opt.update(grads, {"mu": mu, "nu": nu, "count": count},
                           params, LR)
    assert st["count"] == 3
    for k in SHAPES:
        want = _whole_leaf(grads[k], mu[k], nu[k], params[k], count + 1, LR)
        for have, w in zip((new_p[k], st["mu"][k], st["nu"][k]), want):
            assert have.dtype == w.dtype and have.shape == w.shape
            assert torch.equal(have, w), k
    for a, b in zip(_leaves([params, grads, mu, nu]), kept):
        assert torch.equal(a, b)


def test_update_matches_reference(monkeypatch):
    monkeypatch.setattr(optimizers, "UPDATE_CHUNK", CHUNK)
    params, grads, mu, nu = _trees(torch.float32, torch.float32, seed=1)
    count = torch.tensor(4, dtype=torch.int32)
    new_p, st = adamw(B1, B2, EPS, WD).update(
        grads, {"mu": mu, "nu": nu, "count": count}, params, LR)
    j = {name: {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
         for name, tree in (("p", params), ("g", grads), ("m", mu),
                            ("v", nu))}
    jp, js = j_adamw(B1, B2, EPS, WD).update(
        j["g"], {"mu": j["m"], "nu": j["v"], "count": jnp.int32(4)},
        j["p"], LR)
    for k in SHAPES:
        for have, want in ((new_p[k], jp[k]), (st["mu"][k], js["mu"][k]),
                           (st["nu"][k], js["nu"][k])):
            want = np.asarray(want)
            assert have.shape == want.shape
            np.testing.assert_allclose(have.numpy(), want, rtol=1e-6,
                                       atol=1e-9)


def test_counted_peak_is_a_pieces_temporaries(monkeypatch):
    """One stacked float32 leaf of 64 pieces: above the inputs, the peak
    is the three outputs and at most six pieces' float32 temporaries."""
    n, rows = 1 << 14, 64
    shape = (rows, n // rows)
    rng = np.random.default_rng(2)
    p, g, m = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
               for _ in range(3))
    v = m.abs()
    count = torch.tensor(0, dtype=torch.int32)
    piece = n // rows
    monkeypatch.setattr(optimizers, "UPDATE_CHUNK", piece)
    with OpStats() as st:
        st.add_inputs(p, g, m, v, count)
        inputs = st.peak_bytes
        adamw().update(g, {"mu": m, "nu": v, "count": count}, p, LR)
    above = st.peak_bytes - inputs
    assert 3 * 4 * n <= above <= 3 * 4 * n + 6 * 4 * piece + 64
