"""Port's MoE FFN and MLA mixer against the JAX reference (CPU).

The same parameters (the reference's ``moe_init`` / ``mla_init``, as
numpy) and the same seeded inputs go through ``repro.models.moe`` /
``repro.models.mla`` and their ports.

MoE: the routing (top-k expert ids) and the capacity decisions are
integers and must be equal, also where router probabilities tie (the
lower expert index first, as ``jax.lax.top_k`` orders them); the kept
(token, k) pairs equal a numpy recount of the reference's dispatch from
the reference's own ``top_e``; outputs within 1e-5 relative (float32)
or 3e-2 (bfloat16) of the largest, with and without capacity drops; an
expert no token routed to can be zeroed without changing anything.

MLA: the expanded route (cached prefill) and the absorbed route (decode
at one shared position and at per-row positions), outputs within 1e-5
relative and the written caches within 1e-6; absorbed equals expanded
within the reference's own 2e-4 (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke
from repro.models import mla as jmla
from repro.models import moe as jmoe

from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import lm_params_from_numpy

F32_REL = 1e-5
BF16_REL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe(cf=1.25, dtype=jnp.float32, **kw):
    """DeepSeek-V2's smoke MoE (8 experts, top-2, 2 shared) in both
    packages: (reference cfg, params, static), (port cfg, params, static)."""
    jcfg = dataclasses.replace(j_smoke("deepseek_v2_236b").moe,
                               capacity_factor=cf, **kw)
    jp, _, jst = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, dtype)
    tcfg = tmoe.MoEConfig(**dataclasses.asdict(jcfg))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jcfg, jp, jst), (tcfg, tp, tmoe.moe_static(tcfg, "cpu"))


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _recount(top_e: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """The reference's drop rule on the host: pairs in (expert, token, k)
    order, each expert keeping its first ``cap``."""
    t, k = top_e.shape
    keep = np.zeros((t, k), bool)
    seen = np.zeros(n_experts, int)
    for e in range(n_experts):
        for i in range(t):
            for j in range(k):
                if top_e[i, j] == e:
                    keep[i, j] = seen[e] < cap
                    seen[e] += 1
    return keep


@pytest.mark.parametrize("tie", ["none", "all_zero", "zero_columns"])
def test_route_matches_reference(tie):
    """Top-k ids equal, weights within 1e-6; ties (every expert at logit
    0, or three zero router columns above negative ones) keep the lower
    expert index first."""
    (jcfg, jp, _), (tcfg, tp, _) = _moe()
    x = _x((24, jcfg.d_model), 1)
    w = np.asarray(jp["router"]["w"]).copy()
    if tie == "all_zero":
        w[:] = 0.0
    if tie == "zero_columns":
        x = np.abs(x)
        w = -np.abs(w)
        w[:, [1, 3, 6]] = 0.0
    jw, je = jmoe._route({"router": {"w": jnp.asarray(w)}}, jcfg,
                         jnp.asarray(x))
    tw, te = tmoe._route({"router": {"w": _t(w)}}, tcfg, _t(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    if tie == "all_zero":
        assert (te.numpy() == [0, 1]).all()
    if tie == "zero_columns":
        assert (te.numpy() == [1, 3]).all()


@pytest.mark.parametrize("t,cf", [(1, 1.25), (4, 1.25), (5, 1.25), (20, 0.5),
                                  (24, 0.5), (24, 1.25), (40, 8.0)])
def test_capacity_and_kept_pairs(t, cf):
    """``capacity`` is the reference's half-to-even expression (20 tokens
    at 0.5: 2.5 -> 2), and the kept pairs equal the host recount from
    the reference's ``top_e``."""
    (jcfg, jp, _), (tcfg, _, _) = _moe(cf)
    x = _x((t, jcfg.d_model), 2)
    _, je = jmoe._route(jp, jcfg, jnp.asarray(x))
    je = np.array(je)
    cap = tmoe.capacity(t, tcfg)
    assert cap == int(max(1, round(t * jcfg.top_k / jcfg.n_experts * cf)))
    keep = tmoe.kept_pairs(torch.as_tensor(je), tcfg).numpy()
    np.testing.assert_array_equal(keep, _recount(je, jcfg.n_experts, cap))
    if t == 20:
        assert cap == 2
    if cf == 0.5:
        assert not keep.all()  # some pairs drop
    if cf == 8.0:
        assert keep.all()


@pytest.mark.parametrize("e0,e_loc", [(0, 8), (0, 4), (4, 4), (2, 3)])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_dispatch_matches_reference(e0, e_loc, cf):
    """One shard's partial output (experts ``[e0, e0 + e_loc)``, foreign
    pairs to the sentinel) equals the reference's, with drops."""
    (jcfg, jp, _), (tcfg, tp, _) = _moe(cf)
    x = _x((24, jcfg.d_model), 3)
    jw, je = jmoe._route(jp, jcfg, jnp.asarray(x))
    jex = {k: v[e0:e0 + e_loc] for k, v in jp["experts"].items()}
    tex = {k: v[e0:e0 + e_loc] for k, v in tp["experts"].items()}
    want = jmoe._dispatch_compute_combine(jnp.asarray(x), jw, je, jex, jcfg,
                                          e0)
    got = tmoe._dispatch_compute_combine(
        _t(x), _t(jw), _t(je), tex, tcfg, e0)
    assert _rel(got.numpy(), want) <= F32_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_moe_apply_matches_reference(cf, dtype):
    """``moe_apply`` (routed experts + 2 shared) on [3, 7, D], with drops
    at 0.5 and 1.25 and none at 8.0."""
    jdt = jnp.dtype(dtype)
    (jcfg, jp, jst), (tcfg, tp, tst) = _moe(cf, jdt)
    x = _x((3, 7, jcfg.d_model), 4)
    want = jmoe.moe_apply(jp, jst, jcfg, jnp.asarray(x, jdt))
    got = tmoe.moe_apply(tp, tst, tcfg, _t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= (
        F32_REL if dtype == "float32" else BF16_REL)


def test_moe_routes_to_topk():
    """Ablating an expert no token routed to changes nothing
    (``tests/test_models.py``'s invariant, on the port)."""
    (jcfg, _, _), (tcfg, tp, tst) = _moe(8.0, n_shared=0)
    x = _t(_x((1, 4, jcfg.d_model), 5))
    y1 = tmoe.moe_apply(tp, tst, tcfg, x)
    _, top = tmoe._route(tp, tcfg, x.reshape(-1, jcfg.d_model))
    unused = next(e for e in range(tcfg.n_experts)
                  if e not in set(top.flatten().tolist()))
    p2 = {**tp, "experts": {k: v.clone() for k, v in tp["experts"].items()}}
    for v in p2["experts"].values():
        v[unused] = 0.0
    torch.testing.assert_close(tmoe.moe_apply(p2, tst, tcfg, x), y1,
                               rtol=0, atol=1e-6)
    used = int(top[0, 0])
    for v in p2["experts"].values():
        v[used] = 0.0
    assert not torch.allclose(tmoe.moe_apply(p2, tst, tcfg, x), y1,
                              atol=1e-6)


def test_moe_init_shapes_and_static():
    (jcfg, jp, jst), (tcfg, _, tst) = _moe()
    tp, st = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
                           device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == shapes
    assert st["shared"]["act"] == jst["shared"]["act"] == "swiglu"
    assert st["shared"]["sparse"] is None
    assert tst == st
    assert tmoe.moe_static(dataclasses.replace(tcfg, n_shared=0)) == {}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla():
    jcfg = j_smoke("deepseek_v2_236b").mla
    jp, _ = jmla.mla_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tmla.MLAConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, tcfg, lm_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _caches(jcfg, b, t, seed):
    rng = np.random.default_rng(seed)
    c = {"c_kv": rng.normal(size=(b, t, jcfg.kv_lora)),
         "k_rope": rng.normal(size=(b, t, jcfg.d_rope))}
    c = {k: (0.5 * v).astype(np.float32) for k, v in c.items()}
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: _t(v) for k, v in c.items()})


@pytest.mark.parametrize("regime", [
    "no_cache", "cached_prefill", "cached_prefill_offset", "shared_decode",
    "per_row_decode", "shared_decode_tensor_pos"])
def test_mla_apply_matches_reference(regime):
    jcfg, jp, tcfg, tp = _mla()
    b, t = 2, 24
    s, pos, cache_pos, cache_len = 10, np.arange(10), None, None
    if regime == "cached_prefill":
        cache_pos, cache_len = 0, 10
    if regime == "cached_prefill_offset":
        pos = np.arange(10) + 5
        cache_pos, cache_len = 5, 15
    if regime in ("shared_decode", "shared_decode_tensor_pos"):
        s, pos, cache_pos, cache_len = 1, np.array([13]), 13, 14
    if regime == "per_row_decode":
        s = 1
        cache_pos = np.array([6, 17])
        cache_len, pos = cache_pos + 1, cache_pos[:, None]
    x = _x((b, s, jcfg.d_model), 6, 0.5)
    jc, tc = (None, None) if cache_pos is None else _caches(jcfg, b, t, 7)
    tpos = (torch.tensor(cache_pos) if regime == "shared_decode_tensor_pos"
            or np.ndim(cache_pos) else cache_pos)
    tlen = _t(cache_len) if np.ndim(cache_len) else cache_len
    want, jc = jmla.mla_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), cache=jc,
        cache_pos=None if cache_pos is None else jnp.asarray(cache_pos),
        cache_len=None if cache_len is None else jnp.asarray(cache_len))
    got, tc = tmla.mla_apply(tp, tcfg, _t(x), _t(pos), cache=tc,
                             cache_pos=tpos, cache_len=tlen)
    assert _rel(got.numpy(), want) <= F32_REL
    if jc is not None:
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=1e-6, atol=1e-6)


def test_mla_absorbed_matches_expanded():
    """The absorbed route equals the expanded one (``tests/test_models.py``
    at 2e-4), without a cache and at a cached decode step; each also
    matches the reference's same route within 1e-5."""
    jcfg, jp, tcfg, tp = _mla()
    x = _x((2, 10, jcfg.d_model), 8, 0.5)
    pos = np.arange(10)
    outs = {}
    for absorbed in (True, False):
        got, _ = tmla.mla_apply(tp, tcfg, _t(x), _t(pos), absorbed=absorbed)
        want, _ = jmla.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 absorbed=absorbed)
        assert _rel(got.numpy(), want) <= F32_REL
        outs[absorbed] = got
    torch.testing.assert_close(outs[True], outs[False], rtol=2e-4, atol=2e-4)
    jc, tc = _caches(jcfg, 2, 16, 9)
    tc2 = {k: v.clone() for k, v in tc.items()}
    x1 = _t(_x((2, 1, jcfg.d_model), 10, 0.5))
    a, _ = tmla.mla_apply(tp, tcfg, x1, torch.tensor([11]), cache=tc,
                          cache_pos=11, cache_len=12, absorbed=True)
    e, _ = tmla.mla_apply(tp, tcfg, x1, torch.tensor([11]), cache=tc2,
                          cache_pos=11, cache_len=12, absorbed=False)
    torch.testing.assert_close(a, e, rtol=2e-4, atol=2e-4)


def test_mla_cache_shapes_and_init():
    jcfg, jp, tcfg, _ = _mla()
    c = tmla.init_mla_cache(tcfg, 3, 20, device="cpu")
    jc = jmla.init_mla_cache(jcfg, 3, 20)
    assert {k: tuple(v.shape) for k, v in c.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    assert all(v.dtype == torch.bfloat16 and not v.any() for v in c.values())
    tp = tmla.mla_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == jax.tree.map(
        lambda a: tuple(a.shape), jp)
