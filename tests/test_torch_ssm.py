"""Port's Mamba-2 SSD block against the JAX reference (CPU).

The same parameters (the reference's ``ssm_init``, perturbed so that the
zero biases and unit ``D`` hide nothing) and the same seeded inputs go
through ``repro.models.ssm.ssm_apply`` and ``repro_torch.models.ssm``:
without a cache, with a fresh one, with a random one, at S a multiple of
the chunk, not a multiple, shorter than it and S = 1 (the recurrence),
with one group of B and C and with two (``jnp.repeat`` is
``repeat_interleave``, not ``Tensor.repeat``).  The cache is written in
place and equals the reference's new cache; in a model it stays float32
under a bf16 cache.  Then the reference's own invariant on the port:
the chunked scan equals the token-by-token recurrence.

Tolerances: float32 within 1e-5 relative to the largest value (the two
frameworks sum in other orders); bfloat16 within 3e-2 of it, as
``tests/test_torch_lm.py`` has them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke
from repro.models import ssm as jssm
from repro.models import transformer as jtr

from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import lm_params_from_numpy

F32_REL = 1e-5
BF16_REL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _layer(groups: int, dtype: str):
    """(reference cfg, reference params, port cfg, port params): d_model
    32, 8 heads of 8, d_state 8, chunk 8; every leaf perturbed."""
    jcfg = jssm.SSMConfig(d_model=32, d_state=8, head_dim=8, n_groups=groups,
                          chunk=8, model_shards=1)
    params, _ = jssm.ssm_init(jax.random.PRNGKey(0), jcfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 16))
    params = jax.tree.map(
        lambda a: (a + 0.1 * jax.random.normal(next(keys), a.shape)).astype(
            jnp.dtype(dtype)), params)
    tcfg = tssm.SSMConfig(**dataclasses.asdict(jcfg))
    return jcfg, params, tcfg, lm_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


CASES = {  # (S, cache: None | "fresh" | "random")
    "no_cache": (16, None),
    "fresh_cache": (16, "fresh"),
    "tail_not_chunk_multiple": (13, "random"),
    "shorter_than_chunk": (5, None),
    "one_token_no_cache": (1, None),
    "one_token_random_cache": (1, "random"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_ssm_apply_matches_reference(case, groups, dtype):
    s, cache_kind = CASES[case]
    jcfg, jp, tcfg, tp = _layer(groups, dtype)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    jcache = tcache = None
    if cache_kind is not None:
        fresh = jssm.init_ssm_cache(jcfg, 2)
        jcache = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                                 if cache_kind == "random" else v)
                  for k, v in fresh.items()}
        tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
        ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    want, jnew = jssm.ssm_apply(jp, jcfg, jnp.asarray(x, jnp.dtype(dtype)),
                                jcache)
    got, tnew = tssm.ssm_apply(tp, tcfg, torch.from_numpy(x).to(
        getattr(torch, dtype)), tcache)
    tol = F32_REL if dtype == "float32" else BF16_REL
    assert got.shape == want.shape == (2, s, 32)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got.float().numpy(), want) <= tol
    if cache_kind is None:
        assert tnew is None
        return
    assert tnew is tcache  # written in place, the same tensors
    for k in ("conv", "state"):
        assert tcache[k].data_ptr() == ptrs[k]
        assert tcache[k].dtype == torch.float32
        assert _rel(tcache[k].numpy(), jnew[k]) <= tol


def test_softplus_is_jax_softplus_above_torch_threshold():
    """``dt`` goes through ``jax.nn.softplus``, ``logaddexp(x, 0)``;
    ``torch.nn.functional.softplus`` returns x itself above 20."""
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 25.0, 60.0], np.float32)
    got = tssm._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(x)))


def test_model_ssm_cache_float32_and_written_in_place():
    """In ``apply_model`` (mamba2's smoke model, bf16): the SSM cache is
    float32 under a bf16 ``init_cache``, a prefill writes each stacked
    layer's ``conv`` and ``state`` in place through the body's views, and
    they equal the reference's new cache; the logits agree at the bf16
    tolerance."""
    jcfg = dataclasses.replace(j_smoke("mamba2_780m"), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params, _, jst = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = ttr.ModelConfig(**{
        **{f.name: getattr(jcfg, f.name)
           for f in dataclasses.fields(ttr.ModelConfig)},
        "ssm": tssm.SSMConfig(**dataclasses.asdict(jcfg.ssm))})
    tst = ttr.init_statics(tcfg, "cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jcache = jtr.init_cache(jst, 2, 32, dtype=jnp.bfloat16)
    tcache = ttr.init_cache(tst, 2, 32, dtype=torch.bfloat16)
    body = tcache["body"][0]
    assert {k: v.dtype for k, v in body.items()} == {
        "conv": torch.float32, "state": torch.float32}
    assert body["state"].shape == (tst["n_periods"], 2, *jcache["body"][0][
        "state"].shape[2:])
    ptrs = {k: v.data_ptr() for k, v in body.items()}
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 19))
    jlog, jcache, _ = jtr.apply_model(
        params, jst, jnp.asarray(toks), positions=jnp.arange(19),
        cache=jcache, cache_pos=jnp.int32(0), cache_len=jnp.int32(19))
    tlog, tcache, _ = ttr.apply_model(
        tp, tst, torch.from_numpy(toks), positions=torch.arange(19),
        cache=tcache, cache_pos=0, cache_len=19)
    assert _rel(tlog.float().numpy(), jlog) <= BF16_REL
    for k, v in tcache["body"][0].items():
        assert v.data_ptr() == ptrs[k] and v.dtype == torch.float32
        assert bool(v.abs().sum() > 0)
        assert _rel(v.numpy(), jcache["body"][0][k]) <= BF16_REL


@pytest.mark.parametrize("groups", [1, 2])
def test_chunked_equals_recurrence(groups):
    """``tests/test_models.py::test_ssd_chunked_equals_recurrence`` on the
    port: 12 tokens through the chunked scan (chunk 4) equal the same
    tokens one at a time through the cached recurrence, and the final
    states agree."""
    cfg = tssm.SSMConfig(d_model=32, d_state=8, head_dim=8, n_groups=groups,
                         chunk=4, model_shards=1)
    params = tssm.ssm_init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    x = torch.randn((2, 12, 32), generator=torch.Generator().manual_seed(1)
                    ) * 0.5
    whole = tssm.init_ssm_cache(cfg, 2)
    y_chunk, _ = tssm.ssm_apply(params, cfg, x, whole)
    cache = tssm.init_ssm_cache(cfg, 2)
    ys = [tssm.ssm_apply(params, cfg, x[:, t:t + 1], cache)[0]
          for t in range(12)]
    torch.testing.assert_close(y_chunk, torch.cat(ys, 1), rtol=1e-4,
                               atol=1e-5)
    for k in ("conv", "state"):
        torch.testing.assert_close(whole[k], cache[k], rtol=1e-4, atol=1e-5)
