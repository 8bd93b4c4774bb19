"""Port's language-model stack against the JAX reference (CPU).

The same parameters (the reference's ``init_params``, as numpy) and the
same seeded tokens go through ``repro`` and ``repro_torch``, module by
module: the layers (norms, RoPE, the dense and the pattern-sparse MLP,
grouped and ungrouped), ``attention_apply`` in its regimes (the prefill
kernel route, full, chunked, per-row decode, the SWA decode slice), and
``apply_model`` on the ``granite_3_2b`` and ``h2o_danube_1_8b`` smoke
configs and a small pattern-sparse config.  The sparse layouts are the
reference's numpy, copied, and must be bit-equal.  Then the reference's
own invariants, run on the port: prefill/decode consistency and SWA
masking.

Tolerances: float32 logits within 1e-5 relative to the largest logit
(the two frameworks sum in different orders); bfloat16 within 3e-2 of
it, about eight bf16 ulps (2^-8 each), since the two round at other
places (the port's prefill attention keeps P and the output in float32,
the reference rounds P to bf16).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs import h2o_danube_1_8b as j_h2o
from repro.models import attention as jatt
from repro.models import layers as jl
from repro.models import transformer as jtr

from repro_torch.configs import ARCH_NAMES, PORTED, get_config, get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tl
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cfg(jcfg):
    """The port's ModelConfig with the reference config's fields."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ttr.ModelConfig)}
    if jcfg.sparse is not None:
        fields["sparse"] = tl.PatternSparseConfig(
            **dataclasses.asdict(jcfg.sparse))
    return ttr.ModelConfig(**fields)


def _sparse_smoke():
    return dataclasses.replace(
        j_smoke("h2o_danube_1_8b"), name="sparse_smoke", d_ff=384,
        sparse=jl.PatternSparseConfig(density=0.5, num_patterns=3, block=32,
                                      tile=32),
        model_shards=4)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_tiles,k_max,n_blocks,num_patterns,shards", [
    (54, 8, 20, 8, 16), (64, 21, 54, 8, 16), (6, 3, 4, 3, 1), (8, 4, 4, 3, 4),
])
def test_fake_layouts_bit_equal(n_tiles, k_max, n_blocks, num_patterns,
                                shards):
    for seed in (0, 1, 3):
        np.testing.assert_array_equal(
            tl._fake_block_ids(n_tiles, k_max, n_blocks, seed),
            jl._fake_block_ids(n_tiles, k_max, n_blocks, seed))
        got = tl._fake_pattern_groups(n_tiles, k_max, n_blocks, num_patterns,
                                      seed, model_shards=shards)
        want = jl._fake_pattern_groups(n_tiles, k_max, n_blocks,
                                       num_patterns, seed,
                                       model_shards=shards)
        assert [g["tiles"] for g in got] == [g["tiles"] for g in want]
        for a, b in zip(got, want):
            assert a["blocks"].dtype == b["blocks"].dtype
            np.testing.assert_array_equal(a["blocks"], b["blocks"])


def test_model_statics_equal_reference():
    """Every layer's static of the full-size sparse h2o-danube (and the
    sparse smoke config) equals the reference's: layer kinds, attention
    configs, and each sparse layout's tables, bit for bit."""
    for jcfg in (j_h2o.config(sparse=True), _sparse_smoke()):
        jst = _reference_statics(jcfg)
        tst = ttr.init_statics(_port_cfg(jcfg), "cpu")
        for key in ("prefix", "period", "n_periods"):
            assert tst[key] == jst[key]
        for a, b in zip(tst["prefix_layers"] + tst["body"],
                        jst["prefix_layers"] + jst["body"]):
            assert (a["mixer"], a["ffn"]) == (b["mixer"], b["ffn"])
            assert dataclasses.asdict(a["attn_cfg"]) == dataclasses.asdict(
                b["attn_cfg"])
            ma, mb = a["mlp"], b["mlp"]
            assert ma["act"] == mb["act"]
            assert dataclasses.asdict(ma["sparse"]) == dataclasses.asdict(
                mb["sparse"])
            for name in ("gate", "up", "down"):
                sa, sb = ma[name], mb[name]
                for key in ("block", "tile", "n_out"):
                    assert sa[key] == sb[key]
                for key in ("block_ids", "inv_order"):
                    assert sa[key].dtype == sb[key].dtype
                    np.testing.assert_array_equal(sa[key], sb[key])
                assert [g["tiles"] for g in sa["groups"]] == [
                    g["tiles"] for g in sb["groups"]]
                for ga, gb in zip(sa["groups"], sb["groups"]):
                    np.testing.assert_array_equal(ga["blocks"], gb["blocks"])


def _reference_statics(jcfg):
    """The reference's statics without drawing its weights: one layer's
    init per period position under ``eval_shape``."""
    out = {}

    def init():
        params, _, statics = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        out["statics"] = statics
        return params

    jax.eval_shape(init)
    return out["statics"]


def test_norms_rope_linear_and_dense_mlp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(
        tl.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tl.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)).numpy(),
        np.asarray(jl.layernorm({"scale": jnp.asarray(scale),
                                 "bias": jnp.asarray(bias)}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    pos = np.array([0, 3, 7, 100, 4095])
    xr = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    for theta in (10000.0, 500000.0):
        np.testing.assert_allclose(
            tl.rope_frequencies(32, theta).numpy(),
            np.asarray(jl.rope_frequencies(32, theta)), rtol=1e-6)
        got = tl.apply_rope(_t(xr), _t(pos)[None], tl.rope_frequencies(32,
                                                                      theta))
        want = jl.apply_rope(jnp.asarray(xr), jnp.asarray(pos)[None],
                             jl.rope_frequencies(32, theta))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    for act in ("swiglu", "gelu"):
        p, _, st = jl.mlp_init(jax.random.PRNGKey(1), 64, 96, act=act)
        tp = lm_params_from_numpy(_np(p), "cpu")
        tst = tl.mlp_static(64, 96, act=act)
        np.testing.assert_allclose(
            tl.mlp_apply(tp, tst, _t(x)).numpy(),
            np.asarray(jl.mlp_apply(p, st, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("permuted", [False, True])
def test_sparse_linear_matches_reference(grouped, permuted):
    """The pattern-sparse linear: one gather + one matmul per dictionary
    pattern (grouped), or the brick walk through ``ops.pattern_spmm_raw``
    (no groups), padded tiles cut and the inverse permutation applied."""
    cfg = jl.PatternSparseConfig(density=0.5, num_patterns=3, block=32,
                                 tile=32)
    k_in, n_out = 128, 160  # 5 tiles, padded to 8 for 4 shards
    p, _, jst = jl.sparse_linear_init(jax.random.PRNGKey(2), k_in, n_out, cfg,
                                      seed=5, model_shards=4)
    tcfg = tl.PatternSparseConfig(**dataclasses.asdict(cfg))
    tst = tl.sparse_linear_static(k_in, n_out, tcfg, seed=5, model_shards=4)
    np.testing.assert_array_equal(tst["block_ids"], jst["block_ids"])
    tp_init, st_init = tl.sparse_linear_init(
        torch.Generator().manual_seed(0), k_in, n_out, tcfg, seed=5,
        model_shards=4)
    np.testing.assert_array_equal(st_init["block_ids"], jst["block_ids"])
    assert tp_init["w_comp"].shape == p["w_comp"].shape
    assert not tp_init["w_comp"][n_out // 32:].any()  # padded tiles zero
    if permuted:
        inv = np.random.default_rng(0).permutation(n_out).astype(np.int32)
        jst = {**jst, "inv_order": inv}
        tst = {**tst, "inv_order": inv}
    if not grouped:
        jst = {**jst, "groups": []}
        tst = {**tst, "groups": []}
    tst["tables"] = tl.sparse_tables(tst, "cpu")
    x = np.random.default_rng(1).normal(size=(3, 7, k_in)).astype(np.float32)
    got = tl.sparse_linear(lm_params_from_numpy(_np(p), "cpu"), tst, _t(x))
    want = jl.sparse_linear(p, jst, jnp.asarray(x))
    assert got.shape == want.shape == (3, 7, n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn(jcfg_kw=None):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, model_shards=1)
    kw.update(jcfg_kw or {})
    jcfg = jatt.AttnConfig(**kw)
    p = jatt.attention_init(jax.random.PRNGKey(3), jcfg)[0]
    return jcfg, tatt.AttnConfig(**kw), p, lm_params_from_numpy(_np(p), "cpu")


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the prefill kernel route's calls of ``ops.flash_attention``."""
    calls = []
    real = tops.flash_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tops, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("regime", [
    "prefill_no_cache", "prefill_cache", "prefill_window", "full_offset",
    "chunked", "per_row_decode", "swa_decode_slice", "gqa_repeat_fallback",
])
def test_attention_apply_regimes(regime, kernel_calls):
    rng = np.random.default_rng(4)
    b, s, t = 2, 12, 32
    kw, pos, cache_pos, cache_len, use_cache = {}, np.arange(s), None, None, 0
    if regime == "prefill_window":
        kw = dict(window=5)
    if regime == "gqa_repeat_fallback":  # 6 q heads over 4 kv heads
        kw = dict(n_heads=6, n_kv_heads=4)
    if regime in ("prefill_cache", "prefill_window", "gqa_repeat_fallback"):
        use_cache, cache_pos, cache_len = 1, 0, s
    if regime == "full_offset":
        pos = np.arange(s) + 3
    if regime == "chunked":  # keys beyond full_attn_max_seq: chunk loop
        kw = dict(full_attn_max_seq=8, chunk=8)
        use_cache, cache_pos, cache_len = 1, 4, 4 + s
        pos = np.arange(s) + 4
    if regime == "per_row_decode":
        s, use_cache = 1, 1
        cache_pos = np.array([5, 17])
        cache_len, pos = cache_pos + 1, cache_pos[:, None]
    if regime == "swa_decode_slice":  # t > window, one shared position
        kw = dict(window=8)
        s, use_cache, cache_pos, cache_len, pos = 1, 1, 20, 21, np.array([20])
    jcfg, tcfg, p, tp = _attn(kw)
    x = rng.normal(size=(b, s, 64)).astype(np.float32)
    cache = None
    if use_cache:
        kv = rng.normal(size=(2, b, t, jcfg.n_kv_heads, 16)).astype(
            np.float32)
        cache = {"k": kv[0], "v": kv[1]}
    jargs = dict(cache=None if cache is None else jax.tree.map(jnp.asarray,
                                                               cache),
                 cache_pos=None if cache_pos is None else jnp.asarray(
                     cache_pos),
                 cache_len=None if cache_len is None else jnp.asarray(
                     cache_len))
    targs = dict(cache=None if cache is None else {k: _t(v) for k, v in
                                                   cache.items()},
                 cache_pos=None if cache_pos is None else (
                     _t(cache_pos) if np.ndim(cache_pos) else cache_pos),
                 cache_len=None if cache_len is None else (
                     _t(cache_len) if np.ndim(cache_len) else cache_len))
    want, jc = jatt.attention_apply(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                    **jargs)
    got, tc = tatt.attention_apply(tp, tcfg, _t(x), _t(pos), **targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if cache is not None:
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=1e-6, atol=1e-6)
    prefill = regime.startswith("prefill")
    assert len(kernel_calls) == int(prefill)


def test_flash_decode_strategy_raises():
    _, tcfg, _, tp = _attn({"decode_strategy": "flash"})
    cache = tatt.init_kv_cache(tcfg, 1, 8, torch.float32)
    with pytest.raises(NotImplementedError, match="item 10"):
        tatt.attention_apply(tp, tcfg, torch.zeros(1, 1, 64),
                             torch.tensor([2]), cache=cache, cache_pos=2,
                             cache_len=3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _models(jcfg, dtype=None):
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype,
                                   compute_dtype=dtype)
    params, _, jst = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = _port_cfg(jcfg)
    return (jcfg, params, jst, tcfg, lm_params_from_numpy(_np(params), "cpu"),
            ttr.init_statics(tcfg, "cpu"))


CONFIGS = {
    "granite_3_2b": lambda: j_smoke("granite_3_2b"),
    "h2o_danube_1_8b": lambda: j_smoke("h2o_danube_1_8b"),
    "sparse_smoke": _sparse_smoke,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_model_matches_reference(name, dtype, kernel_calls):
    """Logits without a cache (the prefill kernel route, the window
    masking inside it for h2o-danube: 40 tokens > window 16), then a
    cached prefill and two shared-position decode steps."""
    jcfg, jp, jst, tcfg, tp, tst = _models(CONFIGS[name](), dtype)
    assert ttr.count_params(tp) == jtr.count_params(jp)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 40))
    tol = F32_REL if dtype == "float32" else BF16_REL
    jlog, _, _ = jtr.apply_model(jp, jst, jnp.asarray(toks))
    tlog, _, _ = ttr.apply_model(tp, tst, _t(toks))
    assert tlog.shape == (2, 40, jcfg.padded_vocab) and tlog.dtype == getattr(
        torch, dtype)
    assert _rel(tlog.float().numpy(), jlog) <= tol
    assert len(kernel_calls) == jcfg.n_layers
    jcache = jtr.init_cache(jst, 2, 48, dtype=jnp.float32)
    tcache = ttr.init_cache(tst, 2, 48, dtype=torch.float32)
    for start, stop in ((0, 30), (30, 31), (31, 32)):
        pos = np.arange(start, stop)
        jlog, jcache, _ = jtr.apply_model(
            jp, jst, jnp.asarray(toks[:, start:stop]),
            positions=jnp.asarray(pos), cache=jcache,
            cache_pos=jnp.int32(start), cache_len=jnp.int32(stop))
        tlog, tcache, _ = ttr.apply_model(
            tp, tst, _t(toks[:, start:stop]), positions=_t(pos),
            cache=tcache, cache_pos=start, cache_len=stop)
        assert _rel(tlog.float().numpy(), jlog) <= tol
    assert len(kernel_calls) == 2 * jcfg.n_layers  # decode: plain route


def test_apply_model_decides_the_route_once(kernel_calls, monkeypatch):
    """``apply_model`` tests the positions once per forward, not once per
    layer; ``prefill=False`` keeps every layer on the plain route, which
    agrees with the kernel route (fp32, 1e-5)."""
    _, _, _, tcfg, tp, tst = _models(j_smoke("h2o_danube_1_8b"))
    tests = []
    real = ttr.is_prefill
    monkeypatch.setattr(ttr, "is_prefill",
                        lambda *a, **k: tests.append(1) or real(*a, **k))
    toks = torch.as_tensor(
        np.random.default_rng(6).integers(0, tcfg.vocab, (2, 24)))
    kern, _, _ = ttr.apply_model(tp, tst, toks)
    assert len(tests) == 1 and len(kernel_calls) == tcfg.n_layers
    plain, _, _ = ttr.apply_model(tp, tst, toks, prefill=False)
    assert len(tests) == 1 and len(kernel_calls) == tcfg.n_layers
    assert _rel(kern.numpy(), plain.numpy()) <= F32_REL


def test_prefill_decode_consistency():
    """Cache-based decode reproduces the full forward pass
    (``tests/test_models.py``'s invariant, on the port)."""
    _, _, _, tcfg, tp, tst = _models(j_smoke("granite_3_2b"))
    toks = torch.as_tensor(
        np.random.default_rng(2).integers(0, tcfg.vocab, (2, 12)))
    full, _, _ = ttr.apply_model(tp, tst, toks)
    cache = ttr.init_cache(tst, 2, max_seq=16, dtype=torch.float32)
    outs = []
    for t in range(12):
        lg, cache, _ = ttr.apply_model(
            tp, tst, toks[:, t:t + 1], positions=torch.tensor([t]),
            cache=cache, cache_pos=t, cache_len=t + 1)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-4,
                               atol=2e-4)


def test_swa_masks_distant_tokens():
    """Sliding-window attention ignores tokens beyond the receptive field
    of 2 layers x window (``tests/test_models.py``'s invariant)."""
    _, _, _, tcfg, tp, tst = _models(j_smoke("h2o_danube_1_8b"))
    w = tcfg.window
    s2 = 2 * w + 4
    t1 = torch.as_tensor(
        np.random.default_rng(3).integers(0, tcfg.vocab, (1, s2)))
    t2 = t1.clone()
    t2[0, 0] = (t1[0, 0] + 1) % tcfg.vocab
    l1, _, _ = ttr.apply_model(tp, tst, t1)
    l2, _, _ = ttr.apply_model(tp, tst, t2)
    torch.testing.assert_close(l1[0, -1], l2[0, -1], rtol=1e-5, atol=1e-5)
    assert not torch.equal(l1[0, 1], l2[0, 1])  # inside the window it shows


def test_configs_copied_exactly():
    for arch in PORTED:
        jmod = importlib.import_module(f"repro.configs.{arch}")
        tmod = importlib.import_module(f"repro_torch.configs.{arch}")
        for sparse in (False, True):
            assert tmod.config(sparse=sparse) == _port_cfg(
                jmod.config(sparse=sparse))
        assert get_config(arch, "decode_32k") == _port_cfg(
            j_get_config(arch, "decode_32k"))
        assert get_smoke_config(arch) == _port_cfg(j_smoke(arch))
    for arch in set(ARCH_NAMES) - set(PORTED):
        with pytest.raises(NotImplementedError, match="11.6"):
            get_smoke_config(arch)


@pytest.mark.parametrize("field,value,item", [
    ("layer_types", (("mla", "mlp"),), "11.2"),
    ("layer_types", (("attn", "moe"),), "11.1"),
    ("layer_types", (("ssm", "none"),), "11.3"),
    ("layer_types", (("xattn", "mlp"),), "11.4"),
    ("encoder_layers", 2, "11.4"),
    ("mtp", True, "11.2"),
])
def test_unported_parts_raise(field, value, item):
    cfg = dataclasses.replace(get_smoke_config("granite_3_2b"), n_layers=1,
                              layer_types=(("attn", "mlp"),))
    cfg = dataclasses.replace(cfg, **{field: value})
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        ttr.init_statics(cfg, "cpu")


def test_prefix_embeds_raise():
    _, _, _, tcfg, tp, tst = _models(j_smoke("granite_3_2b"))
    with pytest.raises(NotImplementedError, match="item 11.5"):
        ttr.apply_model(tp, tst, torch.zeros(1, 2, dtype=torch.long),
                        prefix_embeds=torch.zeros(1, 2, tcfg.d_model))
