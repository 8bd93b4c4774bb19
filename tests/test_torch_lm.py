"""Port's language-model stack against the JAX reference (CPU).

The same parameters (the reference's ``init_params``, as numpy) and the
same seeded tokens go through ``repro`` and ``repro_torch``, module by
module: the layers (norms, RoPE, the dense and the pattern-sparse MLP,
grouped and ungrouped), ``attention_apply`` in its regimes (the prefill
kernel route, full, chunked, per-row decode, the SWA decode slice), and
``apply_model`` on the smoke configs of every ported architecture
(granite, h2o-danube, phi3 grouped and, at ``model_shards=16``, on the
kv-repeat route, qwen with its qkv bias, DeepSeek-V2 with MLA and MoE,
DeepSeek-V3 with its MTP head, mamba2 with the SSM mixer, jamba with
SSM, attention and MoE layers, whisper with its encoder and
cross-attention over the same ``frames``, paligemma with the same patch
``prefix_embeds`` in front of its tokens) and a small pattern-sparse
config.  The
sparse layouts are the reference's numpy, copied, and must be
bit-equal.  bf16 MoE models are compared on the reference's routes
(``_SameRoutes``).  Then the reference's
own invariants, run on the port: prefill/decode consistency and SWA
masking.

Tolerances: float32 logits within 1e-5 relative to the largest logit
(the two frameworks sum in different orders); bfloat16 within 3e-2 of
it, about eight bf16 ulps (2^-8 each), since the two round at other
places (the port's prefill attention keeps P and the output in float32,
the reference rounds P to bf16).  The port's SiLU and GELU are
``jax.nn.silu``'s and ``jax.nn.gelu``'s own arithmetic
(``models.layers.silu``, ``models.layers.gelu``), bit-equal to them in
bf16.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtr

from repro_torch.configs import ARCH_NAMES, PORTED, get_config, get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tl
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cfg(jcfg):
    """The port's ModelConfig with the reference config's fields."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ttr.ModelConfig)}
    for name, cls in (("sparse", tl.PatternSparseConfig),
                      ("moe", tmoe.MoEConfig), ("mla", tmla.MLAConfig),
                      ("ssm", tssm.SSMConfig)):
        if getattr(jcfg, name) is not None:
            fields[name] = cls(**dataclasses.asdict(getattr(jcfg, name)))
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
        _assert_statics_equal(jcfg)


@pytest.mark.parametrize("arch", ["qwen2_5_32b", "phi3_medium_14b",
                                  "deepseek_v2_236b", "deepseek_v3_671b",
                                  "mamba2_780m", "jamba_1_5_large_398b",
                                  "whisper_small"])
def test_new_model_statics_equal_reference(arch):
    """The same for the full-size configs MoE, MLA, the MTP head, the SSM
    mixer and the encoder with cross-attention unlock (the dense two
    pattern-sparse): MLA, SSM and cross-attention configs, the MoE's
    shared MLP, the MTP layer's and the encoder layer's static too."""
    jmod = importlib.import_module(f"repro.configs.{arch}")
    _assert_statics_equal(jmod.config(sparse=True))


def _assert_statics_equal(jcfg):
    jst = _reference_statics(jcfg)
    tst = ttr.init_statics(_port_cfg(jcfg), "cpu")
    for key in ("prefix", "period", "n_periods"):
        assert tst[key] == jst[key]
    layers = list(zip(tst["prefix_layers"] + tst["body"],
                      jst["prefix_layers"] + jst["body"]))
    if jcfg.mtp:
        layers.append((tst["mtp_layer"], jst["mtp_layer"]))
    assert ("encoder" in tst) == ("encoder" in jst)
    if "encoder" in jst:
        layers.append((tst["encoder"], jst["encoder"]))
    for a, b in layers:
        assert (a["mixer"], a["ffn"]) == (b["mixer"], b["ffn"])
        for key in ("attn_cfg", "mla_cfg", "ssm_cfg", "xattn_cfg"):
            assert (key in a) == (key in b)
            if key in a:
                assert dataclasses.asdict(a[key]) == dataclasses.asdict(
                    b[key])
        if a["ffn"] == "none":
            assert "mlp" not in a and "moe" not in a
            continue
        if a["ffn"] == "moe":
            assert ("shared" in a["moe"]) == ("shared" in b["moe"])
            if "shared" in b["moe"]:
                assert a["moe"]["shared"]["act"] == b["moe"]["shared"]["act"]
                assert a["moe"]["shared"]["sparse"] is b["moe"]["shared"][
                    "sparse"] is None
            continue
        ma, mb = a["mlp"], b["mlp"]
        assert ma["act"] == mb["act"]
        if mb["sparse"] is None:
            assert ma["sparse"] is None
            continue
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_is_jax_silu(dtype):
    """``layers.silu`` is ``jax.nn.silu``'s arithmetic: bit-equal in bf16
    (where ``F.silu``, rounded once, differs in the last bit of ~40 % of
    values), within an ulp in float32."""
    x = (3 * np.random.default_rng(0).normal(size=100_000)).astype(
        np.float32)
    want = np.asarray(jax.nn.silu(jnp.asarray(x, jnp.dtype(dtype))),
                      np.float32)
    got = tl.silu(_t(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=3e-7, atol=1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_jax_gelu(dtype):
    """``layers.gelu`` is ``jax.nn.gelu``'s arithmetic (``approximate=True``,
    each step rounded in x's dtype): bit-equal in bf16, where
    ``F.gelu(approximate="tanh")``, rounded once, differs in ~43 % of
    values.  In float32 the two ``tanh``s may differ in the last bit, and
    ``1 + tanh`` and the products carry that to at most a few ulps of
    ``x`` (measured 3.9 x 2^-24 |x|): held to 2^-21 |x|."""
    x = (3 * np.random.default_rng(0).normal(size=100_000)).astype(
        np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.dtype(dtype))),
                      np.float32)
    got = tl.gelu(_t(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        once = torch.nn.functional.gelu(_t(x).bfloat16(), approximate="tanh")
        assert (once.float().numpy() != want).mean() > 0.3
    else:
        assert (np.abs(got - want) <= 2.0 ** -21 * np.abs(x)).all()
    assert tl._act("gelu", _t(x[:64])).equal(tl.gelu(_t(x[:64])))


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
    """``decode_strategy='flash'`` with no mesh in context falls through
    to the ordinary decode, as the reference's does: the same output and
    cache as the reference at rtol 1e-5, and the sharded route untouched
    (it runs under a mesh: ``tests/test_torch_sharded.py``)."""
    jcfg, tcfg, p, tp = _attn({"decode_strategy": "flash"})
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    kv = rng.normal(size=(2, 2, 8, 2, 16)).astype(np.float32)
    calls = tatt.flash_decode_sharded.calls
    want, jc = jatt.attention_apply(
        p, jcfg, jnp.asarray(x), jnp.asarray([2]),
        cache={"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])},
        cache_pos=jnp.int32(2), cache_len=jnp.int32(3))
    got, tc = tatt.attention_apply(
        tp, tcfg, _t(x), torch.tensor([2]),
        cache={"k": _t(kv[0]), "v": _t(kv[1])}, cache_pos=2, cache_len=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-6, atol=1e-6)
    assert tatt.flash_decode_sharded.calls == calls


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
    "phi3_medium_14b": lambda: j_smoke("phi3_medium_14b"),
    # 6 q heads pad to 16 over 3 kv heads: 16 % 3 != 0, the kv-repeat route
    "phi3_kv_repeat": lambda: dataclasses.replace(
        j_smoke("phi3_medium_14b"), model_shards=16),
    "qwen2_5_32b": lambda: j_smoke("qwen2_5_32b"),
    "deepseek_v2_236b": lambda: j_smoke("deepseek_v2_236b"),
    "deepseek_v3_671b": lambda: j_smoke("deepseek_v3_671b"),
    "mamba2_780m": lambda: j_smoke("mamba2_780m"),
    "jamba_1_5_large_398b": lambda: j_smoke("jamba_1_5_large_398b"),
    # 4 heads over 4 kv heads: the self-attention prefills (the encoder's
    # bidirectional ones too) group and take the kernel route here;
    # whisper-small's 12 heads pad to 16 over 12 and do not
    "whisper_small": lambda: j_smoke("whisper_small"),
    # 8 seeded patch embeddings in front of the tokens; 4 heads over 1
    "paligemma_3b": lambda: j_smoke("paligemma_3b"),
}


def _kernel_layers(tcfg) -> int:
    """Layers whose prefill takes the flash kernel: grouped self-attention,
    a decoder's (``xattn``'s first half) and its encoder's (MLA, SSM and
    cross-attention never do)."""
    grouped = tcfg.attn_cfg(False).grouped if tcfg.n_kv_heads else False
    attn = sum(m in ("attn", "swa", "xattn") for m, _ in tcfg.layer_types)
    return grouped * (attn + tcfg.encoder_layers)


def _extras(jcfg, batch: int):
    """The stub inputs beside the tokens, (reference's, port's): seeded
    frame embeddings [batch, enc_seq, d] for an encoder-decoder, patch
    embeddings [batch, prefix_len, d] for a VLM, else none."""
    if jcfg.encoder_layers:
        name, n = "frames", jcfg.enc_seq
    elif jcfg.prefix_len:
        name, n = "prefix_embeds", jcfg.prefix_len
    else:
        return {}, {}
    f = np.random.default_rng(11).normal(
        size=(batch, n, jcfg.d_model)).astype(np.float32)
    return {name: jnp.asarray(f)}, {name: _t(f)}


# bf16 MoE: a route the two packages choose differently must be a near tie
# of the router's probabilities (absolute); a wrong route is ~0.1 off
NEAR_TIE = 1e-2


class _SameRoutes:
    """bf16 MoE models: each reference forward records every MoE layer's
    ``top_e`` (an ordered ``jax.debug.callback``), and the
    port's next forward takes those routes, weighting them with its own
    router probabilities.  A near-tie of the router flips a route between
    any two bf16 computations, and a flipped route moves its token by
    O(1) and, through the capacity, other tokens' drops too, so logits
    are compared on the same routes.  Where the port's own choice
    differs from the route it is given, the choice must be a near tie
    (``NEAR_TIE``): ``flips`` counts those rows, ``worst_gap`` keeps the
    largest such gap."""

    def __init__(self, monkeypatch):
        self.routes, self.flips, self.worst_gap, self.calls = [], 0, 0.0, 0
        real_j, real_t = jmoe._route, tmoe._route

        def record(params, cfg, xf):
            w, e = real_j(params, cfg, xf)
            jax.debug.callback(lambda a: self.routes.append(np.array(a)), e,
                               ordered=True)
            return w, e

        def forced(params, cfg, xf):
            _, own = real_t(params, cfg, xf)
            e = torch.as_tensor(self.routes.pop(0))
            probs = torch.softmax(tl.linear(params["router"], xf).float(),
                                  dim=-1)
            for r in torch.nonzero((own.sort(-1).values
                                    != e.sort(-1).values).any(-1))[:, 0]:
                gap = float(probs[r, own[r]].sum() - probs[r, e[r]].sum())
                self.flips += 1
                self.worst_gap = max(self.worst_gap, gap)
            self.calls += 1
            w = probs.gather(-1, e)
            if cfg.router_scale:
                w = w / (w.sum(-1, keepdim=True) + 1e-9)
            return w.to(xf.dtype), e

        monkeypatch.setattr(jmoe, "_route", record)
        monkeypatch.setattr(tmoe, "_route", forced)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_model_matches_reference(name, dtype, kernel_calls,
                                       monkeypatch):
    """Logits without a cache (the prefill kernel route where the heads
    group, the window masking inside it for h2o-danube: 40 tokens >
    window 16; DeepSeek-V3's ``mtp_logits`` too), then a cached prefill
    and two shared-position decode steps (SSM layers: the chunked scan
    over 30 tokens, a tail of 6 past the chunk of 8, then the one-token
    recurrence on the cached state; whisper: the same ``frames`` to both
    packages, encoded at the prefill and read from the cache's
    ``memory`` after it; paligemma: the same ``prefix_embeds`` in front
    of the tokens, logits over prefix and tokens, the cached prefill at
    positions ``arange(P + 30)`` and the decode steps after it).  In float32 the MoE routes are the port's own;
    in bf16 they are the reference's (``_SameRoutes``).

    bf16 models with SSM layers are held against the reference compiled
    with ``xla_allow_excess_precision=False``, each bf16 cast of its source
    honoured: by default XLA fuses the SSM block's bf16 roundings away
    (float32 excess precision), and mamba2's smoke logits lie 3.04e-2 of
    the largest from the same reference with its casts honoured (op by
    op, or compiled so); the port lies 7e-4 from the latter."""
    jcfg = CONFIGS[name]()
    same = None
    if dtype == "bfloat16" and jcfg.moe is not None:
        same = _SameRoutes(monkeypatch)
    exact_casts = dtype == "bfloat16" and jcfg.ssm is not None
    jcfg, jp, jst, tcfg, tp, tst = _models(jcfg, dtype)

    def ref(fn, params, statics, *args, **kwargs):
        if exact_casts:
            call = jax.jit(lambda p, a, k: fn(p, statics, *a, **k)).lower(
                params, args, kwargs).compile(
                    compiler_options={"xla_allow_excess_precision": False})
            out = call(params, args, kwargs)
        else:
            out = fn(params, statics, *args, **kwargs)
        if same is not None:
            jax.effects_barrier()
        return out

    assert ttr.count_params(tp) == jtr.count_params(jp)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 40))
    tol = F32_REL if dtype == "float32" else BF16_REL
    jframes, tframes = _extras(jcfg, 2)
    prefix = jcfg.prefix_len if "prefix_embeds" in tframes else 0
    jlog, _, jaux = ref(jtr.apply_model, jp, jst, jnp.asarray(toks),
                        **jframes)
    tlog, _, taux = ttr.apply_model(tp, tst, _t(toks), **tframes)
    assert tlog.shape == (2, prefix + 40, jcfg.padded_vocab)
    assert tlog.dtype == getattr(torch, dtype)
    assert _rel(tlog.float().numpy(), jlog) <= tol
    assert set(taux) == set(jaux) == ({"mtp_logits"} if jcfg.mtp else set())
    if jcfg.mtp:
        assert taux["mtp_logits"].shape == tlog.shape
        assert _rel(taux["mtp_logits"].float().numpy(),
                    jaux["mtp_logits"]) <= tol
    n_kernel = _kernel_layers(tcfg)
    assert len(kernel_calls) == n_kernel
    jcache = jtr.init_cache(jst, 2, 48, dtype=jnp.float32)
    tcache = ttr.init_cache(tst, 2, 48, dtype=torch.float32)
    for start, stop in ((0, 30), (30, 31), (31, 32)):
        # a prefix sits in front of the prefill's tokens, so the
        # positions and the cache's length count it
        pos = np.arange(start + prefix * (start > 0), stop + prefix)
        extra = (jframes, tframes) if start == 0 else ({}, {})
        jlog, jcache, _ = ref(
            jtr.apply_model, jp, jst, jnp.asarray(toks[:, start:stop]),
            positions=jnp.asarray(pos), cache=jcache,
            cache_pos=jnp.int32(pos[0]), cache_len=jnp.int32(pos[-1] + 1),
            **extra[0])
        tlog, tcache, _ = ttr.apply_model(
            tp, tst, _t(toks[:, start:stop]), positions=_t(pos),
            cache=tcache, cache_pos=int(pos[0]), cache_len=int(pos[-1] + 1),
            **extra[1])
        assert tlog.shape[1] == len(pos)
        assert _rel(tlog.float().numpy(), jlog) <= tol
    assert len(kernel_calls) == 2 * n_kernel  # decode: plain route
    if same is not None:
        # four forwards through every MoE layer, the first through the
        # MTP layer's too
        n_moe = sum(f == "moe" for _, f in jcfg.layer_types)
        mtp_moe = int(jcfg.mtp and jcfg.layer_types[-1][1] == "moe")
        assert same.calls == 4 * n_moe + mtp_moe and not same.routes
        assert same.worst_gap <= NEAR_TIE, (same.flips, same.worst_gap)


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


def test_stacked_body_rows_are_the_layer_draws():
    """``init_params`` stacks the body one draw at a time: each row of a
    stacked leaf is the layer the generator drew at its turn (the draw
    order of embed, head, norms, prefix, body, MTP), so a model drawn
    from a seed keeps its weights."""
    tcfg = get_smoke_config("deepseek_v3_671b")
    params, statics = ttr.init_params(tcfg, torch.Generator().manual_seed(4),
                                      device="cpu")
    gen = torch.Generator().manual_seed(4)
    tl.embed_init(gen, tcfg.padded_vocab, tcfg.d_model)
    tl.linear_init(gen, tcfg.d_model, tcfg.padded_vocab)
    for st, p in zip(statics["prefix_layers"], params["prefix_layers"]):
        want = ttr._layer_params(gen, tcfg, st, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(ttr._leaves(p),
                                                     ttr._leaves(want)))
    for st, body in zip(statics["body"], params["body"]):
        for rep in range(statics["n_periods"]):
            want = ttr._layer_params(gen, tcfg, st, "cpu")
            got = ttr._index(body, rep)
            assert all(torch.equal(a, b) for a, b in zip(
                ttr._leaves(got), ttr._leaves(want)))
    want = ttr._layer_params(gen, tcfg, statics["mtp_layer"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        ttr._leaves(params["mtp_layer"]), ttr._leaves(want)))


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
    assert set(PORTED) == set(ARCH_NAMES)


@pytest.mark.parametrize("arch", ["mamba2_780m", "jamba_1_5_large_398b",
                                  "whisper_small", "paligemma_3b"])
def test_converted_params_match_port_init(arch):
    """``lm_params_from_numpy`` carries the SSM leaves, whisper's
    ``encoder``, ``enc_pos`` and ``enc_norm``, and paligemma's tied
    embeddings (no ``lm_head``) as they are: the converted reference tree
    has the keys, shapes and dtypes of the port's own ``init_params`` on
    the same config.  paligemma's smoke config at ``model_shards=16`` pads
    its 4 q heads to 16, as the published one pads 8: the padded heads'
    columns of ``wq`` and rows of ``wo`` arrive as the reference's zeros."""
    jcfg = j_smoke(arch)
    if arch == "paligemma_3b":
        jcfg = dataclasses.replace(jcfg, model_shards=16)
    params, _, _ = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    conv = lm_params_from_numpy(_np(params), "cpu")
    own, _ = ttr.init_params(_port_cfg(jcfg),
                             torch.Generator().manual_seed(0), device="cpu")

    def flat(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, path + (key,)).items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in flat(sub, path + (i,)).items()}
        return {path: (tuple(tree.shape), tree.dtype)}

    got, want = flat(conv), flat(own)
    assert got == want
    keys = {p[0] for p in got}
    if arch == "whisper_small":
        assert {"encoder", "enc_pos", "enc_norm", "dec_pos"} <= keys
    elif arch == "paligemma_3b":
        assert "lm_head" not in keys and "embed" in keys
        real = jcfg.n_heads * jcfg.d_head
        attn = conv["body"][0]["attn"]
        assert attn["wq"]["w"].shape[-1] == 16 * jcfg.d_head
        assert not attn["wq"]["w"][..., real:].any()
        assert not attn["wo"]["w"][:, real:].any()
        assert attn["wq"]["w"][..., :real].abs().sum() > 0
        np.testing.assert_array_equal(
            attn["wq"]["w"].numpy(),
            np.asarray(params["body"][0]["attn"]["wq"]["w"]))
    else:
        assert any(p[-1] == "A_log" for p in got)


def test_prefix_cached_prefill_and_decode_equal_cacheless():
    """paligemma's smoke model in float32: the patches and a prompt
    prefilled into a cache (``make_prefill_step`` with ``extras=
    {"prefix_embeds": ...}``), then greedy decode steps at P + S, P + S +
    1, ... through ``make_decode_step``, against one cacheless forward
    over the patches and every token: the logits at the prefill's last
    position and at each step within 1e-5 of the largest, the prefill's
    token its argmax."""
    from repro_torch.runtime.serve import (
        ServeConfig,
        decode_logits,
        make_prefill_step,
    )

    _, _, _, tcfg, tp, tst = _models(j_smoke("paligemma_3b"))
    p, n, steps = tcfg.prefix_len, 12, 4
    rng = np.random.default_rng(9)
    patches = _t(rng.normal(size=(1, p, tcfg.d_model)).astype(np.float32))
    toks = torch.zeros((1, n + steps), dtype=torch.long)
    toks[0, :n] = _t(rng.integers(1, tcfg.vocab, n))
    cache = ttr.init_cache(tst, 1, p + n + steps, dtype=torch.float32)
    first, cache = make_prefill_step(tcfg, tst, ServeConfig())(
        tp, cache, toks[:, :n], extras={"prefix_embeds": patches})
    toks[0, n] = first[0]
    got = []
    for i in range(n, n + steps):
        lg, cache = decode_logits(tst, tp, cache, toks[:, i],
                                  torch.tensor(p + i))
        got.append(lg[0])
        if i + 1 < n + steps:
            toks[0, i + 1] = lg[0].argmax()
    full, _, _ = ttr.apply_model(tp, tst, toks, prefix_embeds=patches)
    want = full[0, p + n:, :tcfg.vocab]
    assert full.shape[1] == p + n + steps
    assert int(full[0, p + n - 1, :tcfg.vocab].argmax()) == int(first[0])
    assert _rel(torch.stack(got).numpy(), want.numpy()) <= F32_REL
    assert cache["body"][0]["k"][0, 0, p + n + steps - 1].abs().sum() > 0


def test_attention_at_paligemma_width(kernel_calls):
    """One attention layer at paligemma's own attention width (d_model
    2048, 8 q heads padded to 16 over 1 kv head, D 256) in float32 on 40
    tokens: a cached prefill, which takes the flash route (on the CPU its
    plain version) at D 256, and one decode step, against the reference's
    ``attention_apply``, 1e-5 relative to the largest output (and the
    cache's keys and values to the largest of each)."""
    kw = dict(d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
              model_shards=16)
    jcfg = jatt.AttnConfig(**kw)
    assert jcfg.hq_pad == 16
    p = jatt.attention_init(jax.random.PRNGKey(7), jcfg)[0]
    tp = lm_params_from_numpy(_np(p), "cpu")
    tcfg = tatt.AttnConfig(**kw)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(1, 41, 2048)).astype(np.float32)
    jc = {k: jnp.zeros((1, 48, 1, 256)) for k in ("k", "v")}
    tc = {k: torch.zeros(1, 48, 1, 256) for k in ("k", "v")}
    for lo, hi in ((0, 40), (40, 41)):
        pos = np.arange(lo, hi)
        want, jc = jatt.attention_apply(
            p, jcfg, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos), cache=jc,
            cache_pos=jnp.int32(lo), cache_len=jnp.int32(hi))
        got, tc = tatt.attention_apply(
            tp, tcfg, _t(x[:, lo:hi]), _t(pos), cache=tc, cache_pos=lo,
            cache_len=hi)
        assert _rel(got.numpy(), want) <= F32_REL
    assert kernel_calls == [(1, 16, 40, 256)]
    # the keys in the cache: sums of 2048 products, so relative to the
    # largest, as the outputs
    for key in ("k", "v"):
        assert _rel(tc[key].numpy(), jc[key]) <= F32_REL
