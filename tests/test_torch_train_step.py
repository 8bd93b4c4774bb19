"""One training step of the port against the JAX reference (CPU).

The same weights (the reference's ``init_params``, through
``lm_params_from_numpy``) and the same seeded batch go through the
reference's jitted ``make_train_step`` and the port's, on the smoke
config of every entry of ``ARCH_NAMES`` in float32, whisper with the
same ``frames`` and paligemma with the same ``prefix_embeds`` through
``model_kwargs_fn``:

  * ``cross_entropy`` within 1e-6 relative (float32 and bf16 logits over
    granite's padded vocabulary);
  * with ``sgd``, whose first update is ``lr * g``: ``loss`` and
    ``grad_norm`` within 1e-5 relative, and the (clipped) gradients
    recovered from the update within 1e-4 of each leaf's largest |g|;
  * with AdamW, for granite at microbatches 1 and 2, each with and
    without int8 gradient compression, for DeepSeek-V3 (the MTP loss)
    and paligemma (the suffix scored), and for jamba and DeepSeek-V2 at
    microbatches 2 (MoE capacity counted over each microbatch, whose
    seeded routes drop pairs; the grad norm within 1e-5 relative too):
    ``loss`` within 1e-5 relative and the updated params within
    ``0.05 * lr``, the reference's own bound
    (``tests/test_train.py::test_microbatching_matches_full_batch``):
    Adam's first step moves a weight by about ``lr`` whatever its
    gradient, so a gradient near the float32 noise floor moves it by a
    noise-directed fraction of ``lr``.  Such weights, and with compression
    those whose int8 rounding meets a tie, may lie farther, at most one
    in 10^3 (``_adamw_case``): DeepSeek-V3's one of 8,192 in
    ``prefix_layers/1/mlp/gate`` lies 5.8 % of ``lr`` off, its gradient
    1.5e-8, at Adam's eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as jtr
from repro.optim import adamw as j_adamw
from repro.optim import sgd as j_sgd
from repro.runtime import train as jtrain

from repro_torch.checkpoint.checkpointer import _leaf_paths
from repro_torch.configs import ARCH_NAMES
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.optim import adamw, sgd
from repro_torch.runtime import train as ttrain
from test_torch_lm import _port_cfg

REL = 1e-5
SGD_LR = 1e3  # p0 - p1 = lr * g: large, so p0's rounding does not show
ADAM_LR = 1e-2
NOISE_FLOOR = 1e-5  # of a leaf's largest |g|: Adam's direction is noise
TIE = 1e-3  # of an int8 step from a rounding tie
MAX_ILL = 1e-3  # share of weights that may lie off for either reason


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _setup(arch, rows=2, seq=17):
    """(jcfg, reference params, statics, port cfg, params, statics, batch
    as numpy, model_kwargs_fn)."""
    jcfg = j_smoke(arch)
    params, _, jst = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = _port_cfg(jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    batch = {"tokens": np.random.default_rng(5).integers(
        0, jcfg.vocab, (rows, seq)).astype(np.int32)}
    kw = None
    extra = ("frames", jcfg.enc_seq) if jcfg.encoder_layers else (
        ("prefix_embeds", jcfg.prefix_len) if jcfg.prefix_len else None)
    if extra is not None:
        name, n = extra
        batch[name] = np.random.default_rng(11).normal(
            size=(rows, n, jcfg.d_model)).astype(np.float32)
        kw = lambda b, name=name: {name: b[name]}  # noqa: E731
    return (jcfg, params, jst, tcfg, tp, ttr.init_statics(tcfg, "cpu"),
            batch, kw)


def _steps(arch, j_opt, t_opt, lr, rows=2, **tkw):
    """One step of each package from the same state and batch:
    (reference params before, reference (state, metrics), port params
    before, port (state, metrics))."""
    jcfg, jp, jst, tcfg, tp, tst, batch, kw = _setup(arch, rows)
    return (jp, _reference_step(jcfg, jp, jst, batch, kw, j_opt, lr, **tkw),
            tp, _port_step(tcfg, tp, tst, batch, kw, t_opt, lr, **tkw))


def _reference_step(jcfg, jp, jst, batch, kw, opt, lr, **tkw):
    tc = jtrain.TrainConfig(steps=1, **tkw)
    step = jax.jit(jtrain.make_train_step(jcfg, jst, opt, lambda s: lr, tc,
                                          kw))
    return step(jtrain.init_train_state(jp, opt, tc),
                {k: jnp.asarray(v) for k, v in batch.items()})


def _port_step(tcfg, tp, tst, batch, kw, opt, lr, **tkw):
    tc = ttrain.TrainConfig(steps=1, **tkw)
    step = ttrain.make_train_step(tcfg, tst, opt, lambda s: lr, tc, kw)
    return step(ttrain.init_train_state(tp, opt, tc),
                {k: torch.as_tensor(v) for k, v in batch.items()})


def _by_key(jtree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    """Granite's 515 tokens padded to 768 columns: the padding carries no
    probability in either package, whatever its logits."""
    cfg = j_smoke("granite_3_2b")
    width = _port_cfg(cfg).padded_vocab
    assert width > cfg.vocab
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 9, width)) * 4).astype(np.float32)
    logits[..., cfg.vocab:] += 50.0  # padding columns would dominate
    labels = rng.integers(0, cfg.vocab, (3, 9)).astype(np.int32)
    want = jtrain.cross_entropy(jnp.asarray(logits).astype(dtype),
                                jnp.asarray(labels), cfg.vocab)
    got = ttrain.cross_entropy(torch.as_tensor(logits).to(
        getattr(torch, dtype)), torch.as_tensor(labels), cfg.vocab)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_one_sgd_step_matches_reference(arch):
    jp, (jstate, jm), tp, (tstate, tm) = _steps(arch, j_sgd(), sgd(), SGD_LR)
    assert _rel(tm["loss"], jm["loss"]) <= REL
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= REL
    assert int(tstate["step"]) == 1 and tstate["step"].dtype == torch.int32
    j0, j1 = _by_key(jp), _by_key(jstate["params"])
    t0, t1 = dict(_leaf_paths(tp)), dict(_leaf_paths(tstate["params"]))
    assert set(t1) == set(j1)
    worst = {}
    for key, p0 in j0.items():
        g_ref = (p0 - j1[key]) / SGD_LR
        g_port = ((t0[key] - t1[key]) / SGD_LR).numpy()
        top = float(np.abs(g_ref).max())
        if top > 0:
            worst[key] = float(np.abs(g_port - g_ref).max()) / top
        else:
            assert np.abs(g_port).max() == 0, key
    assert max(worst.values()) <= 1e-4, max(worst.items(), key=lambda kv: kv[1])


def _adamw_case(arch, rows=4, **tkw):
    """AdamW's first step moves a weight by ``lr * g / (|g| + eps)``.
    Within ``0.05 * lr`` of the reference wherever that is well posed.  A
    weight may lie farther only where the direction is not: its reference
    gradient (recovered from an SGD step, clipped as AdamW's is) below
    ``NOISE_FLOOR`` of its leaf's largest |g|, near Adam's eps, or, with
    compression, ``g / scale`` within ``TIE`` of a half-integer, where
    the int8 rounding of two float32 gradients equal but for their last
    bits may go either way; and at most ``MAX_ILL`` of all weights."""
    jcfg, jp, jst, tcfg, tp, tst, batch, kw = _setup(arch, rows)
    jstate, jm = _reference_step(jcfg, jp, jst, batch, kw,
                                 j_adamw(weight_decay=0.0), ADAM_LR, **tkw)
    tstate, tm = _port_step(tcfg, tp, tst, batch, kw,
                            adamw(weight_decay=0.0), ADAM_LR, **tkw)
    assert _rel(tm["loss"], jm["loss"]) <= REL
    sgd_tkw = {k: v for k, v in tkw.items() if k != "grad_compression"}
    gstate, _ = _reference_step(jcfg, jp, jst, batch, kw, j_sgd(), SGD_LR,
                                **sgd_tkw)
    p0, p1 = _by_key(jp), _by_key(gstate["params"])
    j1 = _by_key(jstate["params"])
    ill, total = 0, 0
    for key, t in _leaf_paths(tstate["params"]):
        off = np.abs(t.numpy() - j1[key]) >= 0.05 * ADAM_LR
        total += off.size
        if not off.any():
            continue
        g = (p0[key] - p1[key]) / SGD_LR
        top = np.abs(g).max()
        posed = np.abs(g) >= NOISE_FLOOR * top
        if tkw.get("grad_compression"):
            frac = np.abs(g / ((top + 1e-12) / 127.0)) % 1.0
            posed &= np.abs(frac - 0.5) >= TIE
        assert not (off & posed).any(), key
        ill += int(off.sum())
    assert ill <= MAX_ILL * total
    assert int(tstate["opt_state"]["count"]) == 1
    if tkw.get("grad_compression"):
        jr = _by_key(jstate["comp_state"])
        for key, r in _leaf_paths(tstate["comp_state"]):
            assert r.dtype == torch.float32 and r.shape == jr[key].shape
    return tm, jm


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_adamw_step_granite_matches_reference(microbatches, compression):
    _adamw_case("granite_3_2b", microbatches=microbatches,
                grad_compression=compression)


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "paligemma_3b"])
def test_adamw_step_mtp_and_suffix_match_reference(arch):
    """DeepSeek-V3 adds its MTP loss on ``roll(labels, -1)``; paligemma
    scores the suffix after its 8 patches."""
    _adamw_case(arch)


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b",
                                  "deepseek_v2_236b"])
def test_adamw_step_moe_microbatches_match_reference(arch, monkeypatch):
    """Two microbatches of 2 rows: the reference cuts microbatch j from
    rows ``[2 j, 2 j + 2)`` and counts MoE capacity over it alone; so
    does the port, and the seeded routes of each microbatch drop pairs
    in some MoE layer, so a capacity counted over other rows would
    show."""
    from repro_torch.models import moe as tmoe

    tm, jm = _adamw_case(arch, microbatches=2)
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= REL
    _, _, _, tcfg, tp, tst, batch, kw = _setup(arch, 4)
    drops = []
    real = tmoe._route

    def spy(p, c, xf):
        out = real(p, c, xf)
        drops.append(int((~tmoe.kept_pairs(out[1], c)).sum()))
        return out

    monkeypatch.setattr(tmoe, "_route", spy)
    tokens = torch.as_tensor(batch["tokens"])[:, :-1]
    with torch.no_grad():
        for j in (0, 1):
            drops.clear()
            ttr.apply_model(tp, tst, tokens[2 * j:2 * j + 2], kernels=False)
            assert sum(drops) > 0, (j, drops)
