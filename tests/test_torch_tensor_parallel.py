"""Tensor-parallel compute in the port's sharded train step (CPU).

``parallel.tensor`` splits attention heads, the dense MLP's ``ff``, the
sparse MLP's tiles and MoE experts over the mesh's ``model`` dim inside
the sharded step; the reference's GSPMD step splits the same matmuls.
On spawned ``gloo`` ranks (``tests/torch_mesh_worker.py``'s ``tp_mlp``
and ``tp_train`` jobs, one spawn per mesh shape for every model):

  * the three autograd Functions give a whole dense and sparse MLP's
    output and gradients within 1e-6 of their largest value on two
    ranks;
  * two AdamW steps on ``(data, model)`` meshes of 1 x 2 and 2 x 2 for
    granite (dense), a pattern-sparse h2o-danube (GQA, sliding window,
    a dictionary group the rank boundary cuts), qwen2.5 (qkv bias),
    whisper (the encoder and cross-attention), jamba (experts, the SSM
    gathered) and DeepSeek-V2 (experts, MLA gathered), and granite with
    int8 gradient compression: the loss and the gradient norm within rel
    1e-4 of the port's unsharded step (itself held to the reference's by
    ``tests/test_torch_train_step.py``), the params by that file's rule
    (within 0.05 lr where the step-1 gradient is well posed, at most
    ``MAX_ILL`` of all weights off);
  * the step all-gathers exactly the leaves that are not computed on their
    slabs, and the bytes it reports are theirs.

MoE capacity in the sharded step is the whole batch's, as the
reference's step counts it, so the 2 x 2 mesh's MoE models drop the
pairs the unsharded step drops (the seeded routes here drop some).
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.layers import PatternSparseConfig, mlp_apply, mlp_init
from repro_torch.optim import adamw, sgd
from repro_torch.optim.optimizers import _leaves, _map
from repro_torch.parallel import tensor
from repro_torch.parallel.sharding import Placement, cut_slab
from repro_torch.runtime import train as ttrain
from test_torch_sharded import _run_ranks
from test_torch_train_step import ADAM_LR, MAX_ILL, NOISE_FLOOR, SGD_LR, TIE

REL = 1e-4
FN_TOL = 1e-6
STEPS = 2
TOKENS = (8, 17)
MESHES = ((1, 2), (2, 2))


def _sparse_danube():
    return dataclasses.replace(
        get_smoke_config("h2o_danube_1_8b"), d_ff=384, model_shards=4,
        sparse=PatternSparseConfig(density=0.5, num_patterns=3, block=32,
                                   tile=32))


MODELS = {
    "granite": lambda: get_smoke_config("granite_3_2b"),
    "danube_sparse": _sparse_danube,
    "qwen": lambda: get_smoke_config("qwen2_5_32b"),
    "whisper": lambda: get_smoke_config("whisper_small"),
    "jamba": lambda: get_smoke_config("jamba_1_5_large_398b"),
    "deepseek_v2": lambda: get_smoke_config("deepseek_v2_236b"),
}
# (case, model, TrainConfig fields)
CASES = [(name, name, {}) for name in MODELS] + [
    ("granite_compression", "granite", {"grad_compression": True})]
COMPRESSED = {case for case, _, tkw in CASES if tkw.get("grad_compression")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return _map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def models():
    """name -> (cfg, numpy params drawn from seed 0, batch)."""
    out = {}
    for i, (name, make) in enumerate(MODELS.items()):
        cfg = make()
        params, _ = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        batch = {"tokens": np.random.default_rng(3 + i).integers(
            0, cfg.vocab, TOKENS).astype(np.int64)}
        if cfg.encoder_layers:
            batch["frames"] = np.random.default_rng(11).normal(
                size=(TOKENS[0], cfg.enc_seq, cfg.d_model)).astype(
                np.float32)
        out[name] = (cfg, _numpy(params), batch)
    return out


def _kwargs(batch):
    return {k: batch[k] for k in ("frames",) if k in batch}


@pytest.fixture(scope="module")
def unsharded(models):
    """case -> (per step (loss, grad_norm, params) of the port's
    one-device AdamW step, and the step-1 gradient recovered from an SGD
    step)."""
    out = {}
    for case, name, tkw in CASES:
        cfg, nparams, batch = models[name]
        statics = ttr.init_statics(cfg, "cpu")
        put = {k: torch.as_tensor(v) for k, v in batch.items()}
        opt = adamw(weight_decay=0.0)
        tc = ttrain.TrainConfig(steps=STEPS, **tkw)
        step = ttrain.make_train_step(cfg, statics, opt, lambda s: ADAM_LR,
                                      tc, model_kwargs_fn=_kwargs)
        state = ttrain.init_train_state(lm_params_from_numpy(nparams, "cpu"),
                                        opt, tc)
        rows = []
        for _ in range(STEPS):
            state, m = step(state, put)
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         dict(_paths(_numpy(state["params"])))))
        tc1 = ttrain.TrainConfig(steps=1)
        sstep = ttrain.make_train_step(cfg, statics, sgd(), lambda s: SGD_LR,
                                       tc1, model_kwargs_fn=_kwargs)
        p0 = lm_params_from_numpy(nparams, "cpu")
        p1, _ = sstep(ttrain.init_train_state(p0, sgd(), tc1), put)
        grads = _map(lambda a, b: ((a - b) / SGD_LR).numpy(), p0,
                     p1["params"])
        out[case] = (rows, dict(_paths(grads)))
    return out


def _paths(tree, prefix=""):
    """(checkpoint-style key, leaf) pairs of a dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in items
            for kv in _paths(v, f"{prefix}/{k}" if prefix else str(k))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, models):
    """mesh -> per rank, case -> the ``tp_train`` job's results."""
    out = {}
    for mesh in MESHES:
        cases = [(case, models[name][0], models[name][1], models[name][2],
                  tkw) for case, name, tkw in CASES]
        tmp = tmp_path_factory.mktemp(f"tp{mesh[0]}x{mesh[1]}")
        ranks = _run_ranks(tmp, mesh[0] * mesh[1], [{
            "name": "tp", "kind": "tp_train", "mesh": mesh, "steps": STEPS,
            "lr": ADAM_LR, "cases": cases}])
        out[mesh] = [r["tp"] for r in ranks]
    return out


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


GRID = [(mesh, case) for mesh in MESHES for case, _, _ in CASES]
IDS = [f"{m[0]}x{m[1]}-{c}" for m, c in GRID]


@pytest.mark.parametrize("mesh,case", GRID, ids=IDS)
def test_losses_match_unsharded_step(mesh, case, unsharded, worlds):
    ranks = [r[case] for r in worlds[mesh]]
    want, _ = unsharded[case]
    for i, (loss, gnorm, _) in enumerate(want):
        got = [r["steps"][i]["metrics"] for r in ranks]
        assert all(g == got[0] for g in got), (i, got)
        assert _rel(got[0]["loss"], loss) <= REL, (i, got[0], loss)
        assert _rel(got[0]["grad_norm"], gnorm) <= REL, (i, got[0], gnorm)


@pytest.mark.parametrize("mesh,case", GRID, ids=IDS)
def test_params_follow_unsharded_step(mesh, case, unsharded, worlds):
    """After step 1, off by >= 0.05 lr only where the gradient is ill
    posed (below ``NOISE_FLOOR`` of its leaf's largest or, compressed, at
    an int8 rounding tie); after each step at most ``MAX_ILL`` off."""
    want, grads = unsharded[case]
    compressed = case in COMPRESSED
    for i, (_, _, params) in enumerate(want):
        got = worlds[mesh][0][case]["steps"][i]["params"]
        ill, total = 0, 0
        for key, w in params.items():
            have = got[key]
            assert have.shape == w.shape and have.dtype == w.dtype, key
            off = np.abs(have - w) >= 0.05 * ADAM_LR
            total += off.size
            if not off.any():
                continue
            ill += int(off.sum())
            if i > 0:
                continue
            g = grads[key]
            top = np.abs(g).max()
            posed = np.abs(g) >= NOISE_FLOOR * top
            if compressed:
                frac = np.abs(g / ((top + 1e-12) / 127.0)) % 1.0
                posed &= np.abs(frac - 0.5) >= TIE
            assert not (off & posed).any(), (i, key)
        assert ill <= MAX_ILL * total, (i, ill, total)


@pytest.mark.parametrize("mesh,case", GRID, ids=IDS)
def test_slab_leaves_are_never_gathered(mesh, case, worlds):
    """Each step all-gathers over the mesh exactly the split leaves not
    computed on their slabs (the compression residuals' too), never a
    slab leaf; ``step.comm`` counts their whole bytes, and the
    activations' all-reduces over ``model``."""
    times = 2 if case in COMPRESSED else 1
    for r in worlds[mesh]:
        res = r[case]
        assert res["slab_leaves"] > 0
        for row in res["steps"]:
            assert not set(row["gathered"]) & set(res["slab_ids"])
            assert sorted(row["gathered"]) == sorted(
                res["gathered_ids"] * times)
            assert row["comm"]["param_gather_bytes"] == res["gathered_bytes"]
            assert row["comm"]["model_reduce_bytes"] > 0


def _mlp_cases():
    """(name, (d_model, d_ff, act, sparse, model_shards), numpy params, x,
    dy): a dense SwiGLU MLP and a pattern-sparse one whose dictionary
    group [3, 9) straddles the two ranks' tiles [0, 6) and [6, 12)."""
    out = []
    rng = np.random.default_rng(5)
    for name, geo in (("dense", (32, 64, "swiglu", None, 1)),
                      ("sparse", (128, 384, "swiglu", PatternSparseConfig(
                          density=0.5, num_patterns=3, block=32, tile=32),
                          4))):
        d, ff, act, sparse, shards = geo
        params, static = mlp_init(torch.Generator().manual_seed(1), d, ff,
                                  act, sparse, shards, device="cpu")
        if sparse is not None:
            assert static["up"]["groups"][1]["tiles"] == (3, 9)
        x = rng.normal(size=(3, 5, d)).astype(np.float32)
        dy = rng.normal(size=(3, 5, d)).astype(np.float32)
        out.append((name, geo, _numpy(params), x, dy))
    return out


@pytest.fixture(scope="module")
def mlp_world(tmp_path_factory):
    cases = _mlp_cases()
    ranks = _run_ranks(tmp_path_factory.mktemp("tp_mlp"), 2, [{
        "name": "mlp", "kind": "tp_mlp", "mesh": (1, 2), "cases": cases}])
    return cases, [r["mlp"] for r in ranks]


def _close(got, want, what):
    """Within ``FN_TOL`` of the largest |value| of ``want`` (float32
    sums in another order: a straddled group's product is a narrower
    matmul)."""
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= FN_TOL * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("which", ["dense", "sparse"])
def test_functions_give_the_whole_mlp(which, mlp_world):
    """copy_to_model, reduce_from_model (dense) and gather_from_model
    (sparse) on two ranks: the output and the input's gradient of the
    whole MLP, and each rank's slab of its weights' gradients."""
    from repro_torch.models.layers import mlp_static

    cases, ranks = mlp_world
    name, (d, ff, act, sparse, shards), params, x, dy = next(
        c for c in cases if c[0] == which)
    static = mlp_static(d, ff, act, sparse, shards, device="cpu")
    live = _map(lambda a: torch.tensor(a, requires_grad=True), params)
    xt = torch.tensor(x, requires_grad=True)
    y = mlp_apply(live, static, xt, kernels=False)
    (y * torch.as_tensor(dy)).sum().backward()
    for r, got in enumerate(ranks):
        got = got[which]
        _close(got["y"], y.detach().numpy(), "y")
        _close(got["dx"], xt.grad.numpy(), "dx")
        for key, g in _paths(_map(lambda t: t.grad.numpy(), live)):
            slab = dict(_paths(got["grads"]))[key]
            # up/gate split their columns (or tiles), down its rows (or
            # tiles): the slab along the first dim that differs
            dim = next(i for i, (a, b) in enumerate(zip(slab.shape, g.shape))
                       if a != b)
            n = slab.shape[dim]
            want = np.take(g, range(r * n, (r + 1) * n), axis=dim)
            _close(slab, want, key)
        moved = "reduce_bytes" if which == "dense" else "gather_bytes"
        assert got[moved] > 0


@pytest.mark.parametrize("arch,n,blocks", [
    # GQA heads and dense MLPs split over 2; 4 q heads over 4 too
    ("granite_3_2b", 2, {"attn", "mlp"}),
    ("granite_3_2b", 4, {"mlp"}),
    # MLA stays gathered, the experts split
    ("deepseek_v2_236b", 2, {"mlp", "moe"}),
    # whisper's self- and cross-attention
    ("whisper_small", 2, {"attn", "xattn", "mlp"}),
    ("granite_3_2b", 1, set()),
])
def test_layer_splits_follow_the_configs(arch, n, blocks):
    cfg = get_smoke_config(arch)
    statics = ttr.init_statics(cfg, "cpu")
    got = set().union(*(tensor.layer_splits(cfg, st, n) for st in
                        statics["prefix_layers"] + statics["body"]))
    assert got == blocks


def test_full_configs_split_where_the_heads_divide():
    """paligemma's 8 query heads pad to 16 over 1 key head: its attention
    stays gathered over 2 ranks; jamba's 64 over 8 split, its SSM and
    routed experts as the config gives them."""
    pali, jamba = get_config("paligemma_3b"), get_config(
        "jamba_1_5_large_398b")
    assert not tensor.attention_splits(pali.attn_cfg(False), 2)
    assert tensor.attention_splits(jamba.attn_cfg(False), 2)
    assert tensor.experts_split(jamba.moe, 2)
    assert not tensor.experts_split(jamba.moe, 3)


def test_slab_leaves_mark_whole_blocks():
    """jamba's smoke config over 2 ranks: every leaf of its attention
    layer, its dense MLPs and its routed experts on the slab; the router,
    the SSM, the norms, the embedding and the head gathered."""
    cfg = get_smoke_config("jamba_1_5_large_398b")
    statics = ttr.init_statics(cfg, "cpu")
    slab = dict(_paths(tensor.slab_leaves(cfg, statics, ttr.init_specs(cfg),
                                          2)))
    kinds = set()
    for key, on in slab.items():
        parts = key.split("/")
        want = False
        if parts[0] in ("prefix_layers", "body"):
            st = statics[parts[0]][int(parts[1])]
            want = ((parts[2] == "attn" and st["mixer"] == "attn")
                    or parts[2] == "mlp"
                    or parts[2:4] == ["moe", "experts"])
            if want:
                kinds.add(parts[2])
        assert on == want, key
    assert kinds == {"attn", "mlp", "moe"}


def test_whole_batch_capacity_in_row_blocks():
    """Dispatched as two row blocks with the earlier block's counts, each
    block's MoE output equals its rows of the whole batch's dispatch,
    drops included: the capacity and the queues are the whole batch's."""
    cfg = tmoe.MoEConfig(d_model=16, n_experts=4, top_k=2, d_ff_expert=8,
                         capacity_factor=1.0, model_shards=1)
    params, _ = tmoe.moe_init(torch.Generator().manual_seed(2), cfg)
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(40, 16)).astype(np.float32))
    top_w, top_e = tmoe._route(params, cfg, x)
    assert not tmoe.kept_pairs(top_e, cfg).all()  # some pairs drop
    whole = tmoe._dispatch_compute_combine(x, top_w, top_e,
                                           params["experts"], cfg, 0)
    counts = torch.bincount(top_e[:24].reshape(-1), minlength=4)
    for rows, before in ((slice(0, 24), torch.zeros_like(counts)),
                         (slice(24, 40), counts)):
        part = tmoe._dispatch_compute_combine(
            x[rows], top_w[rows], top_e[rows], params["experts"], cfg, 0,
            (before, 40))
        np.testing.assert_allclose(part.numpy(), whole[rows].numpy(),
                                   rtol=0, atol=1e-6)


def test_cut_slab_cuts_the_moment_slab_of_a_param_slab():
    full = torch.arange(48.0).reshape(4, 12)
    pl = Placement((4, 12), (None, "model"), (1, 2), (0, 1))
    sub = Placement((4, 12), ("data", "model"), (2, 2), (1, 1))
    slab = full[pl.slices]
    assert torch.equal(cut_slab(slab, pl, sub), full[sub.slices])
    assert cut_slab(slab, pl, pl) is slab
    with pytest.raises(ValueError):
        cut_slab(slab, pl, Placement((4, 12), (None, "model"), (1, 2),
                                     (0, 0)))


def test_outside_the_context_nothing_reads_it():
    assert tensor.current() is None
    assert [leaf for leaf in _leaves(tensor.slab_leaves(
        get_smoke_config("granite_3_2b"),
        ttr.init_statics(get_smoke_config("granite_3_2b"), "cpu"),
        ttr.init_specs(get_smoke_config("granite_3_2b")), 1)) if leaf] == []
