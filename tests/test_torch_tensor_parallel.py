"""Tensor-parallel compute in the port's sharded train step (CPU).

``parallel.tensor`` splits attention heads, MLA's heads, the SSM's heads,
the dense MLP's ``ff``, the sparse MLP's tiles, MoE experts and shared
experts, and the vocabulary of the embedding and the head over the
mesh's ``model`` dim inside the sharded step; the reference's GSPMD step
splits the same matmuls.  On spawned ``gloo`` ranks
(``tests/torch_mesh_worker.py``'s ``tp_mlp``, ``tp_blocks`` and
``tp_train`` jobs, one spawn per mesh shape for every model):

  * the autograd Functions give a whole dense and sparse MLP's, the
    vocabulary-split lookup, head and cross-entropy's (padding columns
    on one rank's slab), the SSM's (its columns re-laid out; one group
    and two), paligemma's attention's (4 query heads over 1 key head,
    re-laid out to each rank) and MLA's output and gradients within 1e-6
    of their largest value on two ranks;
  * two AdamW steps on ``(data, model)`` meshes of 1 x 2 and 2 x 2 for
    granite (dense, tied vocabulary with padding), a pattern-sparse
    h2o-danube (GQA, sliding window, a dictionary group the rank boundary
    cuts), qwen2.5 (qkv bias), whisper (the encoder and
    cross-attention), jamba (experts, the SSM), DeepSeek-V2 (experts,
    shared experts, MLA), mamba2 (the SSM, tied vocabulary), DeepSeek-V3
    (MLA, MoE, the MTP head through the split head) and paligemma (the
    prefix, tied vocabulary, suffix scoring), granite with int8 gradient
    compression, and jamba and DeepSeek-V2 with 2 microbatches: the loss
    and the gradient norm within rel 1e-4 of the port's unsharded run
    (itself held to the reference's by ``tests/test_torch_train_step.py``,
    the microbatched MoE steps too; the norm after step 1 but for
    ``OFF_TRAJECTORY``) and of its step from the same params (the MoE
    models' on 2 x 2 at twice the microbatches, below),
    the params by that file's rule (within 0.05 lr where the step-1 gradient
    is well posed, at most ``MAX_ILL`` of all weights off);
  * the step all-gathers exactly the leaves that are not computed on their
    slabs, none in these models, and the bytes it reports are theirs;
    it all-reduces and re-lays out over ``model`` the bytes
    ``tensor.model_bytes`` reckons from the shapes, the forward's again
    under remat (but each recompute's trailing all-reduce);
  * granite, jamba, DeepSeek-V2 and whisper also run with ``remat=False``
    in the same spawn: losses, gradient norms and params bit-equal to
    the default remat run's.

MoE capacity in the sharded step is each data block's own, as the
reference's sharded step counts it under its mesh (``_moe_shard_map``;
``tests/test_torch_moe_blocks.py`` holds the reference to it): with ``n``
microbatches on ``data`` = 2 its function is the unsharded step's at
``2 n`` microbatches (the same blocks of rows, each counted alone, the
loss their mean), to which the 2 x 2 mesh's MoE cases are held
(``_oracle``).  The seeded routes drop other pairs per block than over
the step's microbatches (``test_microbatch_cases_drop_other_pairs_per_rank``),
so the whole-batch count would fail those cases.
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
    "mamba2": lambda: get_smoke_config("mamba2_780m"),
    "deepseek_v3": lambda: get_smoke_config("deepseek_v3_671b"),
    "paligemma": lambda: get_smoke_config("paligemma_3b"),
    # 6 query heads over 3 key heads: grouped, but the key heads do not
    # split over 2 ranks, so each rank's 3 query heads read 2 of them,
    # re-laid out from the 30-column storage slabs (half a head each)
    "phi3": lambda: get_smoke_config("phi3_medium_14b"),
    # padded to 8 query heads over 3 key heads: ungrouped (8 % 3 != 0),
    # the padded heads' zero weights computed and stepped
    "phi3_ungrouped": lambda: dataclasses.replace(
        get_smoke_config("phi3_medium_14b"), model_shards=4),
    # 15 positions: the stream stays whole on every rank
    "granite_odd": lambda: get_smoke_config("granite_3_2b"),
}
# a model's batch of other than ``TOKENS``' shape
BATCH = {"granite_odd": (TOKENS[0], 16)}
# the MoE models' microbatches: each a block of rows, whose capacity
# drops the reference's step counts over that block alone
MICROBATCHED = ("jamba", "deepseek_v2")
# models whose MoE capacity couples rows: on a mesh with data > 1 each
# data block is counted alone
MOE = ("jamba", "deepseek_v2", "deepseek_v3")
# (case, model, TrainConfig fields)
CASES = [(name, name, {}) for name in MODELS] + [
    ("granite_compression", "granite", {"grad_compression": True})] + [
    (f"{name}_microbatches", name, {"microbatches": 2})
    for name in MICROBATCHED]
COMPRESSED = {case for case, _, tkw in CASES if tkw.get("grad_compression")}
# models the grid also runs with ``remat=False``, beside the default, in
# the same spawn (test_remat_is_bit_equal_on_the_grid)
NO_REMAT = ("granite", "jamba", "deepseek_v2", "whisper")


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
            0, cfg.vocab, BATCH.get(name, TOKENS)).astype(np.int64)}
        if cfg.encoder_layers:
            batch["frames"] = np.random.default_rng(11).normal(
                size=(TOKENS[0], cfg.enc_seq, cfg.d_model)).astype(
                np.float32)
        if cfg.prefix_len:
            batch["prefix_embeds"] = np.random.default_rng(13).normal(
                size=(TOKENS[0], cfg.prefix_len, cfg.d_model)).astype(
                np.float32)
        out[name] = (cfg, _numpy(params), batch)
    return out


def _kwargs(batch):
    return {k: batch[k] for k in ("frames", "prefix_embeds") if k in batch}


def _seq(models, name) -> int:
    """The input positions of ``name``'s batch (its tokens less one)."""
    return models[name][2]["tokens"].shape[1] - 1


def _oracle(mesh, case) -> int:
    """The microbatches of the unsharded step that ``case``'s sharded
    step on ``mesh`` computes: its own, times the data blocks where MoE
    counts capacity on each block alone."""
    name, tkw = next((n, t) for c, n, t in CASES if c == case)
    return tkw.get("microbatches", 1) * (mesh[0] if name in MOE else 1)


@pytest.fixture(scope="module")
def unsharded(models):
    """(case, microbatches) -> (per step (loss, grad_norm, params) of the
    port's one-device AdamW step, and the step-1 gradient recovered from
    an SGD step), at each case's ``_oracle`` microbatches."""
    out = {}
    runs = [(case, name, tkw, nmb) for case, name, tkw in CASES
            for nmb in sorted({_oracle(mesh, case) for mesh in MESHES})]
    for case, name, tkw, nmb in runs:
        cfg, nparams, batch = models[name]
        statics = ttr.init_statics(cfg, "cpu")
        put = {k: torch.as_tensor(v) for k, v in batch.items()}
        opt = adamw(weight_decay=0.0)
        tc = ttrain.TrainConfig(steps=STEPS, **{**tkw,
                                                "microbatches": nmb})
        step = ttrain.make_train_step(cfg, statics, opt, lambda s: ADAM_LR,
                                      tc, model_kwargs_fn=_kwargs)
        state = ttrain.init_train_state(lm_params_from_numpy(nparams, "cpu"),
                                        opt, tc)
        rows = []
        for _ in range(STEPS):
            state, m = step(state, put)
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         dict(_paths(_numpy(state["params"])))))
        tc1 = ttrain.TrainConfig(steps=1, microbatches=nmb)
        sstep = ttrain.make_train_step(cfg, statics, sgd(), lambda s: SGD_LR,
                                       tc1, model_kwargs_fn=_kwargs)
        p0 = lm_params_from_numpy(nparams, "cpu")
        p1, _ = sstep(ttrain.init_train_state(p0, sgd(), tc1), put)
        grads = _map(lambda a, b: ((a - b) / SGD_LR).numpy(), p0,
                     p1["params"])
        out[case, nmb] = (rows, dict(_paths(grads)))
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
        cases += [(f"{name}_no_remat", dataclasses.replace(
            models[name][0], remat=False), *models[name][1:], {})
            for name in NO_REMAT]
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


def _step_from(models, case, params, microbatches: int):
    """(loss, grad_norm) of the port's one-device AdamW step of ``case``
    at ``microbatches`` from ``params`` (checkpoint key -> numpy);
    neither reads the optimizer's state."""
    name, tkw = next((n, t) for c, n, t in CASES if c == case)
    cfg, nparams, batch = models[name]
    tree = lm_params_from_numpy(nparams, "cpu")
    for key, leaf in _paths(tree):
        leaf.copy_(torch.as_tensor(params[key]))
    opt = adamw(weight_decay=0.0)
    tc = ttrain.TrainConfig(steps=1, **{**tkw,
                                        "microbatches": microbatches})
    step = ttrain.make_train_step(cfg, ttr.init_statics(cfg, "cpu"), opt,
                                  lambda s: ADAM_LR, tc,
                                  model_kwargs_fn=_kwargs)
    _, m = step(ttrain.init_train_state(tree, opt, tc),
                {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"])


# (model, microbatches) of the unsharded runs whose step-2 gradient norm
# a sharded step that computes right lies off by more than REL: jamba's
# run at 2 microbatches (the oracle of jamba_microbatches on 1 x 2 and of
# jamba on 2 x 2), whose step 1 moves weights whose gradients lie below
# 7e-7 of their leaves' largest (the SSM's in_proj and out_proj, an
# expert's gate) 0.08-0.29 lr away from the run's, as
# test_params_follow_unsharded_step allows; the sharded step-2 norm then
# lies 4.9e-4 off the run's on both meshes, and 7.9e-7 (1 x 2) and
# 4.6e-7 (2 x 2) off the unsharded step from the same params.
OFF_TRAJECTORY = {("jamba", 2)}


@pytest.mark.parametrize("mesh,case", GRID, ids=IDS)
def test_losses_match_unsharded_step(mesh, case, unsharded, worlds, models):
    """Each step's loss and gradient norm within ``REL`` of the unsharded
    run's at ``_oracle`` microbatches (the norm after step 1 not for
    ``OFF_TRAJECTORY``), and after step 1 both within ``REL`` of that
    unsharded step from the params the sharded run reached."""
    ranks = [r[case] for r in worlds[mesh]]
    name = next(n for c, n, _ in CASES if c == case)
    nmb = _oracle(mesh, case)
    want, _ = unsharded[case, nmb]
    for i, (loss, gnorm, _) in enumerate(want):
        got = [r["steps"][i]["metrics"] for r in ranks]
        assert all(g == got[0] for g in got), (i, got)
        assert _rel(got[0]["loss"], loss) <= REL, (i, got[0], loss)
        if i == 0 or (name, nmb) not in OFF_TRAJECTORY:
            assert _rel(got[0]["grad_norm"], gnorm) <= REL, (i, got[0],
                                                             gnorm)
        if i > 0:
            same = _step_from(
                models, case, worlds[mesh][0][case]["steps"][i - 1]["params"],
                nmb)
            assert _rel(got[0]["loss"], same[0]) <= REL, (i, same)
            assert _rel(got[0]["grad_norm"], same[1]) <= REL, (i, same)


@pytest.mark.parametrize("mesh,case", GRID, ids=IDS)
def test_params_follow_unsharded_step(mesh, case, unsharded, worlds):
    """After step 1, off by >= 0.05 lr only where the gradient is ill
    posed (below ``NOISE_FLOOR`` of its leaf's largest or, compressed, at
    an int8 rounding tie); after each step at most ``MAX_ILL`` off (the
    unsharded run at ``_oracle`` microbatches)."""
    want, grads = unsharded[case, _oracle(mesh, case)]
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
def test_slab_leaves_are_never_gathered(mesh, case, worlds, models):
    """Each step all-gathers over the mesh exactly the split leaves not
    computed on their slabs (the compression residuals are cut from
    their param slabs, never gathered), never a slab leaf, and none of a
    block that divides over ``model`` (the
    embedding and the head, MLA, the SSM and paligemma's attention over
    its one key head included: in these models, none at all);
    ``step.comm`` counts their whole bytes, and the bytes all-reduced and
    re-laid out over ``model`` that ``tensor.model_bytes`` reckons from
    the shapes (re-laid out only where an SSM or one key head splits)."""
    name, tkw = next((n, t) for c, n, t in CASES if c == case)
    cfg = models[name][0]
    statics = ttr.init_statics(cfg, "cpu")
    wants = [tensor.model_bytes(cfg, statics, mesh[1], TOKENS[0] // mesh[0],
                                _seq(models, name),
                                tkw.get("microbatches", 1), rank=m)
             for m in range(mesh[1])]
    # the SSM's columns, paligemma's one key head's, phi3's key heads'
    relaid = name in ("jamba", "mamba2", "paligemma", "phi3",
                      "phi3_ungrouped")
    assert all((w["model_relayout_bytes"] > 0) == relaid for w in wants)
    # the stream splits where 2 divides its positions
    assert all((w["model_scatter_bytes"] > 0) == (name != "granite_odd")
               for w in wants)
    for i, r in enumerate(worlds[mesh]):
        want = wants[i % mesh[1]]  # ranks are (data, model), model minor
        res = r[case]
        assert res["slab_leaves"] > 0
        assert res["gathered_paths"] == []
        for row in res["steps"]:
            assert not set(row["gathered"]) & set(res["slab_ids"])
            assert sorted(row["gathered"]) == sorted(res["gathered_ids"])
            assert row["comm"]["param_gather_bytes"] == res["gathered_bytes"]
            for key, value in want.items():
                assert row["comm"][key] == value, (key, row["comm"], want)


@pytest.mark.parametrize("mesh,name", [(m, n) for m in MESHES
                                       for n in NO_REMAT],
                         ids=[f"{m[0]}x{m[1]}-{n}" for m in MESHES
                              for n in NO_REMAT])
def test_remat_is_bit_equal_on_the_grid(mesh, name, worlds, models):
    """With ``remat`` (the default) each step's loss, gradient norm and
    params equal those without it bit for bit on every rank, whisper's
    recomputed encoder included; only the forward's collectives over
    ``model`` run again, by the bytes ``tensor.model_bytes`` reckons for
    each config."""
    cfg = models[name][0]
    assert cfg.remat
    sizes = {}
    for case, c in ((name, cfg), (f"{name}_no_remat",
                                  dataclasses.replace(cfg, remat=False))):
        sizes[case] = tensor.model_bytes(
            c, ttr.init_statics(c, "cpu"), mesh[1], TOKENS[0] // mesh[0],
            _seq(models, name))
    on, off = sizes[name], sizes[f"{name}_no_remat"]
    # on a split stream the forward's gathers run again, on a whole one
    # its all-reduces
    assert sum(on.values()) > sum(off.values()) > 0
    for r in worlds[mesh]:
        a, b = r[name]["steps"], r[f"{name}_no_remat"]["steps"]
        for i, (x, y) in enumerate(zip(a, b)):
            assert x["metrics"] == y["metrics"], (i, x["metrics"])
            assert (x["params"] is None) == (y["params"] is None)
            for key, value in (x["params"] or {}).items():
                assert value.tobytes() == y["params"][key].tobytes(), key
            for c, want in ((x["comm"], on), (y["comm"], off)):
                for key, value in want.items():
                    assert c[key] == value, (key, c, want)
            assert {k: v for k, v in x["comm"].items() if k not in on
                    and k != "model_gather_bytes"} == {
                k: v for k, v in y["comm"].items() if k not in off
                and k != "model_gather_bytes"}


def _drops(models, name, monkeypatch, blocks: int, counted: int):
    """(whether some MoE layer drops pairs, whether other pairs than
    counting each ``counted`` consecutive blocks together would): the
    routes of ``name``'s batch run as ``blocks`` row blocks, each alone,
    as the sharded step on 2 x 2 runs them."""
    cfg, nparams, batch = models[name]
    params = lm_params_from_numpy(nparams, "cpu")
    statics = ttr.init_statics(cfg, "cpu")
    seen = []
    real = tmoe._route

    def spy(p, c, xf):
        out = real(p, c, xf)
        seen.append(out[1])
        return out

    monkeypatch.setattr(tmoe, "_route", spy)
    tokens = torch.as_tensor(batch["tokens"])[:, :-1]
    b, s = tokens.shape
    k, per = cfg.moe.top_k, b // blocks
    routes = []
    with torch.no_grad():
        for j in range(blocks):
            seen.clear()
            ttr.apply_model(params, statics, tokens[j * per:(j + 1) * per],
                            kernels=False)
            routes.append([e.reshape(per, s, k) for e in seen])
    dropped, differs = False, False
    for layer in zip(*routes):
        def kept(group):
            return torch.cat([
                tmoe.kept_pairs(torch.cat(layer[j:j + group]).reshape(-1, k),
                                cfg.moe).reshape(-1, s, k)
                for j in range(0, blocks, group)])

        alone = kept(1)
        dropped |= bool((~alone).any())
        differs |= bool((alone != kept(counted)).any())
    return dropped, differs


@pytest.mark.parametrize("name", MICROBATCHED)
def test_microbatch_cases_drop_other_pairs_per_rank(name, models,
                                                    monkeypatch):
    """The microbatch cases bear load: run as the sharded step runs them
    on the 2 x 2 mesh (each rank's rows cut into 2 microbatches: 4
    blocks of 2 rows, each counted alone), some MoE layer drops pairs,
    and counting each global microbatch (2 blocks) together would keep
    other pairs."""
    assert _drops(models, name, monkeypatch, 4, 2) == (True, True)


@pytest.mark.parametrize("name", MOE)
def test_moe_cases_drop_other_pairs_per_block(name, models, monkeypatch):
    """The MoE cases without microbatches on the 2 x 2 mesh: each data
    block of 4 rows counted alone drops pairs, other pairs than the
    whole batch's count would."""
    assert _drops(models, name, monkeypatch, 2, 2) == (True, True)


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


def _block_cases():
    """(name, kind, config, numpy params, inputs) of ``tp_blocks``: the
    lookup, the head and the cross-entropy of a vocabulary of 13 padded
    to 16 (rank 1's slab of columns 8..15 holds the 3 padding columns);
    an SSM of 8 heads in one group and in two; paligemma's attention (4
    query heads over 1 key head, biases added), attention of 6 query
    heads over 3 key heads (grouped; padded to 8, ungrouped; with whole
    key projections); MLA of 4 heads."""
    from repro_torch.models.mla import MLAConfig, mla_init
    from repro_torch.models.ssm import SSMConfig, ssm_init

    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(3)
    vcfg = dataclasses.replace(get_smoke_config("h2o_danube_1_8b"),
                               vocab=13, vocab_pad=16, d_model=8)
    vparams, _ = ttr.init_params(vcfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    out = [("vocab", "vocab", vcfg,
            _numpy({k: vparams[k] for k in ("embed", "lm_head")}),
            {"tokens": rng.integers(0, 13, (3, 5)),
             "labels": rng.integers(0, 13, (3, 5))})]
    for groups in (1, 2):
        cfg = SSMConfig(d_model=16, d_state=4, head_dim=4, n_groups=groups,
                        chunk=4, model_shards=1)
        params = ssm_init(gen, cfg, device="cpu")
        for key in ("dt_bias", "D", "conv_b"):
            params[key] = torch.as_tensor(rng.normal(
                size=params[key].shape).astype(np.float32))
        out.append((f"ssm_g{groups}", "ssm", cfg, _numpy(params), {
            "x": rng.normal(size=(2, 10, 16)).astype(np.float32),
            "dy": rng.normal(size=(2, 10, 16)).astype(np.float32)}))
    from repro_torch.models.attention import AttnConfig, attention_init
    pali = dataclasses.replace(get_smoke_config("paligemma_3b").attn_cfg(
        False), qkv_bias=True)
    # 6 query heads over 3 key heads: each rank's 3 read 2 key heads,
    # re-laid out from 6-column slabs (biases too); padded from 6 to 8,
    # ungrouped, rank 0's heads reading key heads 0-1, rank 1's 1-2; key
    # projections 15 wide (heads of 5, without RoPE), whole leaves, each
    # rank taking its 2 key heads' columns
    phi = AttnConfig(d_model=24, n_heads=6, n_kv_heads=3, d_head=4,
                     qkv_bias=True, model_shards=1)
    for name, acfg in (
            ("attn_one_kv", pali), ("attn_grouped_relaid", phi),
            ("attn_ungrouped", dataclasses.replace(phi, model_shards=4)),
            ("attn_whole_kv", dataclasses.replace(
                phi, d_head=5, model_shards=2, rope_theta=None))):
        out.append((name, "attn", acfg, _numpy(attention_init(
            gen, acfg, device="cpu")), {
            "x": rng.normal(size=(2, 6, acfg.d_model)).astype(np.float32),
            "dy": rng.normal(size=(2, 6, acfg.d_model)).astype(
                np.float32)}))
    mcfg = MLAConfig(d_model=16, n_heads=4, kv_lora=8, q_lora=12, d_nope=4,
                     d_rope=4, d_v=4, model_shards=1)
    out.append(("mla", "mla", mcfg, _numpy(mla_init(gen, mcfg,
                                                    device="cpu")), {
        "x": rng.normal(size=(2, 6, 16)).astype(np.float32),
        "dy": rng.normal(size=(2, 6, 16)).astype(np.float32)}))
    return out


@pytest.fixture(scope="module")
def fn_world(tmp_path_factory):
    """The MLP's and the other blocks' functions on one two-rank spawn."""
    cases, blocks = _mlp_cases(), _block_cases()
    ranks = _run_ranks(tmp_path_factory.mktemp("tp_fn"), 2, [
        {"name": "mlp", "kind": "tp_mlp", "mesh": (1, 2), "cases": cases},
        {"name": "blocks", "kind": "tp_blocks", "mesh": (1, 2),
         "cases": blocks}])
    return cases, blocks, ranks


@pytest.fixture(scope="module")
def mlp_world(fn_world):
    cases, _, ranks = fn_world
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


def _slab_of(whole, slab, r):
    """Rank ``r``'s slab of ``whole``: along the first dim whose size
    differs (the whole leaf itself where none does)."""
    dims = [i for i, (a, b) in enumerate(zip(slab.shape, whole.shape))
            if a != b]
    if not dims:
        return whole
    n = slab.shape[dims[0]]
    return np.take(whole, range(r * n, (r + 1) * n), axis=dims[0])


@pytest.mark.parametrize("which", ["vocab", "ssm_g1", "ssm_g2",
                                   "attn_one_kv", "attn_grouped_relaid",
                                   "attn_ungrouped", "attn_whole_kv", "mla"])
def test_functions_give_the_whole_block(which, fn_world):
    """Each block's tensor-parallel twin on two ranks against the whole
    computation on one, within ``FN_TOL`` of the largest value: the
    vocabulary-split lookup, head and cross-entropy (the loss, the
    lookup's output and each rank's rows and columns of the table's and
    the head's gradients); the SSM on its heads (the output, the input's
    gradient, each slab leaf's gradient, the norm's whole scale's); the
    attention of 4 query heads over 1 key head (its columns re-laid out
    to both ranks), of 6 over 3 (each rank's two key heads re-laid out,
    grouped, and padded to 8 ungrouped; whole key projections, each
    rank's columns taken and their gradients summed); MLA on its heads.
    The SSM's and the key heads' re-laid-out bytes are those ``tensor``
    reckons."""
    from repro_torch.models.attention import attention_apply
    from repro_torch.models.mla import mla_apply
    from repro_torch.models.ssm import ssm_apply

    _, blocks, ranks = fn_world
    name, kind, cfg, params, inputs = next(c for c in blocks
                                           if c[0] == which)
    live = _map(lambda a: torch.tensor(a, requires_grad=True), params)
    want = {}
    if kind == "vocab":
        x = live["embed"]["w"][torch.as_tensor(inputs["tokens"])]
        loss = ttrain.cross_entropy(x @ live["lm_head"]["w"],
                                    torch.as_tensor(inputs["labels"]),
                                    cfg.vocab)
        loss.backward()
        want.update(loss=np.array(loss.item()), x=x.detach().numpy())
    else:
        xt = torch.tensor(inputs["x"], requires_grad=True)
        pos = torch.arange(xt.shape[1])
        if kind == "ssm":
            y, _ = ssm_apply(live, cfg, xt)
        elif kind == "attn":
            y, _ = attention_apply(live, cfg, xt, pos, prefill=False)
        else:
            y, _ = mla_apply(live, cfg, xt, pos)
        (y * torch.as_tensor(inputs["dy"])).sum().backward()
        want.update(y=y.detach().numpy(), dx=xt.grad.numpy())
    grads = dict(_paths(_map(lambda t: t.grad.numpy(), live)))
    for r, got in enumerate(ranks):
        got = got["blocks"][which]
        for key, value in want.items():
            _close(np.asarray(got[key]), value, key)
        for key, slab in _paths(got["grads"]):
            _close(slab, _slab_of(grads[key], slab, r), key)
        assert got["reduce_bytes"] > 0
        # float32 params: 4 bytes a re-laid-out element, forward and back
        assert got["relayout_bytes"] == {
            "ssm": lambda: 2 * 4 * tensor._ssm_relayout(cfg, 2),
            "attn": lambda: 2 * 4 * tensor._attention_kv_moves(cfg, 2,
                                                               r)[0],
        }.get(kind, lambda: 0)()


@pytest.mark.parametrize("arch,n,blocks", [
    # GQA heads and dense MLPs split over 2; over 4, each rank's one
    # query head reads one of the 2 key heads, re-laid out
    ("granite_3_2b", 2, {"attn", "mlp"}),
    ("granite_3_2b", 4, {"attn", "mlp"}),
    # MLA's 4 heads, the experts and the shared experts split over 2;
    # over 8 the heads stay whole
    ("deepseek_v2_236b", 2, {"mla", "mlp", "moe", "moe_shared"}),
    ("deepseek_v2_236b", 8, {"mlp", "moe", "moe_shared"}),
    # whisper's self- and cross-attention
    ("whisper_small", 2, {"attn", "xattn", "mlp"}),
    ("granite_3_2b", 1, set()),
    # the SSM's 8 heads and packed widths (280, 144) over 2 and 8
    ("jamba_1_5_large_398b", 2, {"attn", "ssm", "mlp", "moe"}),
    ("jamba_1_5_large_398b", 8, {"ssm", "mlp"}),
    ("mamba2_780m", 2, {"ssm"}),
    ("mamba2_780m", 16, set()),
    # 4 query heads over 1 key head: each rank's heads read the one
    ("paligemma_3b", 2, {"attn", "mlp"}),
    # 6 query heads over 3 key heads: each rank's 3 read 2 of them; over
    # 4 the query heads do not divide
    ("phi3_medium_14b", 2, {"attn", "mlp"}),
    ("phi3_medium_14b", 4, {"mlp"}),
])
def test_layer_splits_follow_the_configs(arch, n, blocks):
    cfg = get_smoke_config(arch)
    statics = ttr.init_statics(cfg, "cpu")
    got = set().union(*(tensor.layer_splits(cfg, st, n) for st in
                        statics["prefix_layers"] + statics["body"]))
    assert got == blocks


def test_full_configs_split_where_the_heads_divide():
    """phi3's and whisper's attention splits its query heads over 16
    (below).  paligemma's 8 query heads pad to 16 over 1 key head: its key heads
    do not split over 2 ranks, so each rank's 8 query heads read the one
    key head, re-laid out (not over 3, which the heads do not divide);
    jamba's 64 over 8 split, its SSM and routed experts as the config
    gives them.  MLA's 128 heads split over
    16, not 3; mamba2's SSM (48 heads, packed widths 6448 and 3328) over
    16, not 32; jamba's (256 heads, 33056 and 16416) over 16.  The padded
    vocabularies (102,400, 50,432, 257,280) split over 16, not 7."""
    pali, jamba = get_config("paligemma_3b"), get_config(
        "jamba_1_5_large_398b")
    assert not tensor.attention_splits(pali.attn_cfg(False), 2)
    assert tensor.attention_kv_heads(pali.attn_cfg(False), 2) == [[0], [0]]
    assert pali.attn_cfg(False).hq_pad % 3  # no split over 3
    assert tensor.attention_splits(jamba.attn_cfg(False), 2)
    assert tensor.attention_kv_heads(jamba.attn_cfg(False), 2) == [
        [0, 1, 2, 3], [4, 5, 6, 7]]
    assert tensor.experts_split(jamba.moe, 2)
    assert not tensor.experts_split(jamba.moe, 3)
    ds, mamba = get_config("deepseek_v2_236b"), get_config("mamba2_780m")
    assert tensor.mla_splits(ds.mla, 16) and not tensor.mla_splits(ds.mla, 3)
    assert tensor.ssm_splits(mamba.ssm, 16)
    assert not tensor.ssm_splits(mamba.ssm, 32)
    assert tensor.ssm_splits(jamba.ssm, 16)
    for cfg in (ds, mamba, pali):
        assert tensor.vocab_splits(cfg, 16)
        assert not tensor.vocab_splits(cfg, 7)
    # phi3's 40 query heads pad to 48 over 10 key heads (ungrouped), and
    # whisper's 12 to 16 over 12: each splits its query heads over 16, its
    # key projections 1280 and 768 wide split 80 and 48 columns a rank
    # (cutting heads), every leaf of the layer's blocks on its slab
    phi3, whisper = get_config("phi3_medium_14b"), get_config("whisper_small")
    # the key heads of ranks 0 and 1 (query heads 0-2 and 3-5 read key
    # heads h // 5; 0 and 1 read h // 2)
    for cfg, blocks, first in ((phi3, {"attn", "mlp"}, [[0], [0, 1]]),
                               (whisper, {"attn", "xattn", "mlp"},
                                [[0], [0]])):
        statics = ttr.init_statics(cfg, "cpu")
        st = statics["body"][0]
        assert not st["attn_cfg"].grouped
        assert tensor.layer_splits(cfg, st, 16) == blocks
        assert tensor.kv_split(st["attn_cfg"], 16)
        assert tensor.attention_kv_heads(st["attn_cfg"], 16)[:2] == first
        slab = tensor.slab_leaves(cfg, statics, ttr.init_specs(cfg), 16)
        for block in blocks:
            assert all(_leaves(slab["body"][0][block])), block
        assert not any(_leaves(slab["body"][0]["norm1"]))


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b",
                                  "deepseek_v3_671b", "mamba2_780m"])
def test_slab_leaves_mark_whole_blocks(arch):
    """Smoke configs over 2 ranks: every leaf of an attention layer, of
    the dense MLPs, the routed and the shared experts on the slab; of an
    SSM layer all but its norm, of MLA its heads' ``wq_b``, ``wkv_b`` and
    ``wo``; the embedding and the head (the MTP layer's blocks as the
    body's); the routers, the norms and MLA's latent projections whole
    leaves, never slabs."""
    cfg = get_smoke_config(arch)
    statics = ttr.init_statics(cfg, "cpu")
    slab = dict(_paths(tensor.slab_leaves(cfg, statics, ttr.init_specs(cfg),
                                          2)))
    kinds = set()
    for key, on in slab.items():
        parts = key.split("/")
        want = parts[0] in ("embed", "lm_head")
        if parts[0] in ("prefix_layers", "body", "mtp_layer"):
            at = 1 if parts[0] == "mtp_layer" else 2
            st = (statics["mtp_layer"] if at == 1
                  else statics[parts[0]][int(parts[1])])
            block, leaf = parts[at], parts[at + 1]
            if block == "attn":
                kind = st["mixer"]
                want = (kind == "attn"
                        or (kind == "ssm" and leaf != "norm")
                        or (kind == "mla" and leaf in ("wq_b", "wkv_b",
                                                       "wo")))
                if want:
                    kinds.add(kind)
            elif block in ("mlp", "moe"):
                want = block == "mlp" or leaf in ("experts", "shared")
                if want:
                    kinds.add(block)
        if want and parts[0] in ("embed", "lm_head"):
            kinds.add("vocab")
        assert on == want, key
    assert kinds == {"jamba_1_5_large_398b": {"attn", "ssm", "mlp", "moe",
                                              "vocab"},
                     "deepseek_v3_671b": {"mla", "mlp", "moe", "vocab"},
                     "mamba2_780m": {"ssm", "vocab"}}[arch]


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
