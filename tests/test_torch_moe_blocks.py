"""MoE capacity per data block in the port's tensor-parallel MoE (CPU).

The reference runs its sharded steps inside ``activation_sharding_ctx(
mesh)`` (``src/repro/launch/steps.py``, ``src/repro/launch/train.py``),
where ``moe_apply`` takes ``_moe_shard_map`` whenever the batch divides
over ``pod`` x ``data`` and the experts over ``model``: each data block's
tokens are routed alone, with the block's own capacity.  Elsewhere it
falls back to ``_moe_local`` over the whole batch.

  * The anchor, in the reference alone (``conftest.run_virtual_devices``,
    4 host devices): its ``moe_apply`` jitted under the context on a 2 x 2
    ``(data, model)`` mesh equals ``moe_apply`` on each half of the rows
    (jamba's smoke MoE, 4 x 16 seeded tokens: bit for bit), 0.48 of the
    largest value away from the whole batch's; its jitted sharded train
    step of jamba's smoke model equals its unsharded step at 2
    microbatches (loss 6.832376 both, gradient norms 1e-7 apart), and not
    the one at 1 microbatch (6.825554).
  * The port: ``models.moe.moe_apply_tp`` on spawned ``gloo`` ranks
    (``tests/torch_mesh_worker.py``'s ``tp_moe`` job) on 1 x 2 and 2 x 2
    meshes, rows cut as the sharded train step and a placed serving step
    cut them, equals the reference's ``moe_apply`` of each block's rows,
    for jamba's and DeepSeek-V2's smoke MoE at capacity factors 1.25 and
    0.5, with no counts gathered; where the reference falls back (3
    experts over 2 model ranks; 2 rows over 2 pods x 2 data ranks, which
    a placed serving step splits over ``data`` only) it equals the whole
    batch's, its counts gathered over the data dims.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from conftest import run_virtual_devices
from repro.configs import get_smoke_config as j_smoke
from repro.models import moe as jmoe

from repro_torch.models import moe as tmoe
from test_torch_sharded import _run_ranks

F32_REL = 1e-5
# the whole batch's capacity against the blocks': at least this far apart
# where pairs drop
APART = 1e-3
ROWS, SEQ = 4, 16
ARCHS = {"jamba": "jamba_1_5_large_398b", "deepseek_v2": "deepseek_v2_236b"}
CFS = (1.25, 0.5)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


ANCHOR_MOE = """
import dataclasses
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models.moe import moe_apply, moe_init
from repro.parallel.activations import activation_sharding_ctx

cfg = get_smoke_config("jamba_1_5_large_398b").moe
params, _, static = moe_init(jax.random.PRNGKey(0), cfg)
x = jnp.asarray(np.random.default_rng(9).normal(
    size=(4, 16, cfg.d_model)).astype(np.float32))
mesh = make_mesh((2, 2), ("data", "model"))
with activation_sharding_ctx(mesh):
    sharded = jax.jit(lambda p, xx: moe_apply(p, static, cfg, xx))(params, x)
blocks = jnp.concatenate([moe_apply(params, static, cfg, x[i:i + 2])
                          for i in (0, 2)])
whole = moe_apply(params, static, cfg, x)
top = float(jnp.abs(blocks).max())
print(json.dumps({
    "blocks": float(jnp.abs(sharded - blocks).max()) / top,
    "whole": float(jnp.abs(sharded - whole).max()) / top}))
"""

ANCHOR_STEP = """
import dataclasses
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.launch.steps import param_shardings
from repro.models.transformer import init_params
from repro.optim import adamw
from repro.parallel.activations import activation_sharding_ctx
from repro.runtime.train import TrainConfig, init_train_state, make_train_step

cfg = dataclasses.replace(get_smoke_config("jamba_1_5_large_398b"),
                          model_shards=2)
params, specs, statics = init_params(cfg, jax.random.PRNGKey(0))
opt = adamw(weight_decay=0.0)
batch = {"tokens": jax.random.randint(jax.random.PRNGKey(3), (8, 17), 0,
                                      cfg.vocab)}
out = {}
for nmb in (1, 2):
    tcfg = TrainConfig(steps=1, microbatches=nmb)
    step = make_train_step(cfg, statics, opt, lambda s: 1e-3, tcfg)
    _, m = jax.jit(step)(init_train_state(params, opt, tcfg), batch)
    out[f"unsharded_{nmb}"] = [float(m["loss"]), float(m["grad_norm"])]
tcfg = TrainConfig(steps=1)
step = make_train_step(cfg, statics, opt, lambda s: 1e-3, tcfg)
mesh = make_mesh((2, 2), ("data", "model"))
shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                      params)
placed = jax.tree.map(jax.device_put, params,
                      param_shardings(specs, shapes, mesh))

def wrapped(s, b):
    with activation_sharding_ctx(mesh):
        return step(s, b)

_, m = jax.jit(wrapped)(init_train_state(placed, opt, tcfg), batch)
out["sharded"] = [float(m["loss"]), float(m["grad_norm"])]
print(json.dumps(out))
"""


def test_reference_moe_under_its_mesh_counts_each_block():
    """The reference's ``moe_apply`` under ``activation_sharding_ctx`` on
    2 x 2 is its per-block function, not its whole batch's."""
    res = run_virtual_devices(4, ANCHOR_MOE)
    assert res["blocks"] <= F32_REL, res
    assert res["whole"] > APART, res


def test_reference_sharded_step_is_its_step_at_more_microbatches():
    """The reference's jitted sharded step of jamba's smoke model on a
    2 x 2 ``(data, model)`` mesh gives the loss and gradient norm of its
    unsharded step at 2 microbatches (the same 4 blocks of 2 rows, each
    counted alone), not those of its step at 1."""
    res = run_virtual_devices(4, ANCHOR_STEP)
    got, two, one = res["sharded"], res["unsharded_2"], res["unsharded_1"]
    for a, b in zip(got, two):
        assert abs(a - b) <= F32_REL * abs(b), res
    assert abs(got[0] - one[0]) > 1e-4 * abs(one[0]), res


def _moe_case(arch: str, cf: float, **kw):
    """(reference cfg, numpy params, static; port cfg) of ``arch``'s smoke
    MoE at capacity factor ``cf``."""
    jcfg = dataclasses.replace(j_smoke(arch).moe, capacity_factor=cf, **kw)
    jp, _, jst = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jax.tree.map(np.asarray, jp), jst,
            tmoe.MoEConfig(**dataclasses.asdict(jcfg)))


def _x(d: int, rows: int = ROWS) -> np.ndarray:
    return np.random.default_rng(9).normal(
        size=(rows, SEQ, d)).astype(np.float32)


def _ref(case, x, blocks: int) -> np.ndarray:
    """The reference's ``moe_apply`` of each of ``blocks`` equal row
    blocks of ``x`` alone (1: the whole batch's), concatenated."""
    jcfg, params, jst, _ = case
    return np.concatenate([
        np.asarray(jmoe.moe_apply(params, jst, jcfg, jnp.asarray(xs)))
        for xs in np.split(x, blocks)])


# (case name, arch, capacity factor, extra MoEConfig fields, rows, serve)
PER_BLOCK = [(f"{name}_cf{cf}{'_serve' if serve else ''}", arch, cf, {},
              ROWS, serve)
             for name, arch in ARCHS.items() for cf in CFS
             for serve in (False, True)]
# where the reference falls back to the whole batch: 3 experts do not
# divide over 2 model ranks
FALLBACK = [("jamba_3_experts", "jamba_1_5_large_398b", 0.5,
             {"n_experts": 3}, ROWS, False)]
# (pod, data, model) = (2, 2, 1): 4 rows a block a rank, pod-split; 2 rows
# split over data only (the pods do not divide each data block's one row),
# the whole batch counted
PODS = [("jamba_pods", "jamba_1_5_large_398b", 0.5, {}, ROWS, True),
        ("jamba_pods_fallback", "jamba_1_5_large_398b", 0.5, {}, 2, True)]
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}


def _cases(rows):
    out = {}
    for name, arch, cf, kw, b, serve in rows:
        case = _moe_case(arch, cf, **kw)
        out[name] = (case, _x(case[0].d_model, b), serve)
    return out


@pytest.fixture(scope="module")
def blocks_world(tmp_path_factory):
    """mesh name -> (cases, per rank the ``tp_moe`` job's results)."""
    torch.set_num_threads(1)
    out = {}
    for mesh, rows in (("1x2", PER_BLOCK), ("2x2", PER_BLOCK + FALLBACK),
                       ("2x2x1", PODS)):
        cases = _cases(rows)
        shape, axes = MESHES[mesh]
        job = {"name": "moe", "kind": "tp_moe", "mesh": shape, "axes": axes,
               "cases": [(name, c[3], c[1], x, serve)
                         for name, (c, x, serve) in cases.items()]}
        ranks = _run_ranks(tmp_path_factory.mktemp(f"moe{mesh}"),
                           int(np.prod(shape)), [job])
        out[mesh] = (cases, [r["moe"] for r in ranks])
    return out


def _check(cases, ranks, name, blocks: int, gathers: bool):
    (case, x, _) = cases[name]
    want = _ref(case, x, blocks)
    for r in ranks:
        got = r[name]
        lo, hi = got["rows"]
        assert got["y"].shape == want[lo:hi].shape, name
        rel = _rel(got["y"], want[lo:hi])
        assert rel <= F32_REL, (name, lo, hi, rel)
        assert (got["data_gather_bytes"] > 0) == gathers, name
    return want


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("name", [c[0] for c in PER_BLOCK])
def test_tp_moe_counts_each_data_block(blocks_world, mesh, name):
    """Each rank's rows equal the reference's ``moe_apply`` of its data
    block alone (the reference's ``_moe_shard_map`` under its mesh); no
    counts are gathered.  On 2 x 2 the blocks' function lies away from
    the whole batch's wherever the seeded routes drop a pair
    (``DROPPED`` names those that do)."""
    cases, ranks = blocks_world[mesh]
    blocks = MESHES[mesh][0][0]
    want = _check(cases, ranks, name, blocks, False)
    if blocks > 1 and name.split("_serve")[0] in DROPPED:
        assert _rel(_ref(cases[name][0], cases[name][1], 1), want) > APART


# the per-block cases whose blocks' capacity drops other pairs than the
# whole batch's on 2 x 2 (test_drops_follow_the_blocks)
DROPPED = ("jamba_cf1.25", "jamba_cf0.5", "deepseek_v2_cf1.25",
           "deepseek_v2_cf0.5")


@pytest.mark.parametrize("name", [c[0] for c in PER_BLOCK if not c[5]])
def test_drops_follow_the_blocks(name):
    """The seeded routes of each ``DROPPED`` case, dispatched as 2 row
    blocks and as the whole batch, keep other pairs: so
    ``test_tp_moe_counts_each_data_block`` bears load on 2 x 2."""
    _, arch, cf, kw, b, _ = next(c for c in PER_BLOCK if c[0] == name)
    case = _moe_case(arch, cf, **kw)
    cfg = case[3]
    x = torch.as_tensor(_x(cfg.d_model, b)).reshape(-1, cfg.d_model)
    params = {"router": {k: torch.as_tensor(np.array(v)) for k, v in
                         case[1]["router"].items()}}
    _, top_e = tmoe._route(params, cfg, x)
    whole = tmoe.kept_pairs(top_e, cfg)
    halves = torch.cat([tmoe.kept_pairs(e, cfg) for e in top_e.chunk(2)])
    assert bool((whole != halves).any()) == (name in DROPPED)


def test_tp_moe_falls_back_where_the_reference_does(blocks_world):
    """3 experts over 2 model ranks: every rank runs all experts on its
    rows, counted over the whole batch (the reference's ``_moe_local``),
    the counts gathered over ``data``."""
    cases, ranks = blocks_world["2x2"]
    _check(cases, ranks, "jamba_3_experts", 1, True)


def test_tp_moe_over_pods(blocks_world):
    """On a (pod, data, model) = (2, 2, 1) mesh: 4 rows split over both,
    one a rank, each counted alone; 2 rows split over ``data`` only (the
    pods compute the same rows), counted over the whole batch, as the
    reference falls back where the batch does not divide over pod x
    data."""
    cases, ranks = blocks_world["2x2x1"]
    _check(cases, ranks, "jamba_pods", 4, False)
    _check(cases, ranks, "jamba_pods_fallback", 1, True)
