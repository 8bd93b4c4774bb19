"""The port's sharded train step, ZeRO-1 and elastic restore (CPU).

The reference's bar (``tests/test_distributed.py::
test_sharded_train_matches_single_device``): granite's smoke config at
``model_shards=2``, a seeded ``(8, 33)`` token batch, one AdamW step on a
``(data, model) = (2, 2)`` mesh of four spawned ``gloo`` ranks
(``tests/torch_mesh_worker.py``'s ``train`` job), every rank fed its own
rows by ``shard_batch``, the weights the reference's ``init_params``
(through ``lm_params_from_numpy``):

  * the loss within 1e-4 relative of the reference's single-device JAX
    step and of the port's one-device step, at microbatches 1 and 2 and
    with int8 gradient compression;
  * the params after the step, gathered whole, against the one-device
    step by ``tests/test_torch_train_step.py``'s rule: within ``0.05 *
    lr``, except weights whose gradient is at the noise floor (or, with
    compression, at an int8 rounding tie), at most ``MAX_ILL`` of them;
  * each rank's slabs the shapes ``param_shardings`` / ``_zero1`` give
    its coordinates, and the gradients reduce-scattered over ``data``
    onto the moment slabs by the bytes reckoned from them;
  * a one-rank mesh gives the unsharded step bit for bit.

Elastic restore: the 2 x 2 run checkpoints through ``Trainer`` (whole
leaves, rank 0 writes); the directory restores bit-equal onto a ``data=2``
mesh of two spawned ranks (``restore`` job, through
``Trainer.maybe_restore``), onto one device, and in the reference's
``restore_checkpoint``, whose own save of the same state writes the same
manifest.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as jtr
from repro.optim import adamw as j_adamw
from repro.runtime import train as jtrain

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.checkpoint.checkpointer import _leaf_paths
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import _zero1, param_shardings
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.optim import adamw, sgd
from repro_torch.runtime import train as ttrain
from test_torch_lm import _port_cfg
from test_torch_sharded import _run_ranks
from test_torch_train_step import (
    ADAM_LR,
    MAX_ILL,
    NOISE_FLOOR,
    SGD_LR,
    TIE,
    _by_key,
)

MESH = (2, 2)
RESTORE_MESH = (2, 1)
TOKENS = (8, 33)
REL = 1e-4
CASES = {"plain": {}, "microbatches": {"microbatches": 2},
         "compression": {"grad_compression": True}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params and statics, port cfg, numpy
    params, batch)."""
    jcfg = dataclasses.replace(j_smoke("granite_3_2b"), model_shards=2)
    jparams, _, jst = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": np.random.default_rng(3).integers(
        0, jcfg.vocab, TOKENS).astype(np.int32)}
    return (jcfg, (jparams, jst), _port_cfg(jcfg),
            jax.tree.map(np.asarray, jparams), batch)


def _port_step(model, opt, lr, shardings=None, **tkw):
    """One port step from the reference's weights: (state, metrics)."""
    _, _, cfg, nparams, batch = model
    tc = ttrain.TrainConfig(steps=1, **tkw)
    params = lm_params_from_numpy(nparams, "cpu")
    step = ttrain.make_train_step(cfg, ttr.init_statics(cfg, "cpu"), opt,
                                  lambda s: lr, tc, shardings=shardings)
    return step(ttrain.init_train_state(params, opt, tc, shardings),
                {k: torch.as_tensor(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def one_device(model):
    """Per case: the port's one-device AdamW step and the SGD step whose
    update recovers the (clipped) gradient."""
    out = {}
    for name, tkw in CASES.items():
        sgd_tkw = {k: v for k, v in tkw.items() if k != "grad_compression"}
        out[name] = (_port_step(model, adamw(weight_decay=0.0), ADAM_LR,
                                **tkw),
                     _port_step(model, sgd(), SGD_LR, **sgd_tkw)[0])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, model):
    """The 2 x 2 runs (the plain case checkpointed through ``Trainer``),
    then the checkpoint restored on a ``data=2`` mesh: (2 x 2 results per
    case, per rank; restore results per rank; checkpoint directory)."""
    _, _, cfg, nparams, batch = model
    tmp = tmp_path_factory.mktemp("sharded_train")
    ckpt = str(tmp / "ckpt")
    job = {"cfg": cfg, "params": nparams, "batches": [batch], "lr": ADAM_LR,
           "mesh": MESH}
    jobs = [{**job, "name": name, "kind": "train", "tcfg": tkw,
             "save": name == "plain", "ckpt_dir": ckpt}
            for name, tkw in CASES.items()]
    for d in ("w4", "w2"):
        (tmp / d).mkdir()
    trained = _run_ranks(tmp / "w4", 4, jobs)
    restored = _run_ranks(tmp / "w2", 2, [{
        **job, "name": "restore", "kind": "restore", "mesh": RESTORE_MESH,
        "ckpt_dir": ckpt}])
    return ({name: [r[name] for r in trained] for name in CASES},
            [r["restore"] for r in restored], ckpt)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_loss_matches_reference_and_one_device(case, model,
                                                       one_device, world):
    jcfg, (jparams, jst), _, _, batch = model
    tc = jtrain.TrainConfig(steps=1, **CASES[case])
    opt = j_adamw(weight_decay=0.0)
    step = jax.jit(jtrain.make_train_step(jcfg, jst, opt,
                                          lambda s: ADAM_LR, tc))
    _, jm = step(jtrain.init_train_state(jparams, opt, tc),
                 {"tokens": jnp.asarray(batch["tokens"])})
    (_, tm), _ = one_device[case]
    ranks = world[0][case]
    got = ranks[0]["metrics"][0]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    assert _rel(got["loss"], jm["loss"]) <= REL
    assert _rel(got["loss"], tm["loss"]) <= REL
    assert _rel(got["grad_norm"], tm["grad_norm"]) <= REL


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_params_follow_one_device_step(case, model, one_device,
                                               world):
    """The gathered params against the one-device step: off by ``0.05 *
    lr`` only where Adam's direction is ill-posed, and at most
    ``MAX_ILL`` of all weights."""
    _, _, _, nparams, _ = model
    (tstate, _), gstate = one_device[case]
    got = world[0][case][0]["state"]
    p0 = dict(_leaf_paths(nparams))
    p1 = {k: v.numpy() for k, v in _leaf_paths(gstate["params"])}
    ill, total = 0, 0
    for key, want in _leaf_paths(tstate["params"]):
        have = got[f"params/{key}"]
        assert have.shape == want.shape and have.dtype == want.numpy().dtype
        off = np.abs(have - want.numpy()) >= 0.05 * ADAM_LR
        total += off.size
        if not off.any():
            continue
        g = (p0[key] - p1[key]) / SGD_LR
        top = np.abs(g).max()
        posed = np.abs(g) >= NOISE_FLOOR * top
        if CASES[case].get("grad_compression"):
            frac = np.abs(g / ((top + 1e-12) / 127.0)) % 1.0
            posed &= np.abs(frac - 0.5) >= TIE
        assert not (off & posed).any(), key
        ill += int(off.sum())
    assert ill <= MAX_ILL * total
    assert got["step"] == 1 and got["opt_state/count"] == 1


class _Mesh:
    """What the placements read of a ``DeviceMesh``, at one rank's
    coordinates."""

    def __init__(self, shape: dict, coords: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())
        self._coords = coords

    def get_local_rank(self, dim):
        return self._coords[dim]


def _expected_slabs(cfg, nparams, mesh_shape, coords) -> dict:
    """{checkpoint key: (slab shape, whole shape)} of the params and the
    moments at one rank's coordinates."""
    mesh = _Mesh(dict(zip(("data", "model"), mesh_shape)), coords)
    p_shard = param_shardings(ttr.init_specs(cfg), nparams, mesh)
    z = _zero1(p_shard, nparams, mesh)
    out = {}
    for prefix, tree in (("params", p_shard), ("opt_state/mu", z),
                         ("opt_state/nu", z)):
        out.update({f"{prefix}/{k}": (pl.slab_shape, pl.shape)
                    for k, pl in _leaf_paths(tree)})
    return out


def test_slab_shapes_follow_placements(model, world):
    """Each rank holds the slabs its coordinates give under
    ``param_shardings`` and ``_zero1``, and some leaves are split."""
    _, _, cfg, nparams, _ = model
    for mesh_shape, ranks in ((MESH, world[0]["plain"]),
                              (RESTORE_MESH, world[1])):
        split = 0
        for r in ranks:
            want = _expected_slabs(cfg, nparams, mesh_shape, r["coords"])
            for key, (slab, whole) in want.items():
                assert r["slabs"][key] == slab, key
                split += slab != whole
        assert split > 0
        assert len({tuple(r["coords"].values()) for r in ranks}) == len(ranks)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_reduce_scatter_to_moment_slabs(case, model, world):
    """Each gradient leaf whose ZeRO-1 moments split a dim over ``data``
    is reduce-scattered onto that slab (``data_scatter_bytes``: the
    slabs' float32 bytes), the others all-reduced over ``data`` on their
    param slabs beside the loss (``data_reduce_bytes``); the new params,
    and with compression the new residuals, come back by all-gathers
    over ``data``; the global norm (and the int8 scales) reduce one
    float32 statistic a leaf over each dim its slab splits."""
    _, _, cfg, nparams, _ = model
    compressed = bool(CASES[case].get("grad_compression"))
    for r in world[0][case]:
        mesh = _Mesh(dict(zip(("data", "model"), MESH)), r["coords"])
        p_shard = param_shardings(ttr.init_specs(cfg), nparams, mesh)
        pairs = list(zip(_leaf_paths(p_shard), _leaf_paths(
            _zero1(p_shard, nparams, mesh))))
        split = [(pl, z) for (_, pl), (_, z) in pairs if "data" in z.pspec]
        kept = [pl for (_, pl), (_, z) in pairs if "data" not in z.pspec]
        assert split
        by_model = sum("model" in z.pspec for _, (_, z) in pairs)
        comm = r["comm"]
        assert comm["data_scatter_bytes"] == 4 * sum(
            math.prod(z.slab_shape) for _, z in split)
        assert comm["data_reduce_bytes"] == 4 + 4 * sum(
            math.prod(pl.slab_shape) for pl in kept)
        assert comm["zero_gather_bytes"] == (1 + compressed) * 4 * sum(
            math.prod(pl.slab_shape) for pl, _ in split)
        assert comm["data_stat_bytes"] == (1 + compressed) * 4 * len(split)
        assert comm["model_stat_bytes"] == (1 + compressed) * 4 * by_model
        assert ttrain.comm_by_kind(comm)["reduce-scatter"] == comm[
            "data_scatter_bytes"] + comm["model_scatter_bytes"]


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_mesh_is_the_unsharded_step(case, model, one_device):
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    _, _, cfg, nparams, _ = model
    shardings = ttrain.train_shardings(ttr.init_specs(cfg), nparams, mesh)
    state, m = _port_step(model, adamw(weight_decay=0.0), ADAM_LR,
                          shardings, **CASES[case])
    (want, wm), _ = one_device[case]
    for k in ("loss", "grad_norm"):
        assert torch.equal(m[k], wm[k]), k
    got, ref = _leaf_paths(state), _leaf_paths(want)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (key, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), key


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key, a in want.items():
        b = got[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_checkpoint_restores_on_two_ranks_bit_equal(world):
    trained, restored, _ = world
    assert [r["restored_step"] for r in restored] == [1, 1]
    _assert_state_equal(restored[0]["state"], trained["plain"][0]["state"])


def test_checkpoint_restores_on_one_device_bit_equal(model, world):
    _, _, _, nparams, _ = model
    trained, _, ckpt = world
    opt = adamw(weight_decay=0.0)
    tc = ttrain.TrainConfig(steps=1)
    target = ttrain.init_train_state(lm_params_from_numpy(nparams, "cpu"),
                                     opt, tc)
    out = restore_checkpoint(ckpt, 1, target)
    _assert_state_equal({k: v.numpy() for k, v in _leaf_paths(out)},
                        trained["plain"][0]["state"])


def test_checkpoint_restores_in_reference_with_its_manifest(model, world,
                                                            tmp_path):
    """The reference restores the mesh's checkpoint bit for bit, and its
    own save of that state writes the port's manifest."""
    _, (jparams, _), _, _, _ = model
    trained, _, ckpt = world
    want = trained["plain"][0]["state"]
    opt = j_adamw(weight_decay=0.0)
    target = jtrain.init_train_state(jparams, opt, jtrain.TrainConfig())
    out = j_restore(ckpt, 1, target)
    _assert_state_equal({k: np.asarray(v) for k, v in _by_key(out).items()},
                        want)
    j_save(str(tmp_path), 1, out)
    manifests = []
    for d in (ckpt, str(tmp_path)):
        with open(f"{d}/step_0000000001/manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
