"""The port's sharded execution against the JAX reference's (CPU).

Twins of ``tests/test_engine_sharded.py``, ``tests/test_partition.py``,
``tests/test_distributed.py::test_logical_to_pspec_divisibility`` and
``tests/test_service.py::test_sharded_composition_independence``, run on
``gloo`` process groups:

  * a one-rank mesh in this process (``make_mesh`` starts its own group):
    bit-equal to the port's unsharded forward, within 1e-4 of the
    reference's own 1x1 mesh;
  * groups of 2, 4 and 8 ranks in spawned processes
    (``tests/torch_mesh_worker.py``, which imports only torch and
    repro_torch; a file-store rendezvous under ``tmp_path``): meshes
    (1, 2), (1, 4), (1, 8) and (2, 4) with an odd batch of 7, the
    sharded flash-decode at (1, 2) and (2, 2), and DeepSeek-V2's smoke
    MoE expert-parallel at (1, 2) and (2, 2).  The references are
    computed here with the JAX package and compared here.

The program is the reference's uneven mini program (``block=9, tile=8``,
widths (8, 16, 24): 1, 2 and 3 tiles per conv), so every mesh of more
than one model rank runs zero-padded tiles.  Limits: fp32 logits within
1e-4 of JAX; skip counters and windows exactly equal; int8 within 5e-3
and argmax agreement >= 0.98 of the unsharded int8 run and >= 0.95 of
fp32 (the reference's bars: a reassociation ulp in one layer can flip an
int8 rounding in the next), top-1 agreement >= 0.98 with JAX's int8;
flash-decode logits within 1e-5 of JAX relative to the largest logit;
the expert-parallel MoE within 1e-5 relative of the reference's
``_moe_local`` (with its shared experts) over the whole batch at capacity
factor 8.0 (no drop: ``tests/test_distributed.py``'s test), and over each
data shard alone at 1.25 and 0.5 (capacity counted on the shard's
tokens, as the reference's ``shard_map`` counts it).
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs import get_smoke_config as j_smoke
from repro.core.pruning import build_dictionaries, magnitude_prune, project_params
from repro.core.sparse import build_block_pattern as j_build_block_pattern
from repro.core.sparse import nonzero_block_masks as j_nonzero_block_masks
from repro.engine import CompileOptions as JCompileOptions
from repro.engine import compile_network as j_compile
from repro.engine import make_forward as j_make_forward
from repro.engine import pad_bp_tiles as j_pad_bp_tiles
from repro.engine import partition_from_mesh as j_partition_from_mesh
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.models import cnn as jcnn
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.parallel.activations import (
    activation_sharding_ctx as j_activation_sharding_ctx,
)
from repro.parallel.sharding import logical_to_pspec as j_logical_to_pspec

from repro_torch.analysis.diagnostics import VerificationError
from repro_torch.core.sparse import build_block_pattern, nonzero_block_masks
from repro_torch.engine import (
    CompileOptions,
    InferenceService,
    NetworkPartition,
    compile_network,
    execute,
    make_forward,
    pad_bp_tiles,
    partition_from_mesh,
    partition_network,
    save_program,
    tile_assignment,
)
from repro_torch.engine import executor
from repro_torch.engine.partition import padded_tiles
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import attention as tatt
from repro_torch.models import cnn as tcnn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.obs.trace import Tracer
from repro_torch.parallel.activations import (
    activation_sharding_ctx,
    current_mesh,
    shard_activation,
)
from repro_torch.parallel.sharding import (
    logical_to_pspec,
    mesh_axis_sizes,
    shard_block_pattern,
)
from repro_torch.runtime.serve import decode_logits

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
LOGIT_ATOL = 1e-4
INT8_ATOL = 5e-3
F32_REL = 1e-5
BATCH_SLOTS = 8
# meshes run by the spawned groups: (data, model) -> world size
MESHES = [(1, 2), (1, 4), (1, 8), (2, 4)]
FLASH_MESHES = [(1, 2), (2, 2)]
FLASH_MAX_SEQ = 32  # divides by 2: both chunks hold live keys
FLASH_PROMPT = 20
FLASH_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 1, 12, 12)).astype(
        np.float32)


@pytest.fixture(scope="module")
def net():
    """The reference's uneven mini program, in both packages."""
    cfg = jcnn.mini_cnn_config(num_classes=5, input_hw=12, widths=(8, 16, 24))
    params = jcnn.init_cnn(cfg, jax.random.PRNGKey(0))
    names = jcnn.conv_weight_names(cfg)
    params = magnitude_prune(params, names, 0.7)
    params, bits = project_params(params, build_dictionaries(params, names, 4))
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tcnn.CNNConfig(cfg.conv_channels, cfg.pool_after, cfg.num_classes,
                          cfg.input_hw, cfg.kernel)
    tparams = tcnn.params_from_numpy(params)
    out = {}
    for prec in ("fp32", "int8"):
        out[prec] = (
            j_compile(cfg, params, bits, options=JCompileOptions(
                block=9, tile=8, precision=prec)),
            compile_network(tcfg, tparams, bits, options=CompileOptions(
                block=9, tile=8, precision=prec), device="cpu"),
        )
    assert [c.bp.n_tiles for c in out["fp32"][1].convs] == [1, 2, 3]
    return out


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank CPU mesh in this process (its group outlives the test
    module; a later one-rank mesh in this process reuses it)."""
    return make_mesh((1, 1), ("data", "model"), device_type="cpu")


def _jmesh():
    return j_make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])


# ------------------------------------------------------------ spawned ranks


def _run_ranks(tmp_path, world: int, jobs: list[dict]) -> list[dict]:
    """Run ``jobs`` on a ``world``-rank gloo group of spawned processes;
    returns each rank's results."""
    spec = {"world": world, "store": str(tmp_path / "store"),
            "out": str(tmp_path / "out"), "timeout": 120, "jobs": jobs}
    path = tmp_path / "spec.pkl"
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(path), str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, e[-3000:])
              for r, (p, (_, e)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, failed
    results = []
    for r in range(world):
        with open(f"{spec['out']}.{r}", "rb") as f:
            results.append(pickle.load(f))
    return results


def _cnn_job(net, tmp_path, mesh) -> dict:
    d = tmp_path / "progs"
    if not d.exists():
        d.mkdir()
        save_program(str(d / "fp32"), net["fp32"][1])
        save_program(str(d / "int8"), net["int8"][1])
    x_stats = _images(7, 7)
    x_stats[5:] = 0.0  # dead slots: zero padding, masked out
    return {"name": f"cnn{mesh}", "kind": "cnn", "mesh": mesh,
            "fp32": str(d / "fp32"), "int8": str(d / "int8"),
            "x": _images(7 if mesh[0] > 1 else 8, 5),
            "x_stats": x_stats,
            "valid": np.array([True] * 5 + [False] * 2),
            "x_int8": _images(64, 5), "images": _images(10, 1),
            "batch_slots": BATCH_SLOTS}


def _granite(decode_strategy):
    jcfg = dataclasses.replace(j_smoke("granite_3_2b"),
                               decode_strategy=decode_strategy)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ttr.ModelConfig)}
    return jcfg, ttr.ModelConfig(**fields)


@pytest.fixture(scope="module")
def lm():
    """granite's smoke config (no window) with ``decode_strategy='flash'``:
    numpy params, prompts, and the reference's flash-decode on its own
    1x1 mesh (teacher tokens = its greedy tokens), for batches of 4 and 3
    rows at one shared position."""
    jcfg, tcfg = _granite("flash")
    jp, _, jst = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    ref = {}
    for b in (4, 3):
        prompts = rng.integers(0, jcfg.vocab, (b, FLASH_PROMPT)).astype(
            np.int32)
        cache = jtr.init_cache(jst, b, FLASH_MAX_SEQ, dtype=jnp.float32)
        logits, cache, _ = jtr.apply_model(
            jp, jst, jnp.asarray(prompts),
            positions=jnp.arange(FLASH_PROMPT), cache=cache,
            cache_pos=jnp.int32(0), cache_len=jnp.int32(FLASH_PROMPT))
        tok = np.asarray(logits[:, -1, : jcfg.vocab].argmax(-1))
        teacher, steps = [], []
        with j_activation_sharding_ctx(_jmesh()):
            for i in range(FLASH_STEPS):
                pos = jnp.int32(FLASH_PROMPT + i)
                teacher.append(tok.astype(np.int64))
                logits, cache, _ = jtr.apply_model(
                    jp, jst, jnp.asarray(tok)[:, None], positions=pos[None],
                    cache=cache, cache_pos=pos, cache_len=pos + 1)
                step = np.asarray(logits[:, -1, : jcfg.vocab], np.float32)
                steps.append(step)
                tok = step.argmax(-1)
        ref[b] = {"prompts": prompts, "teacher": teacher,
                  "logits": np.stack(steps)}
    return tcfg, jax.tree_util.tree_map(np.asarray, jp), ref


def _flash_job(lm, mesh, b) -> dict:
    tcfg, params, ref = lm
    return {"name": f"flash{mesh}b{b}", "kind": "flash", "mesh": mesh,
            "cfg": tcfg, "params": params, "prompts": ref[b]["prompts"],
            "teacher": ref[b]["teacher"], "max_seq": FLASH_MAX_SEQ}


MOE_CASES = (("no_drop", 8.0), ("drops", 1.25), ("many_drops", 0.5))


@pytest.fixture(scope="module")
def moe_model():
    """DeepSeek-V2's smoke MoE (8 experts top-2, 2 shared; 2 model
    shards): the reference's params as numpy and an input [4, 6, D]."""
    jcfg = dataclasses.replace(j_smoke("deepseek_v2_236b").moe,
                               model_shards=2)
    jp, _, _ = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(11).normal(size=(4, 6, jcfg.d_model)).astype(
        np.float32)
    return jcfg, jax.tree_util.tree_map(np.asarray, jp), x


def _moe_job(moe_model, mesh) -> dict:
    jcfg, params, x = moe_model
    cases = [(name, tmoe.MoEConfig(**dataclasses.asdict(
        dataclasses.replace(jcfg, capacity_factor=cf))), x)
        for name, cf in MOE_CASES]
    return {"name": f"moe{mesh}", "kind": "moe", "mesh": mesh,
            "params": params, "cases": cases}


def _world(tmp_path_factory, world, jobs):
    results = _run_ranks(tmp_path_factory.mktemp(f"world{world}"), world,
                         jobs)
    # SPMD: every rank returns the whole result, the same on each rank
    for r in results[1:]:
        for name, res in r.items():
            for key, val in res.items():
                if key != "spmm_rows":
                    _assert_same(val, results[0][name][key], (name, key))
    return results


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], what)
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_same(x, y, what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=str(what))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, net, lm, moe_model):
    return _world(tmp_path_factory, 2, [
        _cnn_job(net, tmp_path_factory.mktemp("p2"), (1, 2)),
        _flash_job(lm, (1, 2), 4), _moe_job(moe_model, (1, 2))])


@pytest.fixture(scope="module")
def world4(tmp_path_factory, net, lm, moe_model):
    return _world(tmp_path_factory, 4, [
        _cnn_job(net, tmp_path_factory.mktemp("p4"), (1, 4)),
        _flash_job(lm, (2, 2), 4), _flash_job(lm, (2, 2), 3),
        _moe_job(moe_model, (2, 2))])


@pytest.fixture(scope="module")
def world8(tmp_path_factory, net):
    tmp = tmp_path_factory.mktemp("p8")
    return _world(tmp_path_factory, 8, [
        _cnn_job(net, tmp, (1, 8)), _cnn_job(net, tmp, (2, 4))])


def _results(request, mesh, kind="cnn", b=None):
    world = mesh[0] * mesh[1]
    res = request.getfixturevalue(f"world{world}")[0]
    return res[f"{kind}{mesh}" + ("" if b is None else f"b{b}")]


# -------------------------------------------------------------- partitioner


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_pad_bp_tiles_matches_reference(net, shards):
    jprog, tprog = net["int8"]
    for jop, top in zip([*jprog.convs, jprog.fc], [*tprog.convs, tprog.fc]):
        want = j_pad_bp_tiles(jop.bp, shards)
        got = pad_bp_tiles(top.bp, shards)
        assert got.n_tiles % shards == 0
        assert got.n_tiles - top.bp.n_tiles < shards  # minimal padding
        for field in ("w_comp", "block_ids", "w_scales", "nnz", "inv_order",
                      "new_order"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, field)),
                np.asarray(getattr(want, field)), err_msg=field)
        assert (got.n_out, got.k_in) == (top.bp.n_out, top.bp.k_in)
        torch.testing.assert_close(got.dense(), top.bp.dense(), rtol=0,
                                   atol=0)


def test_tile_assignment_partitions_padded_range():
    for n_tiles, shards in [(1, 1), (1, 4), (3, 2), (5, 4), (8, 8), (7, 3)]:
        asg = tile_assignment(n_tiles, shards)
        assert asg.shape[0] == shards
        flat = np.sort(asg.ravel())
        np.testing.assert_array_equal(flat, np.arange(len(flat)))
        assert len(flat) % shards == 0 and len(flat) >= n_tiles


BLOCK, TILE = 8, 8


def _random_bp(seed: int, nb: int, nt: int, density: float):
    """``tests/test_partition.py``'s random block-sparse weight, compressed
    by both packages."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(nb * BLOCK, nt * TILE)).astype(np.float32)
    kill = rng.random(size=(nb, nt * TILE)) > density
    w *= ~np.repeat(kill, BLOCK, axis=0)
    tbp = build_block_pattern(w, block=BLOCK, tile=TILE,
                              masks=nonzero_block_masks(w, BLOCK),
                              device="cpu")
    jbp = j_build_block_pattern(w, block=BLOCK, tile=TILE,
                                masks=j_nonzero_block_masks(w, BLOCK))
    return w, tbp, jbp


bp_params = st.tuples(
    st.integers(0, 2**31 - 1),  # seed
    st.integers(1, 3),  # K blocks
    st.integers(1, 6),  # tiles
    st.floats(0.1, 0.9),  # density
    st.integers(1, 9),  # shards
)


@given(bp_params)
@settings(max_examples=40, deadline=None)
def test_assignment_covers_every_padded_tile_once(p):
    _, nb, nt, _, shards = p
    asg = tile_assignment(nt, shards)
    assert asg.shape == (shards, padded_tiles(nt, shards) // shards)
    np.testing.assert_array_equal(np.sort(asg.ravel()), np.arange(asg.size))
    assert nt <= asg.size < nt + shards


@given(bp_params)
@settings(max_examples=25, deadline=None)
def test_padding_tiles_are_inert(p):
    seed, nb, nt, density, shards = p
    _, bp, jbp = _random_bp(seed, nb, nt, density)
    padded = pad_bp_tiles(bp, shards)
    assert padded.n_tiles == padded_tiles(bp.n_tiles, shards)
    np.testing.assert_array_equal(padded.w_comp[: bp.n_tiles].numpy(),
                                  bp.w_comp.numpy())
    np.testing.assert_array_equal(padded.block_ids[: bp.n_tiles].numpy(),
                                  bp.block_ids.numpy())
    np.testing.assert_array_equal(padded.nnz[: bp.n_tiles], bp.nnz)
    assert not padded.w_comp[bp.n_tiles:].any()
    assert not padded.nnz[bp.n_tiles:].any()
    # and the same operand the reference pads
    want = j_pad_bp_tiles(jbp, shards)
    np.testing.assert_array_equal(padded.w_comp.numpy(),
                                  np.asarray(want.w_comp))
    np.testing.assert_array_equal(padded.nnz, want.nnz)


@given(bp_params)
@settings(max_examples=25, deadline=None)
def test_reassembled_weights_equal_unsharded(p):
    """Each rank's slab (``shard_block_pattern`` at every coordinate of a
    model dim of ``shards``) reassembles the padded operand, and the
    padded operand reconstructs the original dense weight exactly."""
    seed, nb, nt, density, shards = p
    w, bp, _ = _random_bp(seed, nb, nt, density)
    padded = pad_bp_tiles(bp, shards)
    slabs = [shard_block_pattern(padded, _FakeMesh({"data": 1,
                                                    "model": shards}, r))
             for r in range(shards)]
    asg = tile_assignment(bp.n_tiles, shards)
    for r, slab in enumerate(slabs):
        np.testing.assert_array_equal(slab.w_comp.numpy(),
                                      padded.w_comp[asg[r]].numpy())
        np.testing.assert_array_equal(slab.nnz, padded.nnz[asg[r]])
    np.testing.assert_array_equal(
        torch.cat([s.w_comp for s in slabs]).numpy(), padded.w_comp.numpy())
    np.testing.assert_array_equal(padded.dense().numpy(), bp.dense().numpy())
    np.testing.assert_array_equal(bp.dense().numpy(), w)


class _FakeMesh:
    """What the port reads of a ``DeviceMesh``: dim names, shape and this
    rank's coordinate along ``model``."""

    def __init__(self, shape: dict, model_rank: int = 0):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())
        self._model_rank = model_rank

    def get_local_rank(self, dim):
        assert dim == "model"
        return self._model_rank


class _FakeJaxMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def test_partition_from_mesh_defaults_and_validation():
    shape = {"data": 2, "model": 4}
    mesh, jmesh = _FakeMesh(shape), _FakeJaxMesh(shape)
    part = partition_from_mesh(mesh)
    assert (part.data, part.model) == (2, 4)
    assert dataclasses.asdict(part) == dataclasses.asdict(
        j_partition_from_mesh(jmesh))
    ok = NetworkPartition(data=2, model=4)
    assert partition_from_mesh(mesh, ok) is ok
    with pytest.raises(ValueError, match="model=8"):
        partition_from_mesh(mesh, NetworkPartition(data=2, model=8))
    assert partition_from_mesh(_FakeMesh({"x": 3})).n_chips == 1
    with pytest.raises(ValueError):
        NetworkPartition(data=0, model=2)


def test_logical_to_pspec_divisibility():
    cases = [({"data": 4, "model": 2}, ("ff", None), (8, 3)),
             ({"data": 4, "model": 2}, ("ff", None), (7, 3)),
             ({"pod": 2, "data": 4, "model": 2}, ("batch", None), (16, 3)),
             ({"pod": 2, "data": 4, "model": 2}, ("batch", None), (4, 3)),
             ({"data": 4, "model": 2}, ("tiles", None, None, None),
              (6, 1, 9, 8)),
             ({"data": 4, "model": 2}, None, (6, 1))]
    for shape, spec, dims in cases:
        got = logical_to_pspec(spec, dims, _FakeMesh(shape))
        assert got == tuple(j_logical_to_pspec(spec, dims,
                                               _FakeJaxMesh(shape)))
    mesh = _FakeMesh({"data": 4, "model": 2})
    assert logical_to_pspec(("ff", None), (8, 3), mesh) == tuple(P("model"))
    assert logical_to_pspec(("ff", None), (7, 3), mesh) == ()
    mesh2 = _FakeMesh({"pod": 2, "data": 4, "model": 2})
    assert logical_to_pspec(("batch", None), (16, 3), mesh2) == (
        ("pod", "data"),)
    assert mesh_axis_sizes(mesh2) == {"pod": 2, "data": 4, "model": 2}


def test_partition_network_verifies_at_declaration(net):
    jprog, tprog = net["fp32"]
    part = partition_network(tprog, data=2, model=4)
    assert part.partition == NetworkPartition(data=2, model=4)
    assert part.convs is tprog.convs  # weights stay unpadded
    with pytest.raises(VerificationError, match="V403"):
        partition_network(tprog, model=2, data_axis="model")
    with pytest.raises(ValueError):
        partition_network(tprog, model=0)
    # the chips view prices the same split as the reference's
    from repro.engine import partition_network as j_partition_network

    want = j_partition_network(jprog, data=2, model=4).hardware_report()
    assert part.hardware_report()["chips"] == want["chips"]


# ---------------------------------------------------------- one-rank mesh


def test_make_mesh_validates_its_world(mesh1, monkeypatch):
    assert mesh_axis_sizes(mesh1) == {"data": 1, "model": 1}
    assert mesh1.device_type == "cpu"
    again = make_local_mesh(device_type="cpu")  # reuses the group
    assert mesh_axis_sizes(again) == mesh_axis_sizes(mesh1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((1, 2), ("data", "model"), device_type="cpu")
    with pytest.raises(ValueError, match="device type"):
        make_mesh((1, 1), ("data", "model"), device_type="tpu")
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((1, 1), ("data",), device_type="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("prec", ["fp32", "int8"])
def test_single_device_mesh_runs_everywhere(net, mesh1, prec, monkeypatch):
    """The mesh path itself needs no second process: a 1x1 mesh is bit
    for bit the unsharded forward, and within 1e-4 (int8: 5e-3) of the
    reference's own 1x1 mesh.  16 images: at 4, XLA's CPU compiler fails
    on the reference's int8 program."""
    jprog, tprog = net[prec]
    x = _images(16, 3)
    ref = make_forward(tprog, device="cpu")(x)
    fused = []
    real = executor.conv_patches_q8_cuda
    monkeypatch.setattr(executor, "conv_patches_q8_cuda",
                        lambda *a: fused.append(a) or real(*a))
    out = make_forward(tprog, mesh=mesh1)(x)
    # an int8 conv's rows come from the fused patch kernel on a mesh too
    assert len(fused) == (len(tprog.convs) if prec == "int8" else 0)
    assert out.device.type == "cpu"
    assert torch.equal(out, ref)
    want = np.asarray(j_make_forward(jprog, backend="xla", mesh=_jmesh())(
        jnp.asarray(x)))
    atol = LOGIT_ATOL if prec == "fp32" else INT8_ATOL
    np.testing.assert_allclose(out.numpy(), want, atol=atol)


def test_single_device_mesh_stats_and_service(net, mesh1):
    _, tprog = net["fp32"]
    x = _images(7, 7)
    valid = np.array([True] * 5 + [False] * 2)
    x[5:] = 0.0
    _, s_ref = make_forward(tprog, collect_stats=True, device="cpu")(x, valid)
    _, s_sh = make_forward(tprog, collect_stats=True, mesh=mesh1)(x, valid)
    for name, st_ in s_ref.layers.items():
        np.testing.assert_array_equal(s_sh.layers[name].counts, st_.counts)
        assert s_sh.layers[name].windows == st_.windows
    imgs = _images(10, 1)
    svc = InferenceService(tprog, batch_slots=BATCH_SLOTS, mesh=mesh1,
                           collect_stats=True)
    ref = InferenceService(tprog, batch_slots=BATCH_SLOTS,
                           collect_stats=True, device="cpu")
    np.testing.assert_array_equal(svc.classify(imgs), ref.classify(imgs))
    assert svc.trace_count() == 1
    for name, st_ in ref.activation_stats.layers.items():
        np.testing.assert_array_equal(
            svc.activation_stats.layers[name].counts, st_.counts)


def test_sharded_composition_independence(net, mesh1):
    """The mesh path keeps the batch-composition invariance: with one
    rank, bit-exact (``tests/test_service.py``'s twin)."""
    _, tprog = net["fp32"]
    fwd = make_forward(tprog, mesh=mesh1)
    x = _images(8, 5)
    crowd = fwd(x)
    padded = np.zeros_like(x)
    padded[0] = x[0]
    dead = fwd(padded)
    assert torch.equal(dead[0], crowd[0])


def test_partition_mesh_size_mismatch_rejected(net, mesh1):
    """A program partitioned for 4 devices must not silently run on 1."""
    _, tprog = net["fp32"]
    progp = partition_network(tprog, model=4)
    with pytest.raises(ValueError, match="mesh has"):
        make_forward(progp, mesh=mesh1)
    with pytest.raises(ValueError, match="mesh has"):
        InferenceService(progp, mesh=mesh1)
    with pytest.raises(ValueError, match="requires mesh"):
        execute(tprog, _images(1, 0), partition=NetworkPartition(model=2),
                device="cpu")
    with pytest.raises(ValueError, match="not on the mesh"):
        make_forward(tprog, mesh=mesh1, device="meta")


def test_execute_caches_meshes_by_value(net, mesh1):
    _, tprog = net["fp32"]
    tprog = dataclasses.replace(tprog)  # a fresh cache
    x = _images(2, 4)
    a = execute(tprog, x, mesh=mesh1)
    b = execute(tprog, x, mesh=make_mesh((1, 1), ("data", "model"),
                                         device_type="cpu"))
    assert torch.equal(a, b)
    assert len(tprog._forward_cache) == 1  # equal meshes share an entry
    execute(tprog, x, device="cpu")
    execute(tprog, x, mesh=mesh1, partition=NetworkPartition())
    assert len(tprog._forward_cache) == 3


def test_traced_forward_under_mesh(net, mesh1):
    """The instrumented path runs the sharded dispatch layer by layer:
    same logits, a span and an observed time per layer."""
    _, tprog = net["fp32"]
    x = _images(3, 2)
    tracer = Tracer()
    fn = make_forward(tprog, mesh=mesh1, tracer=tracer)
    assert torch.equal(fn(x), make_forward(tprog, mesh=mesh1)(x))
    assert set(fn.observed_times()) == {"conv1", "conv2", "conv3", "fc"}
    assert {sp.name for sp in tracer.spans()} >= {"forward", "layer:conv1",
                                                  "layer:fc"}


def test_activation_context(mesh1):
    x = torch.ones(2, 3)
    assert current_mesh() is None
    with activation_sharding_ctx(mesh1):
        assert current_mesh() is mesh1
        assert shard_activation(x, ("batch", None)) is x
    assert current_mesh() is None


def test_flash_decode_single_device_mesh(lm, mesh1):
    """One rank: the flash-decode route runs (its counter moves) and its
    logits are the reference's flash-decode's within 1e-5."""
    tcfg, params, ref = lm
    tp = lm_params_from_numpy(params, "cpu")
    tst = ttr.init_statics(tcfg, "cpu")
    r = ref[4]
    prompts = torch.as_tensor(r["prompts"])
    cache = ttr.init_cache(tst, 4, FLASH_MAX_SEQ, dtype=torch.float32)
    ttr.apply_model(tp, tst, prompts, positions=torch.arange(FLASH_PROMPT),
                    cache=cache, cache_pos=0, cache_len=FLASH_PROMPT)
    calls = tatt.flash_decode_sharded.calls
    with activation_sharding_ctx(mesh1):
        for i, tok in enumerate(r["teacher"]):
            logits, cache = decode_logits(tst, tp, cache, torch.as_tensor(tok),
                                          torch.tensor(FLASH_PROMPT + i))
            assert _rel(logits.numpy(), r["logits"][i]) <= F32_REL
    assert tatt.flash_decode_sharded.calls - calls == (
        FLASH_STEPS * tcfg.n_layers)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# ------------------------------------------------------- spawned gloo groups


def _unsharded(net, prec, x):
    jprog, tprog = net[prec]
    return (make_forward(tprog, device="cpu")(x).numpy(),
            np.asarray(j_make_forward(jprog, backend="xla")(jnp.asarray(x))))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharded_forward_matches_reference(request, net, mesh):
    """fp32 logits on every mesh within 1e-4 of the reference (odd batch
    of 7 on the data x model mesh: fc rows replicated) and of the port's
    unsharded forward; an explicit partition runs the same."""
    res = _results(request, mesh)
    x = _images(7 if mesh[0] > 1 else 8, 5)
    port, ref = _unsharded(net, "fp32", x)
    np.testing.assert_allclose(res["logits"], ref, atol=LOGIT_ATOL)
    np.testing.assert_allclose(res["logits"], port, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(res["partitioned"], res["logits"])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharded_stats_exact(request, net, mesh):
    """Skip counters and windows equal the reference's exactly, dead
    rows masked, counters all-reduced over the data group."""
    res = _results(request, mesh)
    jprog, _ = net["fp32"]
    x = _images(7, 7)
    x[5:] = 0.0
    valid = np.array([True] * 5 + [False] * 2)
    want, js = j_make_forward(jprog, backend="xla", collect_stats=True)(
        jnp.asarray(x), valid)
    np.testing.assert_allclose(res["stats_logits"][:5], np.asarray(want)[:5],
                               atol=LOGIT_ATOL)
    assert set(res["stats"]) == set(js.layers)
    for name, st_ in js.layers.items():
        counts, windows = res["stats"][name]
        np.testing.assert_array_equal(counts, st_.counts)
        assert windows == st_.windows


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharded_quantized_forward(request, net, mesh):
    """Int8 slabs carry their scales: within 5e-3 and argmax agreement
    >= 0.98 of the port's unsharded int8 forward, >= 0.95 of fp32
    (``tests/test_engine_sharded.py``'s bars), and argmax agreement
    >= 0.98 with the reference's int8 forward (the two packages' int8
    logits are held to top-1, not to 5e-3: one activation rounding apart
    moves a logit of this net by 7e-3)."""
    res = _results(request, mesh)
    x = _images(64, 5)
    port, ref = _unsharded(net, "int8", x)
    fp32, _ = _unsharded(net, "fp32", x)
    out = res["int8"]
    np.testing.assert_allclose(out, port, atol=INT8_ATOL)
    assert (out.argmax(-1) == port.argmax(-1)).mean() >= 0.98
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.98
    assert (out.argmax(-1) == fp32.argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharded_service_matches_unsharded(request, net, mesh):
    """10 requests through 8 slots on every rank: labels and accumulated
    statistics equal the unsharded service's; one input signature; with
    a data dim, each rank's spmm ran on its half of the slot rows."""
    res = _results(request, mesh)
    _, tprog = net["fp32"]
    ref = InferenceService(tprog, batch_slots=BATCH_SLOTS,
                           collect_stats=True, device="cpu")
    np.testing.assert_array_equal(res["service_labels"],
                                  ref.classify(_images(10, 1)))
    for name, st_ in ref.activation_stats.layers.items():
        counts, windows = res["service_stats"][name]
        np.testing.assert_array_equal(counts, st_.counts)
        assert windows == st_.windows
    assert res["service_trace_count"] == 1
    fc_rows = {rows[0] for rows in res["spmm_rows"]
               if rows[1] == tprog.fc.bp.k_in}
    assert fc_rows == {BATCH_SLOTS // mesh[0]}


@pytest.mark.parametrize("mesh", FLASH_MESHES, ids=str)
def test_sharded_flash_decode_matches_reference(request, lm, mesh):
    """Each model rank scores its half of the 32-slot cache (the prompt
    of 20 spans both halves); every step's logits within 1e-5 of the
    reference's flash-decode, greedy tokens through ``make_decode_step``
    its argmax; on (2, 2) a batch of 4 splits over the data dim and one
    of 3 stays whole."""
    _, _, ref = lm
    for b in ((4,) if mesh[0] == 1 else (4, 3)):
        res = _results(request, mesh, "flash", b)
        assert res["logits"].shape == ref[b]["logits"].shape
        assert _rel(res["logits"], ref[b]["logits"]) <= F32_REL
        assert res["flash_calls"] == (FLASH_STEPS + 1) * 2  # 2 layers
        np.testing.assert_array_equal(res["greedy"],
                                      res["logits"][-1].argmax(-1))


@pytest.mark.parametrize("case,cf", MOE_CASES)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=str)
def test_expert_parallel_moe_matches_reference(request, moe_model, mesh,
                                               case, cf):
    """Each model rank runs 4 of the 8 experts on its data shard; the
    all-reduce over ``model`` and the all-gather over ``data`` give every
    rank the reference's result: at capacity factor 8.0 the whole
    batch's ``_moe_local`` (no pair drops), at 1.25 and 0.5 each data
    shard's own (drops counted on the shard's tokens)."""
    jcfg, params, x = moe_model
    res = _results(request, mesh, "moe")
    assert res["sharded_calls"] == len(MOE_CASES)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    jst = {"shared": {"act": jcfg.act, "sparse": None}}

    def ref(xs):
        return np.asarray(jmoe.moe_apply(params, jst, jcfg, jnp.asarray(xs)))

    if case == "no_drop":
        want = ref(x)
    else:
        want = np.concatenate([ref(xs) for xs in np.split(x, mesh[0])])
    assert res[case].shape == x.shape
    assert _rel(res[case], want) <= F32_REL
    if case != "no_drop" and mesh[0] > 1:  # shards' capacity != batch's
        assert _rel(ref(x), want) > F32_REL
