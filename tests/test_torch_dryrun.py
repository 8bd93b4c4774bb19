"""The production step builder, the placed serving steps and the dry run,
against the JAX reference (CPU).

  * ``models.transformer.model_flops_per_token`` equals the reference's
    with ``==`` and ``configs.input_specs`` gives the reference's shapes
    and dtypes, for every entry of ``ARCH_NAMES`` at every shape (full
    configs);
  * ``launch.steps.cache_pspec`` equals ``repro.launch.steps.cache_pspec``
    leaf by leaf on the cache tree of ``init_cache`` at each serving
    shape, on both production meshes (stand-in meshes for both packages,
    as ``tests/test_distributed.py`` builds them);
  * for every arch x shape x production mesh cell, rank 0's param,
    ZeRO-1 moment and cache bytes equal those reckoned from the
    reference's partition specs;
  * a mini dry run (the twin of ``tests/test_distributed.py``'s): granite
    smoke at ``model_shards=4``, a mini train, prefill and decode on 4 x 4
    and 2 x 2 x 4 fake meshes, in a process of its own: every record
    ``ok`` with FLOPs, and the train step's collective bytes by kind equal
    ``step.comm``'s (its gradients reduce-scattered over ``data``, its
    stream of 64 positions split over the 4 model ranks: reduce-scattered
    and gathered over ``model``, by mesh dim), whose ``model`` bytes
    ``parallel.tensor.model_bytes`` reckons (the forward's again under
    remat); ``run_cell`` records a skip and an error as the reference's.

The placed serving steps themselves are held to the reference in
``tests/test_torch_placed_serve.py``.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

from repro.configs import ARCH_NAMES
from repro.configs import get_config as j_full
from repro.configs import input_specs as j_input_specs
from repro.launch.steps import cache_pspec as j_cache_pspec
from repro.models import transformer as jtr
from repro.parallel.sharding import logical_to_pspec as j_logical_to_pspec

from repro_torch.configs import SHAPES, get_config, input_specs, runnable
from repro_torch.launch import steps as tsteps
from repro_torch.launch.op_stats import COLLECTIVES, fake_mode
from repro_torch.models import transformer as ttr
from repro_torch.optim.optimizers import _leaves
from test_torch_specs import _FakeJaxMesh, _FakeMesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
PRODUCTION = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_per_token_equals_reference(arch):
    for active in (True, False):
        assert ttr.model_flops_per_token(get_config(arch), active) == \
            jtr.model_flops_per_token(j_full(arch), active)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_reference(arch):
    for shape in SHAPES:
        got, want = input_specs(arch, shape), j_input_specs(arch, shape)
        assert list(got) == list(want), shape
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape), (shape, k)
            assert str(got[k].dtype) == f"torch.{want[k].dtype}", (shape, k)


def _jax_tree(arch, spec):
    """The reference's (specs, param ShapeDtypeStructs, statics) of the
    full config at ``spec``, nothing allocated."""
    aux = {}

    def init(key):
        params, aux["specs"], aux["statics"] = jtr.init_params(
            j_full(arch, spec), key)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return aux["specs"], shapes, aux["statics"]


def _strip(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _key(path) -> tuple:
    return tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)


def _slab_bytes(pspec, shape, itemsize: int, sizes: dict) -> int:
    """A leaf's slab bytes on rank 0 from its partition spec."""
    n = 1
    for d, entry in zip(shape, list(pspec) + [None] * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n *= d // math.prod(sizes[a] for a in axes)
    return n * itemsize


def _ref_zero1(pspec, shape, dsize: int) -> tuple:
    """The reference's ``_zero1`` on one leaf's partition spec."""
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (ax, dim) in enumerate(zip(spec, shape)):
        if ax is None and dim % dsize == 0 and dsize > 1:
            spec[i] = "data"
            return tuple(spec)
    return tuple(pspec)


def _port_cache(arch, spec):
    """The port's cache tree at ``spec`` (fake tensors) and its cfg."""
    cfg = get_config(arch, spec)
    statics = ttr.init_statics(cfg, "cpu")
    with fake_mode():
        cache = ttr.init_cache(statics, spec.global_batch, spec.seq_len,
                               torch.bfloat16, device="cpu")
    return cfg, cache


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_placements_and_rank_bytes_equal_reference(arch):
    """``cache_pspec`` leaf by leaf at each serving shape, then rank 0's
    bytes in every cell, on both production meshes."""
    shapes = [s for s in SHAPES if runnable(arch, s)]
    trees = {}
    for name in shapes:
        spec = SHAPES[name]
        cfg = get_config(arch, spec)
        # the params' shapes follow the sequence length only through
        # learned decoder positions (whisper)
        at = spec.seq_len if cfg.rope_theta is None else None
        if at not in trees:
            with fake_mode():
                trees[at] = _jax_tree(arch, spec), ttr.init_params(
                    cfg, torch.Generator(), device="cpu")[0]
        (jspecs, jshapes, jstatics), p_shapes = trees[at]
        if spec.kind != "train":
            _, cache = _port_cache(arch, spec)
            jcache = jax.eval_shape(lambda: jtr.init_cache(
                jstatics, spec.global_batch, spec.seq_len, jnp.bfloat16))
            jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
        jp = jax.tree_util.tree_flatten_with_path(jshapes)[0]
        jsp = dict(zip((_key(p) for p, _ in jp), jax.tree.leaves(
            jspecs, is_leaf=lambda x: x is None or isinstance(x, tuple))))
        for mesh_name, sizes in PRODUCTION.items():
            jmesh, tmesh = _FakeJaxMesh(sizes), _FakeMesh(sizes)
            want = {"params": 0, "moments": 0, "cache": 0}
            n_params = sum(math.prod(s.shape) for _, s in jp)
            opt = 2 if n_params > tsteps._BF16_OPT_THRESHOLD else 4
            for path, sds in jp:
                ps = j_logical_to_pspec(jsp[_key(path)], sds.shape, jmesh)
                item = jnp.dtype(sds.dtype).itemsize
                want["params"] += _slab_bytes(ps, sds.shape, item, sizes)
                if spec.kind == "train":
                    z = _ref_zero1(tuple(ps), sds.shape, sizes["data"])
                    want["moments"] += 2 * _slab_bytes(z, sds.shape, opt,
                                                       sizes)
            p_pl = tsteps.param_shardings(ttr.init_specs(cfg), p_shapes,
                                          tmesh)
            got = {"params": sum(
                math.prod(pl.slab_shape) * t.element_size()
                for pl, t in zip(_leaves(p_pl), _leaves(p_shapes))),
                "moments": 0, "cache": 0}
            if spec.kind == "train":
                z = tsteps._zero1(p_pl, p_shapes, tmesh)
                got["moments"] = sum(2 * math.prod(pl.slab_shape) * opt
                                     for pl in _leaves(z))
            else:
                pcs = {}
                tsteps._map_path(lambda path, leaf: pcs.__setitem__(
                    path, (tsteps.cache_pspec(path, tuple(leaf.shape),
                                              tmesh), leaf)), cache)
                assert sorted(map(str, pcs)) == sorted(
                    str(_key(p)) for p, _ in jflat)
                for path, sds in jflat:
                    ref = _strip(j_cache_pspec(path, sds.shape, jmesh))
                    mine, leaf = pcs[_key(path)]
                    assert _strip(mine) == ref, (name, mesh_name, path)
                    assert tuple(leaf.shape) == sds.shape
                    want["cache"] += _slab_bytes(
                        ref, sds.shape, jnp.dtype(sds.dtype).itemsize, sizes)
                    got["cache"] += _slab_bytes(mine, tuple(leaf.shape),
                                                leaf.element_size(), sizes)
                c_pl = tsteps.cache_shardings(cache, tmesh)
                assert sum(math.prod(pl.slab_shape) * t.element_size()
                           for pl, t in zip(_leaves(c_pl), _leaves(cache))
                           ) == got["cache"]
            assert got == want, (name, mesh_name)


MINI = """
import dataclasses, json
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.launch.dryrun import measure, record
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.steps import build_step
from repro_torch.parallel.tensor import (model_bytes, serve_bytes,
                                        serve_pods, serve_rows)
from repro_torch.runtime.train import comm_by_kind
out = {}
cfg = dataclasses.replace(get_smoke_config("granite_3_2b"), model_shards=4)
for name, (dims, axes) in {
        "single": ((4, 4), ("data", "model")),
        "multi": ((2, 2, 4), ("pod", "data", "model"))}.items():
    mesh = make_fake_mesh(dims, axes)
    for spec in (ShapeSpec("mini", "train", 64, 8),
                 ShapeSpec("mini_prefill", "prefill", 64, 8),
                 ShapeSpec("mini_decode", "decode", 64, 8)):
        built = build_step("granite_3_2b", spec, mesh, cfg=cfg)
        stats, s = measure(built, mesh)
        rec = record(built, mesh, spec, stats, s)
        if spec.kind == "train":
            # rows over pod x data: 4 of both meshes
            rec["reckoned"] = model_bytes(cfg, built.meta["statics"], 4,
                                          spec.global_batch // 4,
                                          spec.seq_len)
            rec["comm_by_kind"] = comm_by_kind(rec["step_comm"])
        else:  # rows over data, as the cache's, then over pod
            blocks = serve_rows(mesh, spec.global_batch)[1]
            rec["step_comm"] = dict(built.fn.comm)
            rec["reckoned"] = serve_bytes(
                cfg, built.meta["statics"], 4, spec.global_batch // blocks,
                spec.seq_len, spec.kind, spec.seq_len, pos=spec.seq_len - 1,
                blocks=blocks, placements=built.meta["placements"]["params"],
                pods=serve_pods(mesh, spec.global_batch),
                cache_placements=built.meta["placements"]["cache"])
        out[name + ":" + spec.kind] = rec
print(json.dumps(out, default=str))
"""


def _python(code: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_mini_dry_run_single_and_multipod():
    from repro_torch.parallel.tensor import serve_comm_by_kind

    res = _python(MINI)
    assert len(res) == 6
    for key, rec in res.items():
        assert rec["status"] == "ok", key
        assert rec["hlo_flops_per_device"] > 0, key
        assert rec["routes"].startswith("plain")
        mem = rec["memory"]
        assert mem["peak_bytes"] >= mem["param_bytes"] + mem["opt_bytes"] \
            + mem["cache_bytes"] > 0, key
        assert rec["dominant_term"] in rec["roofline"]
        by_kind = {k: v["bytes"] for k, v in rec["collectives"].items()
                   if k in COLLECTIVES and v["bytes"]}
        if rec["kind"] == "train":
            assert by_kind == {k: v for k, v in rec["comm_by_kind"].items()
                               if v}, key
            for name in ("model_reduce_bytes", "model_relayout_bytes",
                         "model_scatter_bytes", "model_seq_gather_bytes"):
                assert rec["step_comm"][name] == rec["reckoned"][name], key
            # 64 positions split over 4 model ranks: the stream's slabs
            # reduce-scattered and gathered, the norms' gradients summed
            for name in ("model_reduce_bytes", "model_scatter_bytes",
                         "model_seq_gather_bytes"):
                assert rec["step_comm"][name] > 0, (key, name)
        else:  # computed on the model slabs: no param gathered
            assert rec["step_comm"] == rec["reckoned"] == rec[
                "serve_reckoned"], key
            assert rec["step_comm"]["param_gather_bytes"] == 0, key
            assert by_kind == {k: v for k, v in serve_comm_by_kind(
                rec["step_comm"]).items() if v}, key
            # the row products' partial sums: reduce-scattered onto the
            # prefill's 64 positions split over 4, all-reduced in a decode
            assert by_kind["reduce-scatter" if rec["kind"] == "prefill"
                           else "all-reduce"] > 0, key
    # the gradients reduce-scattered over data onto the ZeRO-1 slabs,
    # those slabs (and the rest, and the loss) all-reduced over pod, the
    # rows pod-major; data also reduces the norm's per-leaf statistics
    for key in ("single:train", "multi:train"):
        comm = res[key]["step_comm"]
        by_dim = res[key]["collectives"]["by_dim"]
        assert res[key]["collectives"]["reduce-scatter"]["bytes"] == comm[
            "data_scatter_bytes"] + comm["model_scatter_bytes"]
        assert comm["data_scatter_bytes"] > 0
        # over model: the stream's reduce-scatters, and its gathers (the
        # only all-gathers there: every param leaf computes on its slab)
        assert by_dim["reduce-scatter/model"] == comm["model_scatter_bytes"]
        assert by_dim["all-gather/model"] == comm["model_seq_gather_bytes"]
    multi = res["multi:train"]["collectives"]["by_dim"]
    comm = res["multi:train"]["step_comm"]
    assert multi["reduce-scatter/data"] == comm["data_scatter_bytes"]
    assert multi["all-reduce/pod"] == (
        multi["all-reduce/data"] - comm["data_stat_bytes"]
        + multi["reduce-scatter/data"])
    # serving: the pods split each data block's rows (2 a rank on both
    # meshes: the same FLOPs) and share what each wrote of the cache
    for kind in ("prefill", "decode"):
        assert res[f"multi:{kind}"]["hlo_flops_per_device"] == res[
            f"single:{kind}"]["hlo_flops_per_device"], kind
    assert res["multi:prefill"]["step_comm"]["pod_gather_bytes"] > 0


RUN_CELL = """
import dataclasses, json, os
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, mesh, steps
mesh.make_production_mesh = lambda **k: mesh.make_fake_mesh(
    (2, 4), ("data", "model"))
steps.cell_config = lambda arch, spec, sparse=False: dataclasses.replace(
    get_smoke_config(arch), model_shards=4)
rec = dryrun.run_cell("granite_3_2b", "decode_32k", False, OUT,
                      decode_strategy="flash")
rec["files"] = sorted(os.listdir(OUT))
print(json.dumps(rec, default=str))
"""


def test_run_cell_plans_the_flash_decode_route(tmp_path):
    """``--decode-strategy flash`` (``run_cell``'s ``decode_strategy``):
    the cell's config with the flash decode route, its record tagged
    ``__flash``, its bytes the reckoned ones (smoke granite on a fake
    2 x 4 mesh standing in for the production one)."""
    rec = _python(RUN_CELL.replace("OUT", repr(str(tmp_path))))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["files"] == ["granite_3_2b__decode_32k__single__flash.json"]
    assert rec["decode_strategy"] == "flash"
    assert rec["routes"].endswith("decode_strategy=flash")
    assert rec["step_comm"] == rec["serve_reckoned"]


def test_run_cell_records_skips_and_errors(tmp_path, monkeypatch):
    """A cell no architecture runs is a ``skip`` with its reason; a cell
    whose build fails is an ``error`` with its traceback, written to its
    file as the reference writes it."""
    from repro_torch.launch import dryrun, mesh

    rec = dryrun.run_cell("granite_3_2b", "long_500k", False, str(tmp_path))
    assert rec["status"] == "skip" and "sub-quadratic" in rec["skip_reason"]

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(mesh, "make_production_mesh", lambda **k: None)
    monkeypatch.setattr(tsteps, "build_step", broken)
    rec = dryrun.run_cell("granite_3_2b", "train_4k", True, str(tmp_path))
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: planted"
    assert "broken" in rec["traceback"]
    with open(tmp_path / "granite_3_2b__train_4k__multi.json") as f:
        assert json.load(f)["status"] == "error"
