"""The port's logical parameter specs and their placement on a mesh,
against the JAX reference (CPU).

  * ``models.transformer.init_specs`` equals the ``specs`` tree the
    reference's ``init_params`` returns, tuple for tuple, for every entry
    of ``ARCH_NAMES``: on the smoke configs (also with pattern-sparse MLPs
    and at 3 model shards) and on the full configs (and ``sparse=True`` where the config takes
    it), the reference's read through ``jax.eval_shape`` so nothing is
    allocated.  The specs' leaf paths are the port's params' leaf paths.
  * ``parallel.sharding.tree_pspecs`` equals the reference's on the fake
    meshes ``tests/test_distributed.py`` builds: ``{data: 4, model: 2}``,
    ``{pod: 2, data: 2, model: 4}`` and ``{model: 16}``.
  * ``launch.steps.param_shardings`` and ``_zero1`` give the reference's
    partition specs and shard shapes, the reference's computed on 8
    virtual devices (``conftest.run_virtual_devices``).
"""

import dataclasses
import importlib
import inspect

import jax
import pytest
torch = pytest.importorskip("torch")

from conftest import run_virtual_devices
from repro.configs import ARCH_NAMES
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro.parallel.sharding import tree_pspecs as j_tree_pspecs

from repro_torch.launch.steps import _zero1, param_shardings
from repro_torch.models import transformer as ttr
from repro_torch.parallel.sharding import tree_pspecs
from test_torch_lm import _port_cfg

FAKE_MESHES = ({"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 4},
               {"model": 16})
SMOKE_SPARSE = jl.PatternSparseConfig(density=0.5, num_patterns=3, block=32,
                                      tile=32)


class _FakeJaxMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


class _FakeMesh:
    """What the port reads of a ``DeviceMesh``: dim names, shape and this
    rank's coordinates (all 0)."""

    def __init__(self, shape: dict):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())

    def get_local_rank(self, dim):
        return 0


def _paths(tree, prefix=()) -> list:
    """Leaf paths of a spec or param tree (dicts and lists are
    containers; a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, prefix + (i,))]
    return [prefix]


def _takes_sparse(arch) -> bool:
    mod = importlib.import_module(f"repro.configs.{arch}")
    return "sparse" in inspect.signature(mod.config).parameters


def _reference(cfg):
    """The reference's (specs, param shapes) of ``cfg``, nothing
    allocated."""
    aux = {}

    def init(key):
        params, aux["specs"], _ = jtr.init_params(cfg, key)
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return aux["specs"], jax.tree.map(lambda s: tuple(s.shape), shapes)


@pytest.mark.parametrize("variant", ["dense", "sparse", "shards3"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_reference_on_smoke_configs(arch, variant):
    """The smoke config as it is, with pattern-sparse MLPs, and at
    ``model_shards=3`` (key/value widths that do not divide replicate)."""
    jcfg = j_smoke(arch)
    if variant == "sparse":
        jcfg = dataclasses.replace(jcfg, sparse=SMOKE_SPARSE)
    elif variant == "shards3":
        jcfg = dataclasses.replace(jcfg, model_shards=3)
    want, _ = _reference(jcfg)
    cfg = _port_cfg(jcfg)
    specs = ttr.init_specs(cfg)
    assert specs == want
    params, _ = ttr.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    assert _paths(specs) == _paths(params)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_and_pspecs_equal_reference_on_full_configs(arch):
    """Full widths and depths, dense and (where the config takes it)
    sparse; then each leaf's partition spec on the three fake meshes."""
    mod = importlib.import_module(f"repro.configs.{arch}")
    cfgs = [j_full(arch)] + ([mod.config(sparse=True)]
                             if _takes_sparse(arch) else [])
    for jcfg in cfgs:
        want, shapes = _reference(jcfg)
        specs = ttr.init_specs(_port_cfg(jcfg))
        assert specs == want, jcfg.name
        for shape in FAKE_MESHES:
            ref = j_tree_pspecs(want, shapes, _FakeJaxMesh(shape))
            got = tree_pspecs(specs, shapes, _FakeMesh(shape))
            assert got == jax.tree.map(
                tuple, ref, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)), (jcfg.name, shape)


_ZERO1_ARCHS = ("granite_3_2b", "deepseek_v2_236b", "jamba_1_5_large_398b",
                "whisper_small")
_ZERO1_MESHES = (((4, 2), ("data", "model")),
                 ((2, 2, 2), ("pod", "data", "model")))


@pytest.fixture(scope="module")
def reference_zero1():
    """The reference's param and ZeRO-1 placements on 8 virtual devices:
    per mesh and arch (smoke config at ``model_shards=2``), each leaf's
    (param spec, param shard shape, moment spec, moment shard shape)."""
    return run_virtual_devices(8, f"""
    import dataclasses
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import _zero1, param_shardings
    from repro.models.transformer import init_params
    out = {{}}
    for dims, axes in {_ZERO1_MESHES!r}:
        mesh = make_mesh(dims, axes)
        for arch in {_ZERO1_ARCHS!r}:
            cfg = dataclasses.replace(get_smoke_config(arch), model_shards=2)
            aux = {{}}
            def init(k):
                p, aux["s"], _ = init_params(cfg, k)
                return p
            shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
            p = param_shardings(aux["s"], shapes, mesh)
            z = _zero1(p, shapes, mesh)
            flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
            rows = {{}}
            for (path, sds), ps, zs in zip(flat, jax.tree.leaves(p),
                                           jax.tree.leaves(z)):
                key = "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                               for q in path)
                rows[key] = [list(ps.spec), ps.shard_shape(sds.shape),
                             list(zs.spec), zs.shard_shape(sds.shape)]
            out[",".join(axes) + ":" + arch] = rows
    print(json.dumps(out))
    """)


def _json_spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("arch", _ZERO1_ARCHS)
@pytest.mark.parametrize("dims,axes", _ZERO1_MESHES)
def test_param_shardings_and_zero1_equal_reference(arch, dims, axes,
                                                   reference_zero1):
    jcfg = dataclasses.replace(j_smoke(arch), model_shards=2)
    _, shapes = _reference(jcfg)
    mesh = _FakeMesh(dict(zip(axes, dims)))
    p = param_shardings(ttr.init_specs(_port_cfg(jcfg)), shapes, mesh)
    z = _zero1(p, shapes, mesh)
    want = reference_zero1[",".join(axes) + ":" + arch]
    got = {}
    for path in _paths(p):
        pl, zl = p, z
        for k in path:
            pl, zl = pl[k], zl[k]
        got["/".join(map(str, path))] = [
            _json_spec(pl.pspec), list(pl.slab_shape),
            _json_spec(zl.pspec), list(zl.slab_shape)]
    assert got == want
    assert any(r[2] != r[0] for r in got.values())  # ZeRO-1 split a moment
