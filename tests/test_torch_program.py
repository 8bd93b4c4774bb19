"""Port's compile side and program format against the JAX reference.

The same numpy params and pattern bits compile in both packages to
bit-equal program arrays; programs saved by either package load in the
other with every array bit-equal; the manifest rules M001–M005 fire on
the same corruptions.
"""

import json
import os

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import sparse as js
from repro.core.pruning import build_dictionaries, magnitude_prune, project_params
from repro.core.mapsearch import MappingSearchConfig as JMappingSearchConfig
from repro.engine import CompileOptions as JCompileOptions
from repro.engine import compile_network as j_compile
from repro.engine import lowering as jlow
from repro.engine import partition_network
from repro.engine import serialize as jser
from repro.models.cnn import conv_weight_names, init_cnn, mini_cnn_config
from repro.obs.trace import Tracer as JTracer

from repro_torch.core import sparse as ts
from repro_torch.core.mapping import MappingCandidate
from repro_torch.core.mapsearch import MappingSearchConfig
from repro_torch.engine import CompileOptions, ProgramFormatError, VerificationError
from repro_torch.engine import compile_network as t_compile
from repro_torch.engine import lowering as tlow
from repro_torch.engine import serialize as tser
from repro_torch.models.cnn import CNNConfig, params_from_numpy
from repro_torch.obs.trace import Tracer

BP_FIELDS = ("w_comp", "block_ids", "nnz", "new_order", "inv_order",
             "dict_masks", "w_scales")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pruned():
    """The JAX tests' recipe (tests/test_engine.py), as numpy."""
    cfg = mini_cnn_config(num_classes=4, input_hw=12, widths=(8, 16, 16))
    params = init_cnn(cfg, jax.random.PRNGKey(0))
    names = conv_weight_names(cfg)
    params = magnitude_prune(params, names, 0.7)
    params, bits = project_params(params, build_dictionaries(params, names, 4))
    params = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, bits


def _tcfg(cfg) -> CNNConfig:
    return CNNConfig(cfg.conv_channels, cfg.pool_after, cfg.num_classes,
                     cfg.input_hw, cfg.kernel)


def _arr(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def _manifest_of(obj):
    """A mapping, partition or certificate as its manifest entry."""
    return None if obj is None else obj.to_manifest()


def assert_bp_equal(a, b):
    assert (a.k_in, a.n_out, a.block, a.tile) == (b.k_in, b.n_out, b.block,
                                                  b.tile)
    for field in BP_FIELDS:
        x, y = _arr(getattr(a, field)), _arr(getattr(b, field))
        if x is None or y is None:
            assert x is None and y is None, field
            continue
        assert x.dtype == y.dtype, (field, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=field)


def assert_programs_equal(a, b):
    assert tuple(a.config.conv_channels) == tuple(b.config.conv_channels)
    assert (a.config.pool_after, a.config.num_classes, a.config.input_hw) == (
        b.config.pool_after, b.config.num_classes, b.config.input_hw)
    assert (a.block, a.tile, a.precision, a.cell_bits) == (
        b.block, b.tile, b.precision, b.cell_bits)
    assert len(a.convs) == len(b.convs)
    for x, y in zip(a.convs, b.convs):
        assert (x.name, x.c_in, x.c_out, x.kernel, x.out_hw, x.pool_after) == (
            y.name, y.c_in, y.c_out, y.kernel, y.out_hw, y.pool_after)
        np.testing.assert_array_equal(x.bias, y.bias)
        np.testing.assert_array_equal(x.pattern_bits, y.pattern_bits)
        assert np.asarray(x.pattern_bits).dtype == np.asarray(
            y.pattern_bits).dtype
        assert_bp_equal(x.bp, y.bp)
        assert _manifest_of(x.mapping) == _manifest_of(y.mapping)
    assert (a.fc.d_in, a.fc.d_out, a.fc.reorder) == (b.fc.d_in, b.fc.d_out,
                                                     b.fc.reorder)
    np.testing.assert_array_equal(a.fc.bias, b.fc.bias)
    assert_bp_equal(a.fc.bp, b.fc.bp)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("block,tile", [(9, 8), (128, 128)])
def test_compile_bit_equal(pruned, precision, block, tile):
    cfg, params, bits = pruned
    jprog = j_compile(cfg, params, bits, options=JCompileOptions(
        block=block, tile=tile, precision=precision))
    tprog = t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                      options=CompileOptions(block=block, tile=tile,
                                             precision=precision),
                      device="cpu")
    assert_programs_equal(tprog, jprog)
    assert tprog.cells_per_weight == jprog.cells_per_weight
    assert tprog.num_ops == jprog.num_ops


def test_compile_recovers_pattern_bits(pruned):
    """Without pattern bits both packages recover them from the weights."""
    cfg, params, _ = pruned
    jprog = j_compile(cfg, params, options=JCompileOptions(block=16, tile=16))
    tprog = t_compile(_tcfg(cfg), params_from_numpy(params),
                      options=CompileOptions(block=16, tile=16), device="cpu")
    assert_programs_equal(tprog, jprog)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("reorder", ts.REORDERS)
@pytest.mark.parametrize("block,tile", [(9, 8), (128, 128)])
def test_lower_matrix_reorders_bit_equal(pruned, reorder, block, tile,
                                         precision):
    assert ts.REORDERS == js.REORDERS
    _, params, _ = pruned
    wm = jlow.conv_matrix(params["conv3"]["w"])
    np.testing.assert_array_equal(tlow.conv_matrix(params["conv3"]["w"]), wm)
    jbp = jlow.lower_matrix(wm, block, tile, precision, reorder=reorder)
    tbp = tlow.lower_matrix(wm, block, tile, precision, reorder=reorder)
    assert_bp_equal(tbp, jbp)
    assert ts.block_density(tbp) == js.block_density(jbp)
    masks = js.nonzero_block_masks(
        np.pad(wm, ((0, (-wm.shape[0]) % block), (0, (-wm.shape[1]) % tile))),
        block,
    )
    order = ts.reorder_columns(masks, reorder)
    np.testing.assert_array_equal(order, js.reorder_columns(masks, reorder))
    np.testing.assert_array_equal(
        ts.predicted_tile_nnz(masks, order, tile),
        js.predicted_tile_nnz(masks, order, tile),
    )


def test_build_block_pattern_projection_bit_equal(rng):
    """The magnitude/projection (masks=None) path is copied exactly."""
    w = rng.normal(size=(512, 384)).astype(np.float32)
    for reorder in ts.REORDERS:
        assert_bp_equal(
            ts.build_block_pattern(w, num_patterns=4, density=0.3,
                                   reorder=reorder),
            js.build_block_pattern(w, num_patterns=4, density=0.3,
                                   reorder=reorder),
        )


@pytest.fixture(scope="module")
def jax_saved(pruned, tmp_path_factory):
    """Programs saved by the reference: fp32, int8 partitioned, and one
    compiled with the mapping search, verification (certificate) and a
    partition, so every optional manifest entry is present."""
    cfg, params, bits = pruned
    root = tmp_path_factory.mktemp("jax_saved")
    progs = {
        "fp32": j_compile(cfg, params, bits),
        "int8": partition_network(
            j_compile(cfg, params, bits,
                      options=JCompileOptions(precision="int8")),
            data=2, model=2),
        "auto": partition_network(
            j_compile(cfg, params, bits, options=JCompileOptions(
                precision="int8", optimize="auto", verify="strict")),
            data=1, model=2),
    }
    assert progs["auto"].certificate is not None
    assert any(c.mapping is not None for c in progs["auto"].convs)
    return {k: (p, jser.save_program(str(root / k), p))
            for k, p in progs.items()}


def _manifest(path):
    with open(os.path.join(path, "program.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["fp32", "int8", "auto"])
def test_jax_saved_loads_bit_equal(jax_saved, kind, tmp_path):
    jprog, path = jax_saved[kind]
    tprog = tser.load_program(path, device="cpu")
    assert_programs_equal(tprog, jprog)
    # mapping, partition and certificate load as the port's objects and
    # round-trip verbatim through a port save, and the re-saved program
    # is the reference's program
    manifest = _manifest(path)
    again = tser.save_program(str(tmp_path / "again"), tprog)
    assert _manifest(again) == manifest
    for c, e in zip(tprog.convs, manifest["convs"]):
        assert _manifest_of(c.mapping) == e["mapping"]
    assert _manifest_of(tprog.partition) == manifest.get("partition")
    assert _manifest_of(tprog.certificate) == manifest.get("certificate")
    assert _manifest_of(tprog.partition) == _manifest_of(jprog.partition)
    assert _manifest_of(tprog.certificate) == _manifest_of(jprog.certificate)
    reloaded = jser.load_program(again, verify=True)
    assert_programs_equal(reloaded, jprog)
    assert reloaded.partition == jprog.partition
    assert (reloaded.certificate is None) == (jprog.certificate is None)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_port_saved_loads_in_jax_verified(pruned, precision, tmp_path):
    cfg, params, bits = pruned
    tprog = t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                      options=CompileOptions(precision=precision),
                      device="cpu")
    path = tser.save_program(str(tmp_path / "prog"), tprog)
    jprog = jser.load_program(path, verify=True)  # raises on any error
    assert_programs_equal(tprog, jprog)
    assert tser.read_manifest(path)["format_version"] == 4


@pytest.fixture
def saved(pruned, tmp_path):
    cfg, params, bits = pruned
    tprog = t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                      options=CompileOptions(precision="int8"), device="cpu")
    return tser.save_program(str(tmp_path / "prog"), tprog)


def _rewrite(path, manifest):
    with open(os.path.join(path, "program.json"), "w") as f:
        json.dump(manifest, f)


def _write(path, name, data, mode="w"):
    with open(os.path.join(path, name), mode) as f:
        f.write(data)


# the corruptions of tests/test_analysis_verify.py's manifest catalog
@pytest.mark.parametrize(
    "corrupt,rule",
    [
        (lambda p: _rewrite(p, {**_manifest(p), "format_version": 99}),
         "M002"),
        (lambda p: _rewrite(
            p, {k: v for k, v in _manifest(p).items() if k != "fc"}
        ), "M003"),
        (lambda p: os.remove(os.path.join(p, "conv1.bias.npy")), "M004"),
        (lambda p: _write(p, "program.json", "{truncated"), "M001"),
        (lambda p: _write(p, "fc.w_comp.npy", b"not-an-npy", "wb"), "M005"),
    ],
    ids=["bad-version", "missing-key", "missing-payload", "truncated-json",
         "corrupt-payload"],
)
def test_corrupt_saved_program(saved, corrupt, rule):
    corrupt(saved)
    with pytest.raises(ProgramFormatError) as ei:
        tser.load_program(saved, device="cpu")
    assert ei.value.rule == rule
    with pytest.raises(jser.ProgramFormatError) as ej:
        jser.load_program(saved)
    assert ej.value.rule == rule


@pytest.mark.parametrize(
    "corrupt",
    [
        lambda m: m["convs"][0].__setitem__("mapping", "hybrid"),
        lambda m: m["convs"][0]["mapping"].pop("rows"),
        lambda m: m["convs"][0]["mapping"].__setitem__("block_order", 5),
        lambda m: m["convs"][0]["mapping"].__setitem__("rows", True),
        lambda m: m["fc"].__setitem__("reorder", 7),
        lambda m: m["certificate"].pop("layers"),
        lambda m: m["certificate"].__setitem__("cell_bits", "4"),
    ],
    ids=["mapping-not-a-dict", "mapping-key-missing",
         "block-order-not-a-string", "rows-bool-not-int",
         "fc-reorder-not-a-string", "certificate-key-missing",
         "certificate-cell-bits-not-int"],
)
def test_corrupt_optional_entries_are_structural(jax_saved, corrupt,
                                                 tmp_path):
    _, path = jax_saved["auto"]
    tprog = tser.load_program(path, device="cpu")
    copy = tser.save_program(str(tmp_path / "copy"), tprog)
    m = _manifest(copy)
    mapped = next(i for i, c in enumerate(m["convs"]) if c["mapping"])
    m["convs"][0], m["convs"][mapped] = m["convs"][mapped], m["convs"][0]
    corrupt(m)
    _rewrite(copy, m)
    with pytest.raises(ProgramFormatError) as ei:
        tser.load_program(copy, device="cpu")
    assert ei.value.rule == "M003"


def test_save_is_atomic_and_old_is_found(saved):
    tprog = tser.load_program(saved, device="cpu")
    assert tser.save_program(saved, tprog) == saved
    assert not os.path.exists(saved + ".tmp")
    assert not os.path.exists(saved + ".old")
    os.replace(saved, saved + ".old")  # a save killed between its renames
    assert_programs_equal(tser.load_program(saved, device="cpu"), tprog)


def test_not_yet_ported_options_raise(saved, tmp_path):
    # load_program verifies by default: a payload corrupted past the
    # manifest checks raises VerificationError with the rule that caught it
    tprog = tser.load_program(saved, device="cpu")
    bad = tser.save_program(str(tmp_path / "bad"), tprog)
    m = _manifest(bad)
    path = os.path.join(bad, m["convs"][0]["bp"]["arrays"]["new_order"])
    order = np.load(path)
    order[0] = order[1]  # no longer a permutation: V101
    np.save(path, order)
    with pytest.raises(VerificationError) as ei:
        tser.load_program(bad, device="cpu")
    assert "V101" in ei.value.report.rules("error")
    assert tser.load_program(bad, verify=False, device="cpu") is not None
    with pytest.raises(ValueError, match="verify must be"):
        CompileOptions(verify="bogus")
    assert CompileOptions(verify="strict").verify == "strict"
    with pytest.raises(ValueError):
        CompileOptions(precision="fp16")
    # the mapping search is ported: the reference's validation
    assert CompileOptions(optimize="auto").optimize == "auto"
    assert CompileOptions(optimize=MappingSearchConfig(seed=2)).optimize.seed == 2
    for bad in ("greedy", 1, JMappingSearchConfig()):
        with pytest.raises(ValueError, match="optimize must be"):
            CompileOptions(optimize=bad)
        if not isinstance(bad, JMappingSearchConfig):
            with pytest.raises(ValueError, match="optimize must be"):
                JCompileOptions(optimize=bad)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("block,tile", [(9, 8), (16, 16)])
def test_searched_compile_bit_equal(pruned, precision, block, tile):
    """``optimize='auto'``: the same candidates per conv, the same FC
    reorder, bit-equal arrays, and the same ``search:*`` span args."""
    cfg, params, bits = pruned
    jtr, ttr = JTracer(), Tracer()
    jprog = j_compile(cfg, params, bits, options=JCompileOptions(
        block=block, tile=tile, precision=precision, optimize="auto",
        tracer=jtr))
    tprog = t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                      options=CompileOptions(block=block, tile=tile,
                                             precision=precision,
                                             optimize="auto", tracer=ttr),
                      device="cpu")
    assert_programs_equal(tprog, jprog)
    assert all(isinstance(c.mapping, MappingCandidate) for c in tprog.convs)

    def search_spans(tr):
        return [(s.name, s.args) for s in tr.spans()
                if s.name.startswith("search:")]

    assert search_spans(ttr) == search_spans(jtr)
    assert len(search_spans(ttr)) == len(tprog.convs) + 1


def test_conv_mapping_search_equal(pruned):
    cfg, params, bits = pruned
    ecfg = tlow.EngineConfig(block=9, tile=8, precision="int8")
    t = tlow.conv_mapping_search(params["conv2"]["w"], bits["conv2"], 6, ecfg)
    j = jlow.conv_mapping_search(params["conv2"]["w"], bits["conv2"], 6,
                                 jlow.EngineConfig(block=9, tile=8,
                                                   precision="int8"))
    assert t.chosen.to_manifest() == j.chosen.to_manifest()
    assert t.fixed.to_manifest() == j.fixed.to_manifest()
    assert (t.evaluations, t.bricks, t.fixed_bricks, t.improved) == (
        j.evaluations, j.bricks, j.fixed_bricks, j.improved)
    assert t.fixed.cells_per_weight == 2


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_port_saved_searched_loads_in_jax_verified(pruned, precision,
                                                   tmp_path):
    cfg, params, bits = pruned
    tprog = t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                      options=CompileOptions(precision=precision, block=16,
                                             tile=16, optimize="auto"),
                      device="cpu")
    path = tser.save_program(str(tmp_path / "prog"), tprog)
    jprog = jser.load_program(path, verify=True)  # raises on any error
    assert_programs_equal(tprog, jprog)
    assert tprog.hardware_report(assumed_skip=0.3) == jprog.hardware_report(
        assumed_skip=0.3)
    again = tser.load_program(path, device="cpu")
    assert_programs_equal(again, tprog)


@pytest.mark.parametrize("kind", ["int8", "auto"])
def test_jax_saved_report_equal(jax_saved, kind):
    """A JAX-saved partitioned program (and one compiled with
    ``verify='strict'``, so it carries a range certificate) prices the
    same in the port: ``chips`` and ``certified_potential`` included."""
    jprog, path = jax_saved[kind]
    tprog = tser.load_program(path, device="cpu")
    jloaded = jser.load_program(path, verify=False)
    for kw in ({}, {"assumed_skip": 0.2, "n_chips": 3}):
        rt = tprog.hardware_report(**kw)
        assert rt == jprog.hardware_report(**kw)
        assert rt == jloaded.hardware_report(**kw)
        assert "chips" in rt
    if kind == "auto":
        cp = tprog.hardware_report()["certified_potential"]
        assert cp["available"] and cp["layers"]
