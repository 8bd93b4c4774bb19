"""The port's static verifier and range certification against the JAX
reference.

The same numpy params compile in both packages (block = tile = 16, the
mini net of ``tests/test_analysis_verify.py``).  Pristine programs
verify clean in both; every mutation of the reference's operand,
quantized, layer and mapping catalogs, applied to both packages'
programs with the same seeds, gives the same diagnostics (rule,
severity, layer, location and message); the range rules V501–V506 fire
in the port as in the reference; certificates equal the reference's bit
for bit; and a program saved by either package passes the other
package's ``verify`` and ``ranges`` CLI.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import ProgramFormatError as JProgramFormatError  # noqa: E402
from repro.analysis import ranges as jranges  # noqa: E402
from repro.analysis import verify as jverify  # noqa: E402
from repro.core.pruning import (  # noqa: E402
    build_dictionaries,
    magnitude_prune,
    project_params,
)
from repro.engine import CompileOptions as JCompileOptions  # noqa: E402
from repro.engine import compile_network as j_compile  # noqa: E402
from repro.engine import serialize as jser  # noqa: E402
from repro.engine.partition import NetworkPartition as JNetworkPartition  # noqa: E402
from repro.models.cnn import conv_weight_names, init_cnn, mini_cnn_config  # noqa: E402

from repro_torch.analysis import diagnostics as tdiag  # noqa: E402
from repro_torch.analysis import ranges as tranges  # noqa: E402
from repro_torch.analysis import verify as tverify  # noqa: E402
from repro_torch.analysis.__main__ import main as tmain  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    CompileOptions,
    EngineConfig,
    ProgramFormatError,
    VerificationError,
)
from repro_torch.engine import compile_network as t_compile  # noqa: E402
from repro_torch.engine import serialize as tser  # noqa: E402
from repro_torch.engine.partition import NetworkPartition  # noqa: E402
from repro_torch.models.cnn import CNNConfig, channel_norm, params_from_numpy  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


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
    """The reference tests' recipe, as numpy."""
    cfg = mini_cnn_config(num_classes=4, input_hw=12, widths=(8, 16, 16))
    params = init_cnn(cfg, jax.random.PRNGKey(0))
    names = conv_weight_names(cfg)
    params = magnitude_prune(params, names, 0.7)
    params, bits = project_params(params, build_dictionaries(params, names, 4))
    return cfg, jax.tree_util.tree_map(np.asarray, params), bits


def _tcfg(cfg) -> CNNConfig:
    return CNNConfig(cfg.conv_channels, cfg.pool_after, cfg.num_classes,
                     cfg.input_hw, cfg.kernel)


def _pair(pruned, **kw):
    """(JAX program, port program) compiled from the same numpy params."""
    cfg, params, bits = pruned
    jprog = j_compile(cfg, params, bits,
                      options=JCompileOptions(block=16, tile=16, **kw))
    tprog = t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                      options=CompileOptions(block=16, tile=16, **kw),
                      device="cpu")
    return jprog, tprog


@pytest.fixture(scope="module")
def fp32(pruned):
    return _pair(pruned, verify="strict")


@pytest.fixture(scope="module")
def int8(pruned):
    return _pair(pruned, precision="int8", verify="strict")


@pytest.fixture(scope="module")
def auto(pruned):
    return _pair(pruned, optimize="auto")


def _diags(report):
    return [(d.rule, d.severity, d.layer, d.location, d.message)
            for d in report]


# ---------------------------------------------------------------- helpers
# A mutator sees host copies of one operand's fields (``h``) and returns
# the fields it replaces; ``_rebuild`` puts them back, as tensors where the
# operand held tensors, so each package's verifier meets its own types.

_ARRAYS = ("w_comp", "block_ids", "nnz", "new_order", "inv_order",
           "dict_masks", "w_scales")


def _host_fields(bp) -> dict:
    h = {"k_in": bp.k_in, "n_out": bp.n_out, "block": bp.block,
         "tile": bp.tile}
    for f in _ARRAYS:
        v = getattr(bp, f)
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        h[f] = None if v is None else np.array(v)  # mutable host copy
    return h


def _rebuild(bp, repl: dict):
    out = {}
    for f, v in repl.items():
        if isinstance(getattr(bp, f), torch.Tensor) and isinstance(
            v, np.ndarray
        ):
            v = torch.as_tensor(v)
        out[f] = v
    return dataclasses.replace(bp, **out)


def _mutate(bp, mutate, seed):
    return _rebuild(bp, mutate(_host_fields(bp), np.random.default_rng(seed)))


def _with_bp(prog, bp):
    conv0 = dataclasses.replace(prog.convs[0], bp=bp)
    return dataclasses.replace(prog, convs=[conv0] + prog.convs[1:])


def _active_slot(h):
    """(tile, slot) of an active brick with nonzero weights."""
    w, nnz = h["w_comp"], h["nnz"]
    for t in range(w.shape[0]):
        for k in range(int(nnz[t])):
            if np.any(w[t, k] != 0):
                return t, k
    raise AssertionError("fixture has no active nonzero brick")


def _mut_perm_duplicate(h, rng):
    order = h["new_order"]
    i, j = rng.choice(len(order), size=2, replace=False)
    order[i] = order[j]  # no longer a bijection
    return {"new_order": order}


def _mut_perm_swap(h, rng):
    order = h["new_order"]
    i, j = rng.choice(len(order), size=2, replace=False)
    order[[i, j]] = order[[j, i]]  # still a bijection, inverse now stale
    return {"new_order": order}


def _mut_geometry(h, rng):
    return {"k_in": h["k_in"] + 1}


def _mut_brick_shape(h, rng):
    return {"w_comp": np.ascontiguousarray(h["w_comp"][:, :, :, :-1])}


def _mut_blockid_oob(h, rng):
    ids = h["block_ids"]
    t = rng.integers(ids.shape[0])
    ids[t, 0] = h["k_in"] // h["block"]  # one past the last row group
    return {"block_ids": ids}


def _mut_nnz_over(h, rng):
    nnz = h["nnz"]
    nnz[rng.integers(len(nnz))] = h["w_comp"].shape[1] + 1
    return {"nnz": nnz}


def _mut_padded_brick(h, rng):
    """One inert padding tile appended (as the reference's
    ``pad_bp_tiles`` appends it), then a nonzero weight planted in it."""
    w = np.pad(h["w_comp"], ((0, 1), (0, 0), (0, 0), (0, 0)))
    w[-1, 0, 0, 0] = 3.0 if h["w_scales"] is None else 3
    out = {"w_comp": w,
           "block_ids": np.pad(h["block_ids"], ((0, 1), (0, 0))),
           "nnz": np.pad(h["nnz"], (0, 1)).astype(np.int32)}
    if h["w_scales"] is not None:
        out["w_scales"] = np.pad(h["w_scales"], ((0, 1), (0, 0)))
    return out


def _mut_dict_masks(h, rng):
    return {"dict_masks": np.ascontiguousarray(h["dict_masks"][:, :-1])}


OPERAND_MUTATIONS = [
    ("perm-not-bijective", _mut_perm_duplicate, {"V101"}),
    ("perm-inverse-stale", _mut_perm_swap, {"V102"}),
    ("geometry-indivisible", _mut_geometry, {"V103"}),
    ("brick-shape", _mut_brick_shape, {"V104"}),
    ("blockid-out-of-bounds", _mut_blockid_oob, {"V105"}),
    ("nnz-over-capacity", _mut_nnz_over, {"V106"}),
    ("padded-brick-nonzero", _mut_padded_brick, {"V107"}),
    ("dict-mask-shape", _mut_dict_masks, {"V109"}),
]


def _mut_scale_shape(h, rng):
    return {"w_scales": np.ascontiguousarray(h["w_scales"][:, :-1])}


def _mut_scale_nan(h, rng):
    s = h["w_scales"]
    s[_active_slot(h)] = np.nan
    return {"w_scales": s}


def _mut_scale_zero(h, rng):
    s = h["w_scales"]
    s[_active_slot(h)] = 0.0  # silently drops a nonzero brick
    return {"w_scales": s}


def _mut_dtype(h, rng):
    return {"w_comp": h["w_comp"].astype(np.float32)}


def _mut_minus_128(h, rng):
    w = h["w_comp"]
    t, k = _active_slot(h)
    w[t, k, 0, 0] = -128  # out of symmetric range AND breaks cell slicing
    return {"w_comp": w}


QUANT_MUTATIONS = [
    ("scale-shape", _mut_scale_shape, {"V110"}),
    ("scale-nan", _mut_scale_nan, {"V111"}),
    ("scale-zero-drops-brick", _mut_scale_zero, {"V112"}),
    ("quant-dtype", _mut_dtype, {"V113"}),
    ("minus-128-range-and-roundtrip", _mut_minus_128, {"V113", "V114"}),
]


# ---------------------------------------------------------------- verify


def test_program_format_error_is_one_class(tmp_path):
    assert tser.ProgramFormatError is tdiag.ProgramFormatError
    assert ProgramFormatError is tdiag.ProgramFormatError
    with pytest.raises(tdiag.ProgramFormatError) as ei:
        tser.load_program(str(tmp_path / "missing"), device="cpu")
    assert ei.value.rule == "M001"


@pytest.mark.parametrize("which", ["fp32", "int8", "auto"])
def test_pristine_programs_verify_clean_in_both(request, which):
    jprog, tprog = request.getfixturevalue(which)
    assert jverify.verify_network(jprog).clean
    report = tverify.verify_network(tprog)
    assert report.clean, report.format()
    assert tprog.verify(strict=True).clean


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,mutate,expected", OPERAND_MUTATIONS,
                         ids=[m[0] for m in OPERAND_MUTATIONS])
def test_operand_mutation_same_diagnostics(fp32, name, mutate, expected,
                                           seed):
    jprog, tprog = fp32
    jbp = _mutate(jprog.convs[0].bp, mutate, seed)
    tbp = _mutate(tprog.convs[0].bp, mutate, seed)
    want = jverify.verify_bp(jbp, layer="conv1")
    got = tverify.verify_bp(tbp, layer="conv1")
    assert got.rules("error") == expected, got.format()
    assert _diags(got) == _diags(want)
    # the same corruption caught at network level, and by strict verify
    tbad = _with_bp(tprog, tbp)
    assert _diags(tverify.verify_network(tbad)) == _diags(
        jverify.verify_network(_with_bp(jprog, jbp)))
    with pytest.raises(VerificationError) as ei:
        tbad.verify(strict=True)
    assert ei.value.report.rules("error") >= expected


@pytest.mark.parametrize("name,mutate,expected", QUANT_MUTATIONS,
                         ids=[m[0] for m in QUANT_MUTATIONS])
def test_quantized_mutation_same_diagnostics(int8, name, mutate, expected):
    jprog, tprog = int8
    jbp = _mutate(jprog.convs[0].bp, mutate, 0)
    tbp = _mutate(tprog.convs[0].bp, mutate, 0)
    assert isinstance(tbp.w_comp, torch.Tensor)
    got = tverify.verify_bp(tbp, layer="conv1")
    assert got.rules("error") == expected, got.format()
    assert _diags(got) == _diags(jverify.verify_bp(jbp, layer="conv1"))


def _nan_weight(h, rng):
    w = h["w_comp"]
    w[_active_slot(h) + (0, 0)] = np.nan
    return {"w_comp": w}


def _swap_first_ids(h, rng):
    tiles = np.flatnonzero(h["nnz"] >= 2)
    ids = h["block_ids"]
    ids[tiles[0], [0, 1]] = ids[tiles[0], [1, 0]]  # non-canonical order
    return {"block_ids": ids}


@pytest.mark.parametrize("mutate,rules", [(_nan_weight, {"V115"}),
                                          (_swap_first_ids, {"V108"})],
                         ids=["fp32-nonfinite", "blockid-order-warning"])
def test_fp32_payload_mutations_same_diagnostics(fp32, mutate, rules):
    jprog, tprog = fp32
    conv = next(i for i, c in enumerate(tprog.convs)
                if (np.asarray(c.bp.nnz) >= 2).any())
    jbp = _mutate(jprog.convs[conv].bp, mutate, 0)
    tbp = _mutate(tprog.convs[conv].bp, mutate, 0)
    got = tverify.verify_bp(tbp, layer="x")
    assert got.rules() == rules, got.format()
    assert _diags(got) == _diags(jverify.verify_bp(jbp, layer="x"))


def _conv0(prog, **kw):
    conv0 = dataclasses.replace(prog.convs[0], **kw)
    return dataclasses.replace(prog, convs=[conv0] + prog.convs[1:])


def _bits_out_of_window(prog):
    bits = np.array(prog.convs[0].pattern_bits)
    bits[0, 0] = 1 << (prog.convs[0].kernel ** 2)  # one past the window
    return _conv0(prog, pattern_bits=bits)


def _fc_d_out(prog):
    fc = dataclasses.replace(
        prog.fc, d_out=prog.fc.d_out + 1,
        bias=np.zeros(prog.fc.d_out + 1, np.float32))
    return dataclasses.replace(prog, fc=fc)


def _fc_reorder(prog):
    return dataclasses.replace(
        prog, fc=dataclasses.replace(prog.fc, reorder="bogus"))


NETWORK_MUTATIONS = [
    ("pattern-bits-window", _bits_out_of_window, {"V202"}),
    ("pattern-bits-shape", lambda p: _conv0(
        p, pattern_bits=np.array(p.convs[0].pattern_bits)[:, :0]), {"V201"}),
    ("bias-shape", lambda p: _conv0(p, bias=p.convs[0].bias[:-1]), {"V204"}),
    ("bias-nonfinite", lambda p: _conv0(
        p, bias=np.full_like(p.convs[0].bias, np.inf)), {"V204"}),
    ("layer-chain", _fc_d_out, {"V301"}),
    ("precision-contract", lambda p: dataclasses.replace(
        p, precision="int8"), {"V302"}),
    ("program-tile", lambda p: dataclasses.replace(p, tile=8), {"V303"}),
    ("fc-reorder-tag", _fc_reorder, {"V205"}),
]


@pytest.mark.parametrize("name,mutate,expected", NETWORK_MUTATIONS,
                         ids=[m[0] for m in NETWORK_MUTATIONS])
def test_network_mutation_same_diagnostics(fp32, name, mutate, expected):
    jprog, tprog = fp32
    got = tverify.verify_network(mutate(tprog))
    assert got.rules("error") == expected, got.format()
    assert _diags(got) == _diags(jverify.verify_network(mutate(jprog)))


MAPPING_MUTATIONS = [
    ("bad-block-order-tag", dict(block_order="bogus"), {"V205"}),
    ("bad-reorder-tag", dict(reorder="zigzag"), {"V205"}),
    ("non-positive-rows", dict(rows=0), {"V205"}),
    ("non-positive-ou-cols", dict(ou_cols=-8), {"V205"}),
    ("ou-taller-than-crossbar", dict(ou_rows=4096, rows=512), {"V206"}),
    ("ou-wider-than-crossbar", dict(ou_cols=4096, cols=512), {"V206"}),
    ("cells-exceed-row", dict(cells_per_weight=10**6), {"V206"}),
    ("ou-below-tallest-pattern", dict(ou_rows=1), {"V206"}),
]


@pytest.mark.parametrize("name,fields,expected", MAPPING_MUTATIONS,
                         ids=[m[0] for m in MAPPING_MUTATIONS])
def test_mapping_mutation_same_diagnostics(auto, name, fields, expected):
    jprog, tprog = auto

    def mutate(prog):
        mapped = dataclasses.replace(prog.convs[0].mapping, **fields)
        return _conv0(prog, mapping=mapped)

    got = tverify.verify_network(mutate(tprog))
    assert got.rules("error") == expected, got.format()
    assert _diags(got) == _diags(jverify.verify_network(mutate(jprog)))


@pytest.mark.parametrize("part,rules", [
    (dict(data=2, model=2, data_axis="x", model_axis="x"), {"V403"}),
    (dict(data=2, model=2, data_axis="", model_axis="m"), {"V403"}),
    (dict(data=2, model=4), set()),
    (dict(data=1, model=0), {"V401"}),
])
def test_partition_same_diagnostics(fp32, part, rules):
    jprog, tprog = fp32
    model = part.pop("model")

    def make(cls):
        p = cls(model=max(model, 1), **part)
        object.__setattr__(p, "model", model)  # bypass __post_init__
        return p

    got = tverify.verify_partition(tprog, make(NetworkPartition))
    assert got.rules("error") == rules, got.format()
    assert _diags(got) == _diags(
        jverify.verify_partition(jprog, make(JNetworkPartition)))
    if rules == set():
        assert tverify.verify_network(dataclasses.replace(
            tprog, partition=make(NetworkPartition))).clean


# ---------------------------------------------------------------- wiring


def test_compile_options_verify_and_from_engine_config(pruned):
    cfg, params, bits = pruned
    ecfg = EngineConfig(block=16, tile=16, precision="int8", cell_bits=2)
    opts = CompileOptions.from_engine_config(ecfg, verify="warn")
    assert (opts.block, opts.tile, opts.precision, opts.cell_bits,
            opts.verify) == (16, 16, "int8", 2, "warn")
    assert opts.engine_config() == ecfg
    with pytest.raises(ValueError, match="verify must be"):
        CompileOptions(verify="bogus")
    with pytest.raises(ValueError, match="verify must be"):
        CompileOptions.from_engine_config(ecfg, verify=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        prog = t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                         options=opts, device="cpu")
    assert prog.certificate is not None and prog.cell_bits == 2
    assert t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                     options=CompileOptions(block=16, tile=16),
                     device="cpu").certificate is None


def test_compile_strict_raises_and_warn_warns(pruned, monkeypatch):
    cfg, params, bits = pruned
    from repro_torch.engine import lowering

    real = lowering.lower_fc

    def bad_fc(*args, **kwargs):
        fc = real(*args, **kwargs)
        return dataclasses.replace(
            fc, bias=np.full_like(fc.bias, np.nan))  # V204

    monkeypatch.setattr(lowering, "lower_fc", bad_fc)
    tparams = params_from_numpy(params)
    with pytest.raises(VerificationError) as ei:
        t_compile(_tcfg(cfg), tparams, bits, device="cpu",
                  options=CompileOptions(block=16, tile=16, verify="strict"))
    assert ei.value.report.rules("error") == {"V204"}
    with pytest.warns(UserWarning, match="fails verification"):
        prog = t_compile(_tcfg(cfg), tparams, bits, device="cpu",
                         options=CompileOptions(block=16, tile=16,
                                                verify="warn"))
    assert prog.certificate is None  # ranges run on sound programs only


def test_compile_records_verify_and_ranges_spans(pruned):
    cfg, params, bits = pruned
    tr = Tracer()
    prog = t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                     device="cpu",
                     options=CompileOptions(block=16, tile=16,
                                            precision="int8",
                                            verify="strict", tracer=tr))
    names = [s.name for s in tr.spans("compile")]
    assert names.count("verify") == 1 and names.count("ranges") == 1
    assert names.index("verify") < names.index("ranges")
    ranges = next(s for s in tr.spans("compile") if s.name == "ranges")
    assert ranges.args["fp32_safe"] is True
    assert ranges.args["certified_cells"] == prog.certificate.certified_cells()


# ---------------------------------------------------------------- ranges


def test_norm_eps_matches_channel_norm_default():
    default = inspect.signature(channel_norm).parameters["eps"].default
    assert default == tranges.NORM_EPS == jranges.NORM_EPS
    assert tranges.DEFAULT_INPUT_RANGE == jranges.DEFAULT_INPUT_RANGE


@pytest.mark.parametrize("which", ["fp32", "int8"])
@pytest.mark.parametrize("input_range", [None, (-1.0, 0.5), (-1e38, 1e38)])
def test_certificates_equal_reference_bit_for_bit(request, which,
                                                  input_range):
    jprog, tprog = request.getfixturevalue(which)
    # the compile-attached certificates
    assert tprog.certificate.to_manifest() == jprog.certificate.to_manifest()
    kw = {} if input_range is None else {"input_range": input_range}
    jr, jc = jranges.analyze_network(jprog, **kw)
    tr, tc = tranges.analyze_network(tprog, **kw)
    assert tc.to_manifest() == jc.to_manifest()
    assert _diags(tr) == _diags(jr)


def _with_scale(prog, value):
    bp = prog.convs[0].bp
    h = _host_fields(bp)
    s = h["w_scales"]
    s[_active_slot(h)] = value
    return _with_bp(prog, _rebuild(bp, {"w_scales": s}))


def _shrunk(prog):
    h = _host_fields(prog.convs[0].bp)
    return _with_bp(prog, _rebuild(prog.convs[0].bp,
                                   {"w_comp": np.clip(h["w_comp"], -7, 7)}))


def _inf_bias(prog):
    bias = np.array(prog.convs[0].bias)
    bias[0] = np.inf
    return _conv0(prog, bias=bias)


RANGE_MUTATIONS = [
    # 1e35 folds past fp32 max in the accumulator but stays below V502's
    # saturation threshold (1e35 * 127 < fp32 max)
    ("v501-inflated-scale", "int8", lambda p: _with_scale(p, 1e35), {},
     {"V501"}, False),
    ("v502-saturating-scale", "int8", lambda p: _with_scale(p, 1e38), {},
     {"V502"}, False),
    ("v502-denormal-scale", "int8", lambda p: _with_scale(p, 1e-40), {},
     {"V502"}, False),
    ("v503-dead-scale", "int8", lambda p: _with_scale(p, 0.0), {},
     {"V503"}, True),
    ("v504-nonfinite-bias", "fp32", _inf_bias, {}, {"V504"}, False),
    ("v504-fp32-exceedance", "fp32", lambda p: p,
     {"input_range": (-1e38, 1e38)}, {"V504"}, True),
    ("v505-unreachable-cells", "int8", _shrunk, {}, {"V505"}, True),
]


@pytest.mark.parametrize("name,which,mutate,kw,rules,ok", RANGE_MUTATIONS,
                         ids=[m[0] for m in RANGE_MUTATIONS])
def test_range_rules_fire_in_the_port(request, name, which, mutate, kw,
                                      rules, ok):
    jprog, tprog = request.getfixturevalue(which)
    report, cert = tranges.analyze_network(mutate(tprog), **kw)
    assert rules <= report.rules(), report.format()
    assert report.ok == ok
    jreport, jcert = jranges.analyze_network(mutate(jprog), **kw)
    assert _diags(report) == _diags(jreport)
    assert json.dumps(cert.to_manifest()) == json.dumps(jcert.to_manifest())
    if name == "v501-inflated-scale":
        assert "V502" not in report.rules()  # overflow on its own evidence
    if name == "v505-unreachable-cells":
        entry = cert.layer("conv1")
        assert (entry.certified_cells, entry.stored_cells) == (1, 2)
    if name.startswith("v504"):
        assert not cert.fp32_safe


def _corrupt_certificate(directory):
    path = os.path.join(directory, "program.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["certificate"]["layers"][0]["act_hi"] *= 2.0
    with open(path, "w") as f:
        json.dump(manifest, f)


def test_v506_stale_certificate_and_round_trip(int8, tmp_path):
    _, tprog = int8
    d = tser.save_program(str(tmp_path / "prog"), tprog)
    loaded = tser.load_program(d, device="cpu")  # verifies by default
    assert loaded.certificate.to_manifest() == tprog.certificate.to_manifest()
    report, cert = tranges.analyze_saved(d)
    assert report.clean, report.format()
    assert cert.to_manifest() == tprog.certificate.to_manifest()
    _corrupt_certificate(d)
    report, _ = tranges.analyze_saved(d)
    assert "V506" in report.rules("error"), report.format()


def test_cli_exit_codes(int8, fp32, tmp_path, capsys):
    d = tser.save_program(str(tmp_path / "prog"), int8[1])
    clean_py = tmp_path / "clean.py"
    clean_py.write_text("def f(x):\n    return x\n")
    assert tmain(["verify", d]) == 0
    capsys.readouterr()
    assert tmain(["ranges", d, "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["certificate"] == int8[1].certificate.to_manifest()
    assert tmain(["all", d, "--paths", str(clean_py)]) == 0
    assert json.loads(capsys.readouterr().out)["exit_code"] == 0

    _corrupt_certificate(d)  # V506 (ranges)
    dirty_py = tmp_path / "dirty.py"
    dirty_py.write_text("def f(x, acc=[]):\n    return acc\n")  # L003
    assert tmain(["ranges", d]) == 1
    capsys.readouterr()
    assert tmain(["all", d, "--paths", str(dirty_py)]) == 6
    merged = json.loads(capsys.readouterr().out)
    assert merged["exit_code"] == 6 and merged["verify"]["ok"] is True

    d32 = tser.save_program(str(tmp_path / "p32"), fp32[1])
    capsys.readouterr()
    assert tmain(["ranges", d32, "--json", "--input-lo=-1e38",
                  "--input-hi", "1e38"]) == 0  # V504 exceedance warns
    payload = json.loads(capsys.readouterr().out)
    assert payload["certificate"]["fp32_safe"] is False
    with pytest.raises(SystemExit):
        tmain(["ranges", d32, "--input-lo", "0"])


def _cli(package, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    code = (f"import sys; from {package}.analysis.__main__ import main; "
            f"rc = [main(a) for a in {[list(a) for a in args]!r}]; "
            "print('RC', rc); sys.exit(max(rc))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)


def test_programs_pass_the_other_package_cli(fp32, int8, tmp_path):
    """A program saved by the port passes the reference's ``verify`` and
    ``ranges`` CLI, and one saved by the reference passes the port's."""
    dirs = {}
    for (jprog, tprog), prec in ((fp32, "fp32"), (int8, "int8")):
        dirs[f"port_{prec}"] = tser.save_program(
            str(tmp_path / f"port_{prec}"), tprog)
        dirs[f"jax_{prec}"] = jser.save_program(
            str(tmp_path / f"jax_{prec}"), jprog)
    port_saved = [d for k, d in dirs.items() if k.startswith("port")]
    jax_saved = [d for k, d in dirs.items() if k.startswith("jax")]
    for package, saved in (("repro", port_saved), ("repro_torch", jax_saved)):
        out = _cli(package, *[(cmd, d, "--json") for d in saved
                              for cmd in ("verify", "ranges")])
        assert out.returncode == 0, (package, out.stdout[-2000:],
                                     out.stderr[-2000:])
        assert "RC [0, 0, 0, 0]" in out.stdout
    # the two packages' passes agree on every saved program
    for d in dirs.values():
        jr, jc = jranges.analyze_saved(d)
        tr, tc = tranges.analyze_saved(d)
        assert tr.clean and jr.clean
        assert tc.to_manifest() == jc.to_manifest()
        assert _diags(tverify.verify_saved(d)) == _diags(
            jverify.verify_saved(d))


def test_manifest_rules_same_diagnostics(fp32, tmp_path):
    d = tser.save_program(str(tmp_path / "prog"), fp32[1])
    path = os.path.join(d, "program.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["format_version"] = 99
    with open(path, "w") as f:
        json.dump(manifest, f)
    got = tverify.verify_saved(d)
    assert got.rules() == {"M002"}
    assert [(x.rule, x.severity, x.message) for x in got] == [
        (x.rule, x.severity, x.message) for x in jverify.verify_saved(d)]
    with pytest.raises(ProgramFormatError) as ei:
        tser.load_program(d, device="cpu")
    assert ei.value.rule == "M002"
    assert not isinstance(ei.value, JProgramFormatError)  # one per package
