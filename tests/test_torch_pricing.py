"""The port's crossbar side against the JAX reference, on the CPU.

Mapping, OU schedules, index streams, the simulator, the mapping search
and ``hardware_report`` are host numpy copied from the reference, so the
same inputs must give the same numbers exactly: placements and counts
equal, float sums ``==`` with no tolerance, reports dict-equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import crossbar as jxb
from repro.core import indexing as jidx
from repro.core import mapping as jmap
from repro.core import mapsearch as jms
from repro.core import ou as jou
from repro.core import quantize as jq
from repro.core import simulator as jsim
from repro.core import sparse as js
from repro.core import synthetic as jsyn
from repro.core.pruning import build_dictionaries, magnitude_prune, project_params
from repro.engine import CompileOptions as JCompileOptions
from repro.engine import compile_network as j_compile
from repro.engine import make_forward as j_forward
from repro.models.cnn import conv_weight_names, init_cnn, mini_cnn_config

from repro_torch.core import crossbar as txb
from repro_torch.core import indexing as tidx
from repro_torch.core import mapping as tmap
from repro_torch.core import mapsearch as tms
from repro_torch.core import ou as tou
from repro_torch.core import quantize as tq
from repro_torch.core import simulator as tsim
from repro_torch.core import sparse as ts
from repro_torch.core import synthetic as tsyn
from repro_torch.engine import CompileOptions, InferenceService
from repro_torch.engine import compile_network as t_compile
from repro_torch.engine import make_forward as t_forward
from repro_torch.engine.partition import NetworkPartition
from repro_torch.models.cnn import CNNConfig, params_from_numpy

# (c_in, c_out, out_hw): small layers with VGG16's Table-II statistics
SHAPES = [(3, 16, 8), (16, 24, 4), (24, 40, 2)]
GEOMETRIES = [tmap.CrossbarConfig(),
              tmap.CrossbarConfig(rows=64, cols=64, cells_per_weight=2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(seed=0):
    """(port, reference) SyntheticLayer pairs holding the same arrays."""
    stats = tsyn.TABLE_II["cifar10"]
    rng = np.random.default_rng(seed)
    out = []
    for i, (ci, co, hw) in enumerate(SHAPES):
        spec = tsyn.LayerSpec(f"conv{i + 1}", ci, co, hw)
        t = tsyn.synthesize_layer(spec, n_patterns=8,
                                  zero_ratio=stats.zero_pattern_ratio,
                                  target_sparsity=stats.sparsity, rng=rng)
        j = jsyn.SyntheticLayer(
            spec=jsyn.LayerSpec(spec.name, ci, co, hw),
            pdict=jsyn.PatternDict(k=9, patterns=t.pdict.patterns),
            pattern_bits=t.pattern_bits.copy(), weights=t.weights.copy())
        out.append((t, j))
    return out


LAYERS = _layers()


def _jcfg(cfg):
    return jmap.CrossbarConfig(**dataclasses.asdict(cfg))


def _cand(c):
    return c.to_manifest()


def _placements(mapping):
    return [(p.block.channel, p.block.pattern, p.block.height,
             p.block.kernel_ids, p.crossbar, p.row0, p.col0, p.width_cells)
            for p in mapping.placements]


def _sched(s):
    return [np.asarray(getattr(s, f)) for f in
            ("crossbar", "wordlines", "bitlines", "channel", "pattern")]


def _assert_sched_equal(a, b):
    for x, y in zip(_sched(a), _sched(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("order", tmap.BLOCK_ORDERS)
@pytest.mark.parametrize("geom", range(len(GEOMETRIES)))
@pytest.mark.parametrize("li", range(len(SHAPES)))
def test_mapping_schedule_and_index_equal(li, geom, order):
    t, j = LAYERS[li]
    cfg = GEOMETRIES[geom]
    tm = tmap.map_layer(t.pattern_bits, cfg, 9, order)
    jm = jmap.map_layer(j.pattern_bits, _jcfg(cfg), 9, order)
    assert _placements(tm) == _placements(jm)
    for f in ("num_crossbars", "cells_used", "cells_wasted", "stored_kernels",
              "total_kernels", "cells_total", "utilization"):
        assert getattr(tm, f) == getattr(jm, f), f
    _assert_sched_equal(tou.pattern_ou_schedule(tm), jou.pattern_ou_schedule(jm))
    spec = t.spec
    tn = tmap.map_layer_naive(spec.c_out, spec.c_in, 9, cfg)
    jn = jmap.map_layer_naive(spec.c_out, spec.c_in, 9, _jcfg(cfg))
    assert (tn.num_crossbars, tn.cells_total) == (jn.num_crossbars,
                                                   jn.cells_total)
    _assert_sched_equal(tou.naive_ou_schedule(tn), jou.naive_ou_schedule(jn))
    ts_, js_ = tidx.build_index_stream(tm), tidx.build_index_stream(jm)
    assert dataclasses.asdict(ts_) == dataclasses.asdict(js_)
    assert tidx.index_overhead_bits(ts_) == jidx.index_overhead_bits(js_)
    assert ([(p.crossbar, p.row0, p.col0, p.width_cells)
             for p in tidx.decode_placements(ts_, cfg)]
            == [(p.crossbar, p.row0, p.col0, p.width_cells)
                for p in jidx.decode_placements(js_, _jcfg(cfg))])


def test_pattern_similarity_rank_and_energy_equal(rng):
    pats = rng.integers(0, 512, size=40)
    assert (tmap._pattern_similarity_rank(pats)
            == jmap._pattern_similarity_rank(pats))
    wl, bl = rng.integers(1, 10, 50), rng.integers(1, 9, 50)
    cnt = rng.random(50)
    np.testing.assert_array_equal(txb.ou_energy(wl, bl), jxb.ou_energy(wl, bl))
    assert (txb.EnergyModel().breakdown(wl, bl, cnt)
            == jxb.EnergyModel().breakdown(wl, bl, cnt))


def _layer_result(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("li", range(len(SHAPES)))
def test_simulate_layer_multi_and_mapping_cost_equal(li):
    t, j = LAYERS[li]
    zt = tsim.forward_zero_stats([lt for lt, _ in LAYERS], 8, n_windows=64)
    zj = jsim.forward_zero_stats([lj for _, lj in LAYERS], 8, n_windows=64)
    np.testing.assert_array_equal(zt[li], zj[li])
    probs = {(c, int(p)): 0.1 * ((c + int(p)) % 7)
             for c in range(t.spec.c_in) for p in np.unique(t.pattern_bits)}
    src_t = {"none": None, "assumed": 0.25, "stats": zt[li],
             "dist": tsim.SkipDistribution(probs=probs, windows=64,
                                           default=0.05)}
    src_j = {"none": None, "assumed": 0.25, "stats": zj[li],
             "dist": jsim.SkipDistribution(probs=probs, windows=64,
                                           default=0.05)}
    small = tmap.CrossbarConfig(rows=128, cols=256)
    for kw_t, kw_j in (
        ({}, {}),
        ({"config": small, "block_order": "hybrid",
          "naive_config": tmap.CrossbarConfig(), "naive_skips": True},
         {"config": _jcfg(small), "block_order": "hybrid",
          "naive_config": jmap.CrossbarConfig(), "naive_skips": True}),
    ):
        rt = tsim.simulate_layer_multi(t, src_t, **kw_t)
        rj = jsim.simulate_layer_multi(j, src_j, **kw_j)
        assert {k: _layer_result(v) for k, v in rt.items()} == {
            k: _layer_result(v) for k, v in rj.items()}
    for order in tmap.BLOCK_ORDERS:
        cand = tmap.MappingCandidate(rows=256, cols=128, block_order=order)
        jcand = jmap.MappingCandidate(rows=256, cols=128, block_order=order)
        assert (dataclasses.asdict(tsim.mapping_cost(t.pattern_bits, cand, 16))
                == dataclasses.asdict(
                    jsim.mapping_cost(j.pattern_bits, jcand, 16)))


def test_drift_table_equal():
    pred = {"conv1": 100.0, "conv2": 300.0, "conv3": 0.0, "conv4": 5.0}
    meas = {"conv1": 1e-3, "conv2": 2.5e-3, "conv3": 1e-4, "fc": 1e-5}
    assert tsim.drift_table(pred, meas) == jsim.drift_table(pred, meas)


def _search_result(r):
    return {
        "chosen": _cand(r.chosen), "cost": dataclasses.asdict(r.cost),
        "bricks": r.bricks, "fixed": _cand(r.fixed),
        "fixed_cost": dataclasses.asdict(r.fixed_cost),
        "fixed_bricks": r.fixed_bricks, "improved": r.improved,
        "evaluations": r.evaluations,
        "visited": [_cand(c) for c in r.visited],
    }


SEARCHES = {
    "default": ({}, {}),
    "seed3_int8": ({"seed": 3, "restarts": 3}, {"cells_per_weight": 2}),
    "exhaustive_small": ({"exhaustive": True,
                          "crossbar_dims": ((128, 128), (64, 128)),
                          "block_orders": ("pattern", "hybrid")}, {}),
}


@pytest.mark.parametrize("name", list(SEARCHES))
@pytest.mark.parametrize("li", range(len(SHAPES)))
def test_search_layer_mapping_equal(li, name):
    t, j = LAYERS[li]
    search_kw, fixed_kw = SEARCHES[name]
    w = t.weights.reshape(t.spec.c_out, -1).T  # [C_in*9, C_out]
    wp = np.pad(w, ((0, (-w.shape[0]) % 16), (0, (-w.shape[1]) % 8)))
    masks = ts.nonzero_block_masks(wp, 16)
    np.testing.assert_array_equal(masks, js.nonzero_block_masks(wp, 16))
    rt = tms.search_layer_mapping(
        t.pattern_bits, windows=t.spec.out_hw ** 2,
        fixed=tmap.MappingCandidate(**fixed_kw),
        search=tms.MappingSearchConfig(**search_kw), masks=masks, tile=8)
    rj = jms.search_layer_mapping(
        j.pattern_bits, windows=j.spec.out_hw ** 2,
        fixed=jmap.MappingCandidate(**fixed_kw),
        search=jms.MappingSearchConfig(**search_kw), masks=masks, tile=8)
    assert _search_result(rt) == _search_result(rj)
    assert rt.evaluations > 1


def test_choose_fc_reorder_and_search_config_equal(rng):
    w = rng.normal(size=(64, 40)) * (rng.random((64, 40)) < 0.3)
    masks = ts.nonzero_block_masks(w.astype(np.float32), 8)
    assert (tms.choose_fc_reorder(masks, tile=8)
            == jms.choose_fc_reorder(masks, tile=8))
    for bad in ({"crossbar_dims": ((0, 8),)}, {"block_orders": ("zigzag",)},
                {"reorders": ()}, {"max_passes": 0}):
        with pytest.raises(ValueError):
            tms.MappingSearchConfig(**bad)
        with pytest.raises(ValueError):
            jms.MappingSearchConfig(**bad)


def test_cell_helpers_equal(rng):
    mags = rng.integers(0, 128, size=200)
    for bits in (1, 2, 3, 4, 8):
        np.testing.assert_array_equal(tq.cells_for_magnitude(mags, bits),
                                      jq.cells_for_magnitude(mags, bits))
    q = rng.integers(-127, 128, size=(6, 9)).astype(np.int8)
    for bits in (2, 3, 4):
        sl = tq.cell_slices(q, bits)
        np.testing.assert_array_equal(sl, jq.cell_slices(q, bits))
        np.testing.assert_array_equal(tq.compose_cell_slices(sl, bits), q)
    with pytest.raises(ValueError):
        tq.cells_for_magnitude(128)


# --- hardware_report on compiled programs ----------------------------------


@pytest.fixture(scope="module")
def pruned():
    """The JAX tests' recipe (tests/test_engine.py), as numpy."""
    cfg = mini_cnn_config(num_classes=4, input_hw=12, widths=(8, 16, 16))
    params = init_cnn(cfg, jax.random.PRNGKey(0))
    names = conv_weight_names(cfg)
    params = magnitude_prune(params, names, 0.7)
    params, bits = project_params(params, build_dictionaries(params, names, 4))
    params = jax.tree_util.tree_map(np.asarray, params)
    images = np.random.default_rng(5).normal(size=(6, 1, 12, 12)).astype(
        np.float32)
    return cfg, params, bits, images


def _tcfg(cfg) -> CNNConfig:
    return CNNConfig(cfg.conv_channels, cfg.pool_after, cfg.num_classes,
                     cfg.input_hw, cfg.kernel)


PROGRAMS = {
    "fixed": dict(),
    "searched": dict(optimize="auto"),
    "int8": dict(precision="int8"),
    "int8_searched": dict(precision="int8", optimize="auto"),
}


@pytest.fixture(scope="module")
def programs(pruned):
    cfg, params, bits, _ = pruned
    out = {}
    for name, kw in PROGRAMS.items():
        out[name] = (
            t_compile(_tcfg(cfg), params_from_numpy(params), bits,
                      options=CompileOptions(block=16, tile=16, **kw),
                      device="cpu"),
            j_compile(cfg, params, bits,
                      options=JCompileOptions(block=16, tile=16, **kw)),
        )
    return out


def _stats(pruned, tprog, jprog):
    images = pruned[3]
    _, tst = t_forward(tprog, collect_stats=True, device="cpu")(images)
    _, jst = j_forward(jprog, collect_stats=True, backend="xla")(images)
    return tst, jst


OBSERVED = {"conv1": 2e-4, "conv2": 5e-4, "conv3": 1e-4, "fc": 3e-5}
VARIANTS = {
    "plain": lambda st: {},
    "assumed_skip": lambda st: {"assumed_skip": 0.4},
    "measured": lambda st: {"skip_stats": st},
    "measured_and_assumed": lambda st: {"skip_stats": st,
                                        "assumed_skip": 0.4},
    "measured_distributions": lambda st: {"skip_stats":
                                          st.to_distributions()},
    "observed": lambda st: {"skip_stats": st, "observed": OBSERVED},
    "n_chips_2": lambda st: {"n_chips": 2, "assumed_skip": 0.1},
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("prog", list(PROGRAMS))
def test_hardware_report_equal(pruned, programs, prog, variant):
    tprog, jprog = programs[prog]
    tst, jst = _stats(pruned, tprog, jprog)
    rt = tprog.hardware_report(**VARIANTS[variant](tst))
    rj = jprog.hardware_report(**VARIANTS[variant](jst))
    assert rt == rj
    assert rt["mapping"]["optimized"] == ("optimize" in PROGRAMS[prog])


def test_report_partition_and_weight_bytes_equal(programs):
    tprog, jprog = programs["int8_searched"]
    assert tprog.weight_bytes() == jprog.weight_bytes()
    assert tprog.op_list() == jprog.op_list()
    from repro.engine.partition import NetworkPartition as JPartition

    tp = dataclasses.replace(tprog, partition=NetworkPartition(data=2,
                                                               model=2))
    jp = dataclasses.replace(jprog, partition=JPartition(data=2, model=2))
    rt, rj = tp.hardware_report(), jp.hardware_report()
    assert rt == rj and rt["chips"]["n_chips"] == 4


def test_service_report_prices_served_traffic(pruned, programs):
    """``InferenceService.hardware_report`` prices exactly the skip
    statistics of the requests it served: equal to the reference priced
    on a one-shot stats forward over the same images."""
    tprog, jprog = programs["searched"]
    images = pruned[3]
    svc = InferenceService(tprog, batch_slots=4, collect_stats=True,
                           device="cpu")
    svc.classify(images)
    _, jst = j_forward(jprog, collect_stats=True, backend="xla")(images)
    assert (svc.hardware_report(assumed_skip=0.5, observed=OBSERVED)
            == jprog.hardware_report(skip_stats=jst, assumed_skip=0.5,
                                     observed=OBSERVED))
    fresh = InferenceService(tprog, batch_slots=4, device="cpu")
    assert (fresh.hardware_report(assumed_skip=0.5)
            == jprog.hardware_report(assumed_skip=0.5))


def test_skip_distributions_equal(pruned, programs):
    tprog, jprog = programs["fixed"]
    tst, jst = _stats(pruned, tprog, jprog)
    td, jd = tst.to_distributions(), jst.to_distributions()
    assert list(td) == list(jd)
    for name in td:
        assert dataclasses.asdict(td[name]) == dataclasses.asdict(jd[name])
