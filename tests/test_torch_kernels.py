"""Port's kernels (block-pattern spmm, OU MVM) against the JAX reference,
and on the card.

The same numpy inputs go through ``repro`` (Pallas in interpret mode and
the XLA path) and ``repro_torch`` (the plain PyTorch path, and the CUDA
kernels' wrappers, which take their plain version for CPU tensors).
"""

import pathlib

import numpy as np
import pytest
torch = pytest.importorskip("torch")

try:  # the reference; absent where only the port is installed
    import jax.numpy as jnp
    from repro.core import quantize as jq
    from repro.core import sparse as js
    from repro.kernels import ops as jops
except ImportError:
    jnp = None

from repro_torch.core import quantize as tq
from repro_torch.core import sparse as ts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ou_mvm as tou
from repro_torch.kernels import pattern_spmm as tk
from repro_torch.kernels._build import find_nvcc
from repro_torch.kernels.ref import ou_mvm_ref, pattern_spmm_ref

# test_kernels.py's sweep plus the smallest geometry in use (block 9, tile 8)
SWEEP = [
    (32, 256, 256, 128, 128),
    (130, 256, 384, 128, 128),  # m not tile-aligned
    (16, 512, 256, 64, 64),
    (8, 128, 128, 128, 128),  # single block
    (20, 27, 16, 9, 8),
]
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's fp32 bound
QUANT_REL = 2e-6  # int8: exact partials, float32 fold; normwise relative
# tests/test_kernels.py's ou_mvm sweep (r, c, ou_rows, ou_cols) and bound
OU_SWEEP = [(100, 52, 9, 8), (64, 64, 16, 8), (27, 8, 9, 8)]
OU_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference():
    if jnp is None:
        pytest.skip("needs the JAX reference package")


def _weights(rng, k, n, block, tile):
    w = rng.normal(size=(k, n)).astype(np.float32)
    tbp = ts.build_block_pattern(w, num_patterns=4, density=0.4, block=block,
                                 tile=tile)
    jbp = js.build_block_pattern(w, num_patterns=4, density=0.4, block=block,
                                 tile=tile)
    return tbp, jbp


def _nnz(bp):
    return torch.as_tensor(bp.nnz, dtype=torch.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("m,k,n,block,tile", SWEEP)
def test_fp32_spmm_matches_reference(reference, rng, m, k, n, block, tile):
    tbp, jbp = _weights(rng, k, n, block, tile)
    np.testing.assert_array_equal(tbp.w_comp.numpy(), np.asarray(jbp.w_comp))
    np.testing.assert_array_equal(tbp.block_ids.numpy(),
                                  np.asarray(jbp.block_ids))
    x = (rng.normal(size=(m, k)) * 0.3).astype(np.float32)

    y = tops.pattern_spmm(torch.from_numpy(x), tbp).numpy()
    y_pallas = jops.pattern_spmm(jnp.asarray(x), jbp, backend="pallas",
                                 interpret=True)
    y_xla = jops.pattern_spmm(jnp.asarray(x), jbp, backend="xla")
    np.testing.assert_allclose(y, np.asarray(y_pallas), **TOL)
    np.testing.assert_allclose(y, np.asarray(y_xla), **TOL)

    # the naive oracle and the kernel wrapper's CPU path agree too
    xt = torch.from_numpy(x)
    y_ref = pattern_spmm_ref(xt, tbp.w_comp, tbp.block_ids, block)
    y_raw = tops.pattern_spmm_raw(xt, tbp.w_comp, tbp.block_ids, block)
    np.testing.assert_allclose(y_raw.numpy(), y_ref.numpy(), **TOL)


def test_bf16_input_is_upcast(reference, rng):
    tbp, jbp = _weights(rng, 256, 256, 128, 128)
    x = (rng.normal(size=(16, 256)) * 0.3).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = tops.pattern_spmm(xb, tbp)
    assert y.dtype == torch.bfloat16
    want = jops.pattern_spmm(jnp.asarray(x, jnp.bfloat16), jbp, backend="xla")
    np.testing.assert_allclose(
        y.float().numpy(), np.asarray(want, np.float32), rtol=8e-2, atol=4e-2
    )


def test_wrappers_take_plain_version_on_cpu(reference, rng):
    """On a CPU tensor the kernel wrappers run their plain version and
    count no launch; the dispatch reaches them the same way, on the
    route ``default_backend`` names."""
    tbp, _ = _weights(rng, 27, 16, 9, 8)
    qbp = tq.quantize_bp(tbp)
    x = torch.from_numpy((rng.normal(size=(20, 27))).astype(np.float32))
    xq, _ = tq.quantize_rows(x)
    before = (tk.pattern_spmm_cuda.launches, tk.pattern_spmm_quant_cuda.launches)
    y = tk.pattern_spmm_cuda(x, tbp.w_comp, tbp.block_ids, _nnz(tbp), 9)
    np.testing.assert_array_equal(
        y.numpy(),
        tk.pattern_spmm_plain(x, tbp.w_comp, tbp.block_ids, _nnz(tbp), 9).numpy(),
    )
    yq = tk.pattern_spmm_quant_cuda(xq, qbp.w_comp, qbp.block_ids,
                                    qbp.w_scales, _nnz(qbp), 9)
    np.testing.assert_array_equal(
        yq.numpy(),
        tk.pattern_spmm_quant_plain(xq, qbp.w_comp, qbp.block_ids,
                                    qbp.w_scales, _nnz(qbp), 9).numpy(),
    )
    assert tops.default_backend(x) == "torch"
    np.testing.assert_array_equal(
        tops.pattern_spmm_raw(x, tbp.w_comp, tbp.block_ids, 9).numpy(),
        y.numpy())
    np.testing.assert_array_equal(
        tops.pattern_spmm_raw(x, qbp.w_comp, qbp.block_ids, 9,
                              w_scales=qbp.w_scales).numpy(),
        (yq * tq.quantize_rows(x)[1][:, None]).numpy())
    after = (tk.pattern_spmm_cuda.launches, tk.pattern_spmm_quant_cuda.launches)
    assert after == before


def test_quantize_rows_bit_equal(reference, rng):
    x = (rng.normal(size=(12, 40)) * 3).astype(np.float32)
    x[3] = 0.0  # all-zero row: scale 0, exact zeros
    x[7] = 0.0
    x[7, :6] = [127.0, 63.5, -0.5, 0.5, 1.5, 2.5]  # ties round half to even
    q, s = tq.quantize_rows(torch.from_numpy(x))
    jq_, js_ = jq.quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
    assert s[3] == 0 and not q[3].any()
    np.testing.assert_array_equal(q[7, :6].numpy(), [127, 64, 0, 0, 2, 2])


@pytest.mark.parametrize("m,k,n,block,tile", SWEEP)
def test_int8_spmm_matches_reference(reference, rng, m, k, n, block, tile):
    tbp, jbp = _weights(rng, k, n, block, tile)
    tqb, jqb = tq.quantize_bp(tbp), jq.quantize_bp(jbp)
    np.testing.assert_array_equal(tqb.w_comp.numpy(), np.asarray(jqb.w_comp))
    np.testing.assert_array_equal(tqb.w_scales.numpy(),
                                  np.asarray(jqb.w_scales))
    x = (rng.normal(size=(m, k)) * 0.3).astype(np.float32)
    xq, x_scale = jq.quantize_rows(jnp.asarray(x))  # identical xq for both

    y = ts.pattern_spmm_torch_quant(
        torch.from_numpy(np.array(xq)), torch.from_numpy(np.array(x_scale)),
        tqb.w_comp, tqb.block_ids, tqb.w_scales, block,
    ).numpy()
    want = np.asarray(js.pattern_spmm_xla_quant(
        xq, x_scale, jqb.w_comp, jqb.block_ids, jqb.w_scales, block
    ))
    assert _rel(y, want) <= QUANT_REL
    # single-brick tiles: one exact partial times one scale, no fold order
    for t in np.flatnonzero(tqb.nnz <= 1):
        cols = slice(t * tile, (t + 1) * tile)
        np.testing.assert_array_equal(y[:, cols], want[:, cols])

    # end to end through the dispatch (quantize + fold + row scale)
    y_op = tops.pattern_spmm(torch.from_numpy(x), tqb).numpy()
    y_jop = np.asarray(jops.pattern_spmm(jnp.asarray(x), jqb, backend="xla"))
    assert _rel(y_op, y_jop) <= QUANT_REL


# The fp32 kernel's plan inputs (m, t, tile, k_max): VGG16 for CIFAR-10 at
# 8 batch slots (m = 8 x H x W, 128 x 128 bricks, K padded to whole
# blocks) and the shapes of tests/test_kernels.py's spmm sweep and row
# autotune (k = n = 256), plus block 9 / tile 8.
VGG16_PLAN_SHAPES = [
    ("conv1", 8192, 1, 128, 1), ("conv2", 8192, 1, 128, 5),
    ("conv3", 2048, 1, 128, 5), ("conv4", 2048, 1, 128, 9),
    ("conv5", 512, 2, 128, 9), ("conv6", 512, 2, 128, 18),
    ("conv7", 512, 2, 128, 18), ("conv8", 128, 4, 128, 18),
    ("conv9", 128, 4, 128, 36), ("conv10", 128, 4, 128, 36),
    ("conv11", 32, 4, 128, 36), ("conv12", 32, 4, 128, 36),
    ("conv13", 32, 4, 128, 36), ("fc", 8, 1, 128, 4),
]
SWEEP_PLAN_SHAPES = [
    ("sweep_32", 32, 2, 128, 2), ("sweep_130", 130, 3, 128, 2),
    ("sweep_16", 16, 4, 64, 8), ("sweep_8", 8, 1, 128, 1),
    ("autotune_1", 1, 2, 128, 2), ("autotune_3", 3, 2, 128, 2),
    ("autotune_17", 17, 2, 128, 2), ("autotune_130", 130, 2, 128, 2),
    ("block9_tile8", 20, 2, 8, 3),
]


def _split_runs(n, splits):
    """The bricks split s of a tile with n bricks walks, as the kernel
    computes them: [s * ceil(n / S), ...) cut at n."""
    chunk = -(-n // splits)
    return [range(min(s * chunk, n), min(s * chunk + chunk, n))
            for s in range(splits)]


@pytest.mark.parametrize("name,m,t,tile,k_max",
                         VGG16_PLAN_SHAPES + SWEEP_PLAN_SHAPES)
def test_split_plan(name, m, t, tile, k_max):
    plan = tk._split_plan(m, t, tile, k_max)
    bm, bn, bk = tk._TILE_SHAPES[plan.config]
    assert (plan.bm, plan.bn, plan.bk) == (bm, bn, bk)
    slabs = t * -(-tile // bn)
    assert plan.blocks == -(-m // bm) * slabs * plan.splits
    assert 1 <= plan.splits <= max(k_max, 1)
    # every brick of every tile walked once, by exactly one split
    for n in range(k_max + 1):
        runs = _split_runs(n, plan.splits)
        assert [k for r in runs for k in r] == list(range(n))
    # no split of a full tile is empty
    runs = _split_runs(k_max, plan.splits)
    assert all(len(r) > 0 for r in runs) or k_max == 0
    assert plan.chunk == max(len(r) for r in runs)
    # output tiles that fill two waves alone are not split; otherwise the
    # split reaches two waves or one-brick runs
    if slabs >= 2 * tk._SMS:
        assert plan.splits == 1
    else:
        assert slabs * plan.splits >= 2 * tk._SMS or plan.chunk == 1
    # rows choose the block tile, never the split: an output's bits are
    # the same in a batch of any size
    for rows in (1, 8, 8 * m, 64 * m):
        assert tk._split_plan(rows, t, tile, k_max).splits == plan.splits
    assert bn == (32 if tile <= 32 else 128)
    if tile > 32:  # 32 rows up to eight waves, 32-deep steps up to three
        blocks32 = -(-m // 32) * slabs * plan.splits
        assert bm == (32 if blocks32 <= 8 * tk._SMS else 64)
        assert bk == (32 if blocks32 <= 3 * tk._SMS else 16)
    # shapes alone decide: the same shapes, the same plan
    assert tk._split_plan(m, t, tile, k_max) == plan


def _split_emulation(x, w_comp, block_ids, nnz, block, splits):
    """The fp32 kernel's arithmetic order in plain torch: split s of tile
    t sums its run of bricks in k order; the partials are summed in the
    order 0..S-1."""
    m = x.shape[0]
    t_n, _, _, tile = w_comp.shape
    parts = torch.zeros((splits, m, t_n * tile), dtype=torch.float32)
    for t in range(t_n):
        for s, run in enumerate(_split_runs(int(nnz[t]), splits)):
            acc = torch.zeros((m, tile), dtype=torch.float32)
            for k in run:
                b = int(block_ids[t, k])
                acc = acc + x[:, b * block:(b + 1) * block] @ w_comp[t, k]
            parts[s, :, t * tile:(t + 1) * tile] = acc
    y = parts[0].clone()
    for s in range(1, splits):
        y = y + parts[s]
    return y


@pytest.mark.parametrize("m,k,n,block,tile", SWEEP)
def test_split_sum_emulation_matches_plain(rng, m, k, n, block, tile):
    """The split walk and its fixed-order sum, emulated, agree with the
    plain version at the fp32 bound for every split count the bricks
    allow, and a row's result does not depend on the other rows."""
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    keep = rng.random((k // block, 1, n)) < 0.5
    w = (w.reshape(k // block, block, n) * keep).reshape(k, n)
    w[:, :tile] = 0.0  # tile 0 holds no brick
    bp = ts.build_block_pattern(w, block=block, tile=tile,
                                masks=ts.nonzero_block_masks(w, block))
    x = torch.from_numpy((rng.normal(size=(m, k)) * 0.3).astype(np.float32))
    nnz = _nnz(bp)
    want = tk.pattern_spmm_plain(x, bp.w_comp, bp.block_ids, nnz, block)
    plan = tk._split_plan(m, bp.n_tiles, tile, bp.k_max)
    for splits in sorted({1, 2, 3, plan.splits, max(bp.k_max, 1)}):
        y = _split_emulation(x, bp.w_comp, bp.block_ids, nnz, block, splits)
        torch.testing.assert_close(y, want, **TOL)
        assert not y[:, :tile].any()
        # other rows changed: row 0's result is bit for bit the same
        x2 = x.clone()
        x2[1:] = torch.from_numpy(rng.normal(size=(m - 1, k)).astype(
            np.float32)) if m > 1 else x2[1:]
        y2 = _split_emulation(x2, bp.w_comp, bp.block_ids, nnz, block,
                              splits)
        assert torch.equal(y2[0], y[0])


def test_copy_width_follows_shapes():
    """16-byte copies only where every copied row starts 16-byte aligned;
    block 9 / tile 8 and misaligned views take the 4-byte path."""
    w = torch.zeros((2, 3, 128, 128))
    x = torch.zeros((8, 384))
    assert tk._copy_width(x, w, 128, 128) == 4
    assert tk._copy_width(x[1:], w, 128, 128) == 4  # rows of 1536 bytes
    assert tk._copy_width(torch.zeros((8, 27)), torch.zeros((2, 3, 9, 8)),
                          9, 8) == 1
    assert tk._copy_width(torch.zeros((8, 90)), torch.zeros((2, 3, 9, 8)),
                          9, 8) == 1
    assert tk._copy_width(torch.zeros((8, 96)), torch.zeros((2, 3, 16, 6)),
                          16, 6) == 1
    skew = torch.zeros(8 * 384 + 1)[1:].view(8, 384)  # 4 bytes off
    assert tk._copy_width(skew, w, 128, 128) == 1


@pytest.mark.parametrize("name,m,t,tile,k_max",
                         VGG16_PLAN_SHAPES + SWEEP_PLAN_SHAPES)
def test_quant_plan(name, m, t, tile, k_max):
    """The int8 plan: tiles of fewer than ``_QUANT_SPLIT_FROM`` slots
    walked whole, larger ones split as the fp32 plan splits them in runs
    of at least ``_QUANT_MIN_RUN``, never by the rows; its own block tile
    chosen by the rows."""
    plan = tk._quant_plan(m, t, tile, k_max)
    bm, bn, bk = tk._QUANT_TILE_SHAPES[plan.config]
    assert (plan.bm, plan.bn, plan.bk) == (bm, bn, bk)
    slabs = t * -(-tile // bn)
    assert plan.blocks == -(-m // bm) * slabs * plan.splits
    if k_max < tk._QUANT_SPLIT_FROM:
        assert plan.splits == 1
    else:
        fp32_chunk = tk._splits(slabs, k_max, tk._SMS)[1]
        assert plan.chunk == max(fp32_chunk, tk._QUANT_MIN_RUN)
        assert plan.splits == -(-k_max // plan.chunk)
    runs = _split_runs(k_max, plan.splits)
    assert all(len(r) == plan.chunk for r in runs[:-1])  # the last may be short
    assert plan.chunk == max(len(r) for r in runs)
    assert all(len(r) > 0 for r in runs) or k_max == 0
    for n in range(k_max + 1):
        runs = _split_runs(n, plan.splits)
        assert [k for r in runs for k in r] == list(range(n))
    # rows choose the block tile, never the split
    for rows in (1, 8, 16, 17, 8 * m, 64 * m):
        assert tk._quant_plan(rows, t, tile, k_max).splits == plan.splits
    if tile <= 32:
        assert (bm, bn) == (32, 32)
    elif m <= 128:
        assert bm == 16  # an m16 MMA: nothing wasted at the FC's 8 rows
    else:
        blocks32 = -(-m // 32) * slabs * plan.splits
        assert bm == (32 if blocks32 <= 8 * tk._SMS else 64)
    # shapes alone decide: the same shapes, the same plan
    assert tk._quant_plan(m, t, tile, k_max) == plan


def _quant_split_emulation(xq, w_comp, block_ids, w_scales, nnz, block,
                           splits):
    """The int8 kernel's arithmetic in plain torch: each brick's partial
    exact (float64 holds it), rounded once to float32, folded as
    ``acc + scale * partial`` in k order within split s's run; the
    partials summed in the order 0..S-1."""
    m = xq.shape[0]
    t_n, _, _, tile = w_comp.shape
    xd = xq.double()
    parts = torch.zeros((splits, m, t_n * tile), dtype=torch.float32)
    for t in range(t_n):
        for s, run in enumerate(_split_runs(int(nnz[t]), splits)):
            acc = torch.zeros((m, tile), dtype=torch.float32)
            for k in run:
                b = int(block_ids[t, k])
                part = xd[:, b * block:(b + 1) * block] @ w_comp[t, k].double()
                acc = acc + w_scales[t, k] * part.float()
            parts[s, :, t * tile:(t + 1) * tile] = acc
    y = parts[0].clone()
    for s in range(1, splits):
        y = y + parts[s]
    return y


@pytest.mark.parametrize("m,k,n,block,tile", SWEEP)
def test_quant_split_emulation_matches_reference(reference, rng, m, k, n,
                                                 block, tile):
    """The int8 split walk and its fixed-order sum, emulated, against
    JAX's ``pattern_spmm_xla_quant`` within ``QUANT_REL`` for every split
    count the bricks allow: single-brick tiles exact, one split bit-equal
    to the plain version, a row's bits independent of the other rows."""
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    keep = rng.random((k // block, 1, n)) < 0.5
    w = (w.reshape(k // block, block, n) * keep).reshape(k, n)
    w[:, :tile] = 0.0  # tile 0 holds no brick
    masks = ts.nonzero_block_masks(w, block)
    tqb = tq.quantize_bp(ts.build_block_pattern(w, block=block, tile=tile,
                                                masks=masks))
    jqb = jq.quantize_bp(js.build_block_pattern(w, block=block, tile=tile,
                                                masks=masks))
    np.testing.assert_array_equal(tqb.w_comp.numpy(), np.asarray(jqb.w_comp))
    x = (rng.normal(size=(m, k)) * 0.3).astype(np.float32)
    jxq, jxs = jq.quantize_rows(jnp.asarray(x))
    xq, x_scale = torch.from_numpy(np.array(jxq)), torch.from_numpy(
        np.array(jxs))
    want = np.asarray(js.pattern_spmm_xla_quant(
        jxq, jxs, jqb.w_comp, jqb.block_ids, jqb.w_scales, block))
    nnz = _nnz(tqb)
    args = (tqb.w_comp, tqb.block_ids, tqb.w_scales, nnz, block)
    plain = tk.pattern_spmm_quant_plain(xq, *args)
    xq2 = xq.clone()
    xq2[1:] = -xq2[1:]
    single = np.flatnonzero(tqb.nnz <= 1)
    counts = {-(-tqb.k_max // c) for c in range(1, tqb.k_max + 1)} | {1}
    for splits in sorted(counts):
        y = _quant_split_emulation(xq, *args, splits)
        if splits == 1:
            assert torch.equal(y, plain)
        got = (y * x_scale[:, None]).numpy()
        assert _rel(got, want) <= QUANT_REL
        for t in single:
            cols = slice(t * tile, (t + 1) * tile)
            np.testing.assert_array_equal(got[:, cols], want[:, cols])
        assert not y[:, :tile].any()
        y2 = _quant_split_emulation(xq2, *args, splits)
        assert torch.equal(y2[0], y[0])


def test_quant_copy_width_follows_shapes():
    """16-byte copies where block and K are multiples of 16 and both
    bases 16-byte aligned, 4-byte where multiples of 4, else bytes."""
    w = torch.zeros((2, 3, 128, 128), dtype=torch.int8)
    x = torch.zeros((8, 384), dtype=torch.int8)
    assert tk._quant_copy_width(x, w, 128) == 16
    assert tk._quant_copy_width(torch.zeros((8, 96), dtype=torch.int8),
                                torch.zeros((1, 1, 8, 12), dtype=torch.int8),
                                12) == 4
    assert tk._quant_copy_width(torch.zeros((8, 81), dtype=torch.int8),
                                torch.zeros((2, 3, 8, 9), dtype=torch.int8),
                                9) == 1
    skew = torch.zeros(8 * 384 + 4, dtype=torch.int8)[4:].view(8, 384)
    assert tk._quant_copy_width(skew, w, 128) == 4
    odd = torch.zeros(8 * 384 + 1, dtype=torch.int8)[1:].view(8, 384)
    assert tk._quant_copy_width(odd, w, 128) == 1


def test_kmajor_copy_prepared_and_program_unchanged(tmp_path, rng):
    """The executor prepares each int8 layer's K-major bricks (the
    transposed bricks, contiguous) once, fp32 layers none, and a saved
    program is byte for byte the same before and after a forward."""
    from repro_torch.engine import (CompileOptions, compile_network,
                                    make_forward, save_program)
    from repro_torch.engine.executor import _Dispatch
    from repro_torch.models.cnn import mini_cnn_config

    cfg = mini_cnn_config(4, 12, (8, 16))
    params = {}
    for i, (ci, co) in enumerate(cfg.conv_channels, start=1):
        params[f"conv{i}"] = {
            "w": rng.normal(size=(co, ci, 3, 3)).astype(np.float32),
            "b": np.zeros(co, np.float32)}
    params["fc"] = {"w": rng.normal(size=(16, 4)).astype(np.float32),
                    "b": np.zeros(4, np.float32)}
    progs = {prec: compile_network(cfg, params, {}, options=CompileOptions(
        precision=prec), device="cpu") for prec in ("fp32", "int8")}
    disp = _Dispatch(torch.device("cpu"))
    for op in [*progs["int8"].convs, progs["int8"].fc]:
        prep = disp.prepare(op.bp, op.bias)
        want = op.bp.w_comp.transpose(2, 3)
        assert prep.w_kmajor.is_contiguous()
        assert prep.w_kmajor.dtype == torch.int8
        assert torch.equal(prep.w_kmajor, want)
        assert torch.equal(tk.kmajor_bricks(op.bp.w_comp), want)
    assert disp.prepare(progs["fp32"].fc.bp,
                        progs["fp32"].fc.bias).w_kmajor is None

    def files(path):
        path = pathlib.Path(path)
        return {p.relative_to(path): p.read_bytes()
                for p in sorted(path.rglob("*")) if p.is_file()}

    before = files(save_program(str(tmp_path / "a"), progs["int8"]))
    images = rng.normal(size=(3, 1, 12, 12)).astype(np.float32)
    make_forward(progs["int8"], device="cpu")(images)
    after = files(save_program(str(tmp_path / "b"), progs["int8"]))
    assert before == after


def _ou_case(rng, r, c, ou_r):
    w = rng.normal(size=(r, c)).astype(np.float32)
    x = rng.normal(size=(r,)).astype(np.float32)
    x[:ou_r] = 0.0  # an all-zero band exercises the skip
    return x, w


@pytest.mark.parametrize("r,c,ou_r,ou_c", OU_SWEEP)
def test_ou_mvm_matches_reference(reference, rng, r, c, ou_r, ou_c):
    """``ops.ou_mvm`` against the reference's (Pallas, interpret mode)."""
    x, w = _ou_case(rng, r, c, ou_r)
    y = tops.ou_mvm(torch.from_numpy(x), torch.from_numpy(w), ou_rows=ou_r,
                    ou_cols=ou_c)
    assert y.dtype == torch.float32 and y.shape == (c,)
    want = jops.ou_mvm(jnp.asarray(x), jnp.asarray(w), ou_rows=ou_r,
                       ou_cols=ou_c)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **OU_TOL)
    np.testing.assert_allclose(
        ou_mvm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        y.numpy(), **OU_TOL)


def test_ou_skip_lossless(reference, rng):
    """The all-zero-input skip (paper §IV-A) is numerically lossless."""
    w = rng.normal(size=(45, 16)).astype(np.float32)
    x = rng.normal(size=(45,)).astype(np.float32)
    x[9:27] = 0.0
    y = tops.ou_mvm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), x @ w, **OU_TOL)
    want = jops.ou_mvm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **OU_TOL)


def test_ou_mvm_nan_in_skipped_band(reference, rng):
    """A skipped band's weights are never read: a NaN there stays out of
    the output, as in the reference, though ``x @ w`` would spread it."""
    x, w = _ou_case(rng, 27, 8, 9)
    w[4, 3] = np.nan  # band 0, whose inputs are all zero
    w[12, 5] = np.inf
    x[9:18] = -0.0  # -0.0 counts as zero: band 1 is skipped too
    y = tops.ou_mvm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jops.ou_mvm(jnp.asarray(x), jnp.asarray(w)))
    assert np.isfinite(y).all() and np.isfinite(want).all()
    np.testing.assert_allclose(y, want, **OU_TOL)
    np.testing.assert_allclose(y, x[18:] @ w[18:], **OU_TOL)


def test_ou_mvm_band_flags_and_zero_input(rng):
    x = torch.tensor([0.0, -0.0, 0.0, 1.0, 0.0, 0.0, float("nan"), 0.0])
    assert tou.band_flags(x, 3).tolist() == [False, True, True]
    w = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
    w[:3] = float("nan")
    # an all-zero x skips every band: exact zeros, NaN weights unread
    assert torch.equal(tops.ou_mvm(torch.zeros(8), w, ou_rows=4),
                       torch.zeros(5))
    assert torch.isnan(tops.ou_mvm(x, w.abs(), ou_rows=3)).all()
    for bad in (lambda: tops.ou_mvm(x, w[:7]),
                lambda: tops.ou_mvm(x.int(), w),
                lambda: tops.ou_mvm(x, w, ou_rows=0)):
        with pytest.raises(ValueError):
            bad()


# ou_mvm calls of chip_smoke.py (r, c): each VGG16 conv's dense weight
# [C_in * 9, C_out], then the reference's sweep shapes, then R past one
# shared-memory chunk of x
OU_PLAN_SHAPES = [(27, 64), (576, 64), (576, 128), (1152, 128), (1152, 256),
                  (2304, 256), (2304, 512), (4608, 512), (100, 52), (64, 64),
                  (27, 8), (300, 33), (1, 1), (50_000, 64)]


def _ou_chunks(r: int, ou_rows: int):
    """The kernel's passes of x through shared memory: (first row, rows,
    first band, last band) of each chunk, the bands those that meet it."""
    for lo in range(0, r, tou._OU_CHUNK):
        n = min(tou._OU_CHUNK, r - lo)
        yield lo, n, lo // ou_rows, (lo + n - 1) // ou_rows


@pytest.mark.parametrize("r,c", OU_PLAN_SHAPES)
@pytest.mark.parametrize("ou_rows", [9, 16])
def test_ou_plan(r, c, ou_rows):
    """One block a column slab of one load's width, from the shapes
    alone; every column in exactly one slab, every row in one row-lane's
    walk and one chunk; a chunk's bands fit the band flags the kernel's
    shared memory holds ((rows - 1) / ou_rows + 2)."""
    for vec in (1, 4):
        plan = tou._ou_plan(r, c, vec)
        assert plan.cols == vec
        assert (plan.blocks - 1) * plan.cols < c <= plan.blocks * plan.cols
        rows = tou._OU_THREADS
        assert (plan.rows_per_lane - 1) * rows < r <= plan.rows_per_lane * rows
        assert tou._ou_plan(r, c, vec) == plan
    chunks = list(_ou_chunks(r, ou_rows))
    assert len(chunks) == plan.chunks
    assert sum(n for _, n, _, _ in chunks) == r
    assert tou._OU_CHUNK % tou._OU_THREADS == 0  # a lane's rows keep order
    for lo, n, b0, b1 in chunks:
        assert b1 - b0 + 1 <= (min(r, tou._OU_CHUNK) - 1) // ou_rows + 2
        assert b0 * ou_rows <= lo and lo + n <= (b1 + 1) * ou_rows
    assert tou._ou_plan(4608, 512, 4) == (4, 128, 9, 1)


def test_ou_vec_follows_shapes():
    assert tou._ou_vec(torch.zeros((9, 512))) == 4
    assert tou._ou_vec(torch.zeros((9, 52))) == 4
    assert tou._ou_vec(torch.zeros((9, 33))) == 1
    assert tou._ou_vec(torch.zeros(9 * 64 + 1)[1:].view(9, 64)) == 1


def _ou_slab_emulation(x, w, ou_rows):
    """The ``ou_mvm`` kernel's order in plain torch: row-lane l of a
    block sums rows l, l + L, l + 2L, ... in order (L = 512 row-lanes,
    whatever the chunks of x), then the block sums its row-lanes by the
    kernel's fixed tree: within each warp of 32 lane i takes lane i + s
    for s = 16, 8, ..., 1, then warp i takes warp i + s for s = 8, ...,
    1.  A row of a skipped band adds nothing and its weights are never
    multiplied."""
    r, c = w.shape
    live = tou.band_flags(x, ou_rows).repeat_interleave(ou_rows)[:r]
    prod = torch.where(live[:, None], x[:, None] * w, torch.zeros(()))
    rows = tou._OU_THREADS
    red = torch.zeros((rows, c))
    for lane in range(min(rows, r)):
        acc = torch.zeros(c)
        for rr in range(lane, r, rows):
            acc = acc + prod[rr]
        red[lane] = acc
    red = red.view(rows // 32, 32, c)
    for s in (16, 8, 4, 2, 1):
        red[:, :s] = red[:, :s] + red[:, s:2 * s]
    red = red[:, 0]
    for s in (8, 4, 2, 1):
        red[:s] = red[:s] + red[s:2 * s]
    return red[0]


OU_EMULATION_CASES = [*OU_SWEEP, (300, 33, 7, 5), (4608 // 8, 64, 9, 8)]


@pytest.mark.parametrize("r,c,ou_r,ou_c", OU_EMULATION_CASES)
def test_ou_slab_emulation_matches_reference(reference, rng, r, c, ou_r,
                                             ou_c):
    """The column-slab walk and its fixed-tree sum, emulated, against
    the reference's ``ou_mvm`` (Pallas, interpret mode) at 1e-5: with an
    all-zero band, a NaN weight in a skipped band, and an all-zero x
    (exact zeros)."""
    x, w = _ou_case(rng, r, c, ou_r)
    x[2 * ou_r:3 * ou_r] = -0.0  # -0.0 counts as zero: skipped too
    w[ou_r // 2, c // 2] = np.nan  # band 0 is skipped: never read
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = np.asarray(jops.ou_mvm(jnp.asarray(x), jnp.asarray(w),
                                  ou_rows=ou_r, ou_cols=ou_c))
    assert np.isfinite(want).all()
    y = _ou_slab_emulation(xt, wt, ou_r)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), want, **OU_TOL)
    zero = _ou_slab_emulation(torch.zeros(r), wt, ou_r)
    assert torch.equal(zero, torch.zeros(c))


def test_ou_mvm_wrapper_takes_plain_version_on_cpu(rng):
    x, w = _ou_case(rng, 100, 52, 9)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = tou.ou_mvm_cuda.launches
    y = tou.ou_mvm_cuda(xt.to(torch.bfloat16), wt, 9, 8)
    assert torch.equal(y, tou.ou_mvm_plain(xt.to(torch.bfloat16), wt, 9, 8))
    assert y.dtype == torch.float32
    assert torch.equal(tops.ou_mvm(xt, wt), tou.ou_mvm_plain(xt, wt))
    assert tou.ou_mvm_cuda.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no library and no fallback: the build raises."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card, at the
    sweep's geometries plus a tile with no bricks (must write zeros)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for m, k, n, block, tile in SWEEP:
        w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
        keep = rng.random((k // block, 1, n)) < 0.4  # pattern-pruned blocks
        w = (w.reshape(k // block, block, n) * keep).reshape(k, n)
        w[:, :tile] = 0.0  # all-zero masks sort first: tile 0 has nnz == 0
        bp = ts.build_block_pattern(
            w, block=block, tile=tile,
            masks=ts.nonzero_block_masks(w, block), device=dev,
        )
        assert bp.nnz[0] == 0
        qbp = tq.quantize_bp(bp)
        nnz = torch.as_tensor(bp.nnz, dtype=torch.int32, device=dev)
        x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32),
                            device=dev)
        xq, _ = tq.quantize_rows(x)
        n0 = tk.pattern_spmm_cuda.launches
        y = tk.pattern_spmm_cuda(x, bp.w_comp, bp.block_ids, nnz, block)
        torch.cuda.synchronize()
        assert tk.pattern_spmm_cuda.launches == n0 + 1
        want = tk.pattern_spmm_plain(x, bp.w_comp, bp.block_ids, nnz, block)
        torch.testing.assert_close(y, want, **TOL)
        assert not y[:, :tile].any()
        n0 = tk.pattern_spmm_quant_cuda.launches
        yq = tk.pattern_spmm_quant_cuda(xq, qbp.w_comp, qbp.block_ids,
                                        qbp.w_scales, nnz, block)
        torch.cuda.synchronize()
        assert tk.pattern_spmm_quant_cuda.launches == n0 + 1
        wantq = tk.pattern_spmm_quant_plain(xq, qbp.w_comp, qbp.block_ids,
                                            qbp.w_scales, nnz, block)
        assert _rel(yq.cpu(), wantq.cpu()) <= QUANT_REL


@pytest.mark.gpu
def test_fp32_split_walk_on_card():
    """The fp32 kernel under every block tile and a range of split counts
    (the default plan among them) against its plain version: the sweep,
    block 9 / tile 8 (4-byte copies), tiles with no brick; two runs bit
    for bit equal; a row's result independent of the other rows; one
    launch counted per call, and one reduction per split call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    for m, k, n, block, tile in SWEEP + [(8192, 640, 128, 128, 128),
                                         (33, 1152, 256, 128, 128)]:
        w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
        keep = rng.random((k // block, 1, n)) < 0.6
        w = (w.reshape(k // block, block, n) * keep).reshape(k, n)
        w[:, :tile] = 0.0  # tile 0 has nnz == 0
        bp = ts.build_block_pattern(
            w, block=block, tile=tile,
            masks=ts.nonzero_block_masks(w, block), device=dev,
        )
        nnz = torch.as_tensor(bp.nnz, dtype=torch.int32, device=dev)
        x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32),
                            device=dev)
        x2 = x.clone()
        x2[1:] = -x2[1:]
        want = tk.pattern_spmm_plain(x, bp.w_comp, bp.block_ids, nnz, block)
        default = tk._split_plan(m, bp.n_tiles, tile, bp.k_max)
        plans = [default]
        for config, (bm, bn, bk) in enumerate(tk._TILE_SHAPES):
            for splits in sorted({1, 2, max(bp.k_max, 1)}):
                base = -(-m // bm) * bp.n_tiles * -(-tile // bn)
                plans.append(tk.SplitPlan(config, bm, bn, bk, splits,
                                          -(-bp.k_max // splits),
                                          base * splits))
        for plan in plans:
            n0 = tk.pattern_spmm_cuda.launches
            r0 = tk.pattern_spmm_cuda.reduce_launches
            y = tk.pattern_spmm_cuda(x, bp.w_comp, bp.block_ids, nnz, block,
                                     plan=plan)
            again = tk.pattern_spmm_cuda(x, bp.w_comp, bp.block_ids, nnz,
                                         block, plan=plan)
            other = tk.pattern_spmm_cuda(x2, bp.w_comp, bp.block_ids, nnz,
                                         block, plan=plan)
            torch.cuda.synchronize()
            assert tk.pattern_spmm_cuda.launches == n0 + 3
            assert tk.pattern_spmm_cuda.reduce_launches == r0 + 3 * (
                plan.splits > 1)
            torch.testing.assert_close(y, want, **TOL)
            assert not y[:, :tile].any()
            assert torch.equal(y, again)
            assert torch.equal(y[0], other[0])
        # the default plan's split follows no row count: the first rows
        # alone give the same bits as in the whole batch
        few = tk.pattern_spmm_cuda(x[:5].contiguous(), bp.w_comp,
                                   bp.block_ids, nnz, block)
        whole = tk.pattern_spmm_cuda(x, bp.w_comp, bp.block_ids, nnz, block)
        assert torch.equal(few, whole[:5])


@pytest.mark.gpu
def test_ou_mvm_cuda_matches_plain_on_card():
    """The OU MVM kernel against its plain version on the card: the
    sweep, ragged shapes, an all-zero x and a NaN in a skipped band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for r, c, ou_r, ou_c in OU_SWEEP + [(4608, 512, 9, 8), (1, 1, 9, 8),
                                        (300, 33, 7, 5)]:
        x, w = _ou_case(rng, r, c, ou_r)
        xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
        n0 = tou.ou_mvm_cuda.launches
        y = tou.ou_mvm_cuda(xt, wt, ou_r, ou_c)
        torch.cuda.synchronize()
        assert tou.ou_mvm_cuda.launches == n0 + 1
        want = tou.ou_mvm_plain(xt, wt, ou_r, ou_c)
        lim = 1e-5 * (1 + (xt[:, None] * wt).abs().sum(0))
        assert ((y - want).abs() <= lim).all()
        assert torch.equal(y, tou.ou_mvm_cuda(xt, wt, ou_r, ou_c))
        assert not tou.ou_mvm_cuda(torch.zeros_like(xt), wt, ou_r, ou_c).any()
    x, w = _ou_case(rng, 27, 8, 9)
    w[2, 2] = np.nan
    y = tou.ou_mvm_cuda(torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev))
    assert torch.isfinite(y).all()


@pytest.mark.gpu
def test_int8_split_walk_on_card():
    """The int8 kernel under every block tile and a range of split counts
    (the default plan among them) against its plain version: the sweep,
    block 9 / tile 8 (byte copies), tiles with no brick; single-brick
    tiles and one-split plans bit-equal to the plain version; two runs
    bit for bit equal; a row's result independent of the other rows;
    one launch counted per call, and one reduction per split call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    for m, k, n, block, tile in SWEEP + [(8192, 640, 128, 128, 128),
                                         (32, 4608, 512, 128, 128),
                                         (8, 512, 128, 128, 128)]:
        w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
        keep = rng.random((k // block, 1, n)) < 0.6
        w = (w.reshape(k // block, block, n) * keep).reshape(k, n)
        w[:, :tile] = 0.0  # tile 0 has nnz == 0
        qbp = tq.quantize_bp(ts.build_block_pattern(
            w, block=block, tile=tile,
            masks=ts.nonzero_block_masks(w, block), device=dev))
        nnz = torch.as_tensor(qbp.nnz, dtype=torch.int32, device=dev)
        x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32),
                            device=dev)
        xq, _ = tq.quantize_rows(x)
        xq2 = xq.clone()
        xq2[1:] = -xq2[1:]
        args = (qbp.w_comp, qbp.block_ids, qbp.w_scales, nnz, block)
        wk = tk.kmajor_bricks(qbp.w_comp)
        want = tk.pattern_spmm_quant_plain(xq, *args)
        single = [t for t in range(qbp.n_tiles) if int(qbp.nnz[t]) <= 1]
        default = tk._quant_plan(m, qbp.n_tiles, tile, qbp.k_max)
        plans = [default]
        for config, (bm, bn, bk) in enumerate(tk._QUANT_TILE_SHAPES):
            if (bn == 32) != (tile <= 32):
                continue
            for splits in sorted({1, 2, max(qbp.k_max, 1)}):
                base = -(-m // bm) * qbp.n_tiles * -(-tile // bn)
                plans.append(tk.SplitPlan(config, bm, bn, bk, splits,
                                          -(-qbp.k_max // splits),
                                          base * splits))
        for plan in plans:
            n0 = tk.pattern_spmm_quant_cuda.launches
            r0 = tk.pattern_spmm_quant_cuda.reduce_launches
            y = tk.pattern_spmm_quant_cuda(xq, *args, w_kmajor=wk, plan=plan)
            again = tk.pattern_spmm_quant_cuda(xq, *args, w_kmajor=wk,
                                               plan=plan)
            other = tk.pattern_spmm_quant_cuda(xq2, *args, plan=plan)
            torch.cuda.synchronize()
            assert tk.pattern_spmm_quant_cuda.launches == n0 + 3
            assert tk.pattern_spmm_quant_cuda.reduce_launches == r0 + 3 * (
                plan.splits > 1)
            assert _rel(y.cpu(), want.cpu()) <= QUANT_REL, plan
            if plan.splits == 1:
                assert torch.equal(y, want), plan
            for t in single:
                cols = slice(t * tile, (t + 1) * tile)
                assert torch.equal(y[:, cols], want[:, cols]), (plan, t)
            assert not y[:, :tile].any()
            assert torch.equal(y, again)
            assert torch.equal(y[0], other[0])
        # the default plan's split follows no row count
        few = tk.pattern_spmm_quant_cuda(xq[:5].contiguous(), *args)
        whole = tk.pattern_spmm_quant_cuda(xq, *args)
        assert torch.equal(few, whole[:5])


@pytest.mark.gpu
def test_ou_mvm_column_slabs_on_card():
    """The OU MVM kernel under its plan against its plain version:
    ragged shapes, float4 and scalar loads, an all-zero x (zeros), a
    NaN weight in a skipped band (kept out); two runs bit for bit equal
    (a fixed tree sums the row-lanes); a column's result independent of
    the other columns; one launch per call.  R past one shared-memory
    chunk of x (8192 rows) works: a skipped band across a chunk's edge,
    and ou_rows 1 (the most band flags a chunk holds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    for r, c, ou_r, ou_c in OU_EMULATION_CASES + [
            (4608, 512, 9, 8), (2304, 256, 9, 8), (1, 1, 9, 8),
            (50_000, 64, 9, 8), (3 * tou._OU_CHUNK + 5, 33, 1, 8)]:
        x, w = _ou_case(rng, r, c, ou_r)
        w[: min(ou_r, r) // 2, c // 2] = np.nan  # band 0 is skipped
        if r > tou._OU_CHUNK:
            edge = tou._OU_CHUNK // ou_r * ou_r  # the band across the edge
            x[edge:edge + ou_r] = 0.0
            w[edge:edge + ou_r, 1] = np.nan
        xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
        w2 = wt.clone()
        w2[:, 1:] = -w2[:, 1:]
        want = tou.ou_mvm_plain(xt, wt, ou_r, ou_c)
        live = tou.band_flags(xt, ou_r).repeat_interleave(ou_r)[:r]
        mag = torch.where(live[:, None], xt[:, None] * wt, 0.0).abs()
        lim = 1e-5 * (1 + mag.sum(0))
        n0 = tou.ou_mvm_cuda.launches
        y = tou.ou_mvm_cuda(xt, wt, ou_r, ou_c)
        again = tou.ou_mvm_cuda(xt, wt, ou_r, ou_c)
        other = tou.ou_mvm_cuda(xt, w2, ou_r, ou_c)
        zero = tou.ou_mvm_cuda(torch.zeros_like(xt), wt, ou_r, ou_c)
        torch.cuda.synchronize()
        assert tou.ou_mvm_cuda.launches == n0 + 4
        assert torch.isfinite(y).all(), (r, c)
        assert ((y - want).abs() <= lim).all(), (r, c)
        assert torch.equal(y, again)
        assert torch.equal(y[0], other[0])
        assert not zero.any()
        # w 4 bytes off 16-byte alignment takes the 4-byte loads
        skew = torch.empty(r * c + 1, device=dev)[1:].view(r, c)
        skew.copy_(wt)
        assert tou._ou_vec(skew) == 1
        y1 = tou.ou_mvm_cuda(xt, skew, ou_r, ou_c)
        assert torch.isfinite(y1).all()
        assert ((y1 - want).abs() <= lim).all()
        if tou._ou_vec(wt) == 1:
            assert torch.equal(y1, y)
