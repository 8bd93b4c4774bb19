"""Port's kernels (block-pattern spmm, OU MVM) against the JAX reference,
and on the card.

The same numpy inputs go through ``repro`` (Pallas in interpret mode and
the XLA path) and ``repro_torch`` (the plain PyTorch path, and the CUDA
kernels' wrappers, which take their plain version for CPU tensors).
"""

import numpy as np
import pytest
import torch

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
