"""The int8 patch kernel (``kernels/patches.conv_patches_q8_cuda``) on the
CPU and on the card.

On the CPU: the plain version against an independent quantization of
independently built rows, the kernel's plan and both phases emulated step
by step against the plain version, the row-amax identity the kernel rests
on, its plan at every VGG16 conv, the wrapper's refusals, and the
executor's int8 conv on the fused route against the float rows' route.
On the card (``-m gpu``): the kernel against its plain version bit for bit
at every ImageNet conv and at ragged shapes, and a served int8 forward's
launches.  The file imports no JAX, so the card's run collects it.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.quantize import quantize_rows  # noqa: E402
from repro_torch.engine import executor  # noqa: E402
from repro_torch.kernels import patches as tp  # noqa: E402
from repro_torch.kernels._build import find_nvcc  # noqa: E402

# VGG16's convs (C_in, side of the map) at the benchmark's two inputs
VGG16_IMAGENET = [(3, 224), (64, 224), (64, 112), (128, 112), (128, 56),
                  (256, 56), (256, 56), (256, 28), (512, 28), (512, 28),
                  (512, 14), (512, 14), (512, 14)]
VGG16_CIFAR10 = [(c, s // 7) for c, s in VGG16_IMAGENET]
BLOCK = 128  # the served programs' brick depth: K is padded to it
INV_QMAX = np.float32(1) / np.float32(127)  # fl(1/127)
RINT_MAGIC = np.float32(12582912.0)  # 1.5 * 2^23
SENTINEL = 999  # a byte no store wrote


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "nchw":
        return x.contiguous()
    return x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _rows_numpy(x: np.ndarray, k: int, k_pad: int) -> np.ndarray:
    """Padded patch rows from shifted slices of the zero-padded map:
    [B*H*W, k_pad], feature c*k*k + dy*k + dx."""
    b, c, h, w = x.shape
    r = k // 2
    xp = np.pad(x, ((0, 0), (0, 0), (r, r), (r, r)))
    taps = np.stack([xp[:, :, dy:dy + h, dx:dx + w]
                     for dy in range(k) for dx in range(k)], axis=2)
    rows = taps.transpose(0, 3, 4, 1, 2).reshape(b * h * w, c * k * k)
    out = np.zeros((b * h * w, k_pad), np.float32)
    out[:, :c * k * k] = rows
    return out


def _card_scale(rows: torch.Tensor) -> torch.Tensor:
    """The row scale ``quantize_rows`` gives on a CUDA tensor: PyTorch's
    CUDA division by a scalar multiplies by its reciprocal, so
    ``amax / 127`` is ``amax * fl(1/127)`` there (on the CPU it divides)."""
    return rows.abs().amax(dim=-1) * torch.tensor(INV_QMAX)


def _tie_image(b: int, c: int, h: int, w: int, seed: int) -> torch.Tensor:
    """Every row's amax 127 (channel 0 holds 127 everywhere), so its
    inverse scale is exactly 1 and every other value, a half-integer, is
    an exact tie for the rounding."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 127, size=(b, c, h, w)).astype(np.float32) + 0.5
    x[:, 0] = 127.0
    return torch.as_tensor(x)


def _zero_image(b: int, c: int, h: int, w: int, seed: int) -> torch.Tensor:
    """Image 0 all zero; image 1 zero but for a corner, so most of its
    rows are all zero too; the rest random."""
    x = np.random.default_rng(seed).normal(size=(b, c, h, w))
    x = x.astype(np.float32)
    x[0] = 0.0
    x[1, :, 2:, :] = 0.0
    x[1, :, :, 2:] = 0.0
    return torch.as_tensor(x)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("c", [3, 20, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_plain_version_is_quantized_im2col(rng, k, c, padded, layout):
    """On a CPU tensor the wrapper runs its plain version, counting no
    launch: ``quantize_rows`` over ``conv_patches_plain``'s rows, equal to
    a numpy quantization (amax, ``amax / 127``, ``fl(1/amax) * 127``,
    rint half to even, clip) of rows built without ``F.unfold``."""
    x = _layout(torch.as_tensor(
        rng.normal(size=(2, c, 5, 7)).astype(np.float32)), layout)
    k_pad = c * k * k + (37 if padded else 0)
    before = tp.conv_patches_q8_cuda.launches
    xq, scale = tp.conv_patches_q8_cuda(x, k, k_pad)
    assert tp.conv_patches_q8_cuda.launches == before
    assert xq.dtype == torch.int8 and scale.dtype == torch.float32
    assert xq.shape == (2 * 5 * 7, k_pad) and xq.is_contiguous()
    want_q, want_s = quantize_rows(tp.conv_patches_plain(x, k, k_pad))
    assert torch.equal(xq, want_q) and torch.equal(scale, want_s)
    rows = _rows_numpy(x.numpy(), k, k_pad)
    amax = np.abs(rows).max(axis=1)
    inv = np.where(amax > 0, (np.float32(1) / np.where(amax > 0, amax, 1))
                   * np.float32(127), 0).astype(np.float32)
    q = np.clip(np.rint(rows * inv[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(xq.numpy(), q)
    np.testing.assert_array_equal(scale.numpy(), amax / np.float32(127))


def _quant(v: np.ndarray, inv: np.float32) -> np.ndarray:
    """The kernel's ``quant_word``: clamp(v * inv) plus 1.5 * 2^23, whose
    low byte is the rounded value as int8."""
    p = np.clip(v.astype(np.float32) * inv, -127, 127).astype(np.float32)
    word = (p + RINT_MAGIC).astype(np.float32).view(np.uint32)
    return (word & 0xFF).astype(np.uint8).view(np.int8).astype(np.int16)


def _emulate_q8(x: torch.Tensor, k: int, k_pad: int):
    """``csrc/conv_patches_q8.cu`` step by step on the CPU.  Each block of
    ``_q8_plan`` stages its halo chunk by chunk, channels innermost, into
    one of its buffers (shared memory that starts as NaN; zero outside the
    image), the next chunk before it works on this one: pass 1 folds each
    halo position's channel amax, then each pixel gets its row amax,
    scale and inverse, then pass 2 runs the chunks backwards (the last
    one still staged), quantizing 4 channels of a pixel into a row tile
    that starts every chunk as ``SENTINEL`` and copying the tile out in
    stores of ``vec`` bytes.  Returns the rows, the scales, each row's
    amax and how often each row byte and each scale was written."""
    xn = x.numpy()
    b, c, h, w = xn.shape
    pl = tp._q8_plan(b, c, h, w, k)
    kk, r = k * k, k // 2
    hh, hw = pl.th + k - 1, pl.tw + k - 1
    cca = -(-pl.cc // 16) * 16
    npix, n_pos = pl.tb * pl.th * pl.tw, pl.tb * hh * hw
    row_bytes = cca * kk
    assert pl.smem == tp._q8_smem(pl.tb, pl.th, pl.tw, pl.cc, c, k)
    assert pl.smem <= 48 * 1024
    vec = 16 if k_pad % 16 == 0 else 1
    n = -(-c // pl.cc)
    xp = np.pad(xn, ((0, 0), (0, 0), (r, r + pl.th), (r, r + pl.tw)))
    out = np.full((b * h * w, k_pad), SENTINEL, np.int16)
    writes = np.zeros(out.shape, np.int32)
    scale = np.full(b * h * w, np.nan, np.float32)
    amax_rows = np.full(b * h * w, np.nan, np.float32)
    scale_writes = np.zeros(b * h * w, np.int32)
    tiles_x, tiles_y = -(-w // pl.tw), -(-h // pl.th)
    assert pl.tiles == -(-b // pl.tb) * tiles_y * tiles_x
    taps = [(t // k) * hw * cca + (t % k) * cca for t in range(kk)]
    for bx in range(pl.tiles):
        t = bx
        x0 = (t % tiles_x) * pl.tw
        t //= tiles_x
        y0 = (t % tiles_y) * pl.th
        b0 = (t // tiles_y) * pl.tb
        nb = min(pl.tb, b - b0)
        halo = np.full((2 if c > pl.cc else 1, n_pos * cca), np.nan,
                       np.float32)

        def stage(buf, c0, nc):
            nc4 = -(-nc // 4) * 4
            for pos in range(n_pos):
                xx, yy, bb = pos % hw, (pos // hw) % hh, pos // (hw * hh)
                v = np.zeros(nc4, np.float32)
                if bb < nb:
                    v[:nc] = xp[b0 + bb, c0:c0 + nc, y0 + yy, x0 + xx]
                halo[buf, pos * cca:pos * cca + nc4] = v

        pixels = []
        for p in range(npix):
            px, rr = p % pl.tw, p // pl.tw
            py, bb = rr % pl.th, rr // pl.th
            gy, gx = y0 + py, x0 + px
            if bb < nb and gy < h and gx < w:
                pixels.append((p, ((b0 + bb) * h + gy) * w + gx,
                               (bb * hh + py) * hw + px))
        # pass 1
        pos_amax = np.zeros(n_pos, np.uint32)
        stage(0, 0, min(pl.cc, c))
        for s_ in range(n):
            if s_ + 1 < n:
                stage((s_ + 1) % 2, (s_ + 1) * pl.cc,
                      min(pl.cc, c - (s_ + 1) * pl.cc))
            nq = -(-min(pl.cc, c - s_ * pl.cc) // 4)
            for pos in range(n_pos):
                v = halo[s_ % 2, pos * cca:pos * cca + 4 * nq]
                assert not np.isnan(v).any()  # only staged halo read
                bits = np.abs(v).astype(np.float32).view(np.uint32)
                pos_amax[pos] = max(pos_amax[pos], bits.max())
        # each pixel's row amax, scale and inverse
        pix_inv = {}
        for p, row, base in pixels:
            a = max(pos_amax[base + dy * hw + dx]
                    for dy in range(k) for dx in range(k)).view(np.float32)
            pix_inv[p] = ((np.float32(1) / a) * np.float32(127)
                          if a > 0 else np.float32(0))
            scale[row] = a * INV_QMAX
            amax_rows[row] = a
            scale_writes[row] += 1
        # pass 2, backwards
        for ch in reversed(range(n)):
            c0 = ch * pl.cc
            nc = min(pl.cc, c - c0)
            if ch > 0:
                stage((ch - 1) % 2, c0 - pl.cc, pl.cc)
            nq = -(-nc // 4)
            tile = np.full(npix * row_bytes, SENTINEL, np.int16)
            for p, _, base in pixels:
                for q in range(nq):
                    at = p * row_bytes + 4 * kk * q
                    for tap in range(kk):
                        off = (base * cca + 4 * q) + taps[tap]
                        v = halo[ch % 2, off:off + 4]
                        assert v.size == 4 and not np.isnan(v).any()
                        tile[at + tap:at + 4 * kk:kk] = _quant(v, pix_inv[p])
            f0 = c0 * kk
            f1 = k_pad if ch + 1 == n else (c0 + pl.cc) * kk
            have = 4 * nq * kk
            assert (f1 - f0) % vec == 0
            j = np.arange(f1 - f0)
            for p, row, _ in pixels:
                assert (row * k_pad + f0) % vec == 0  # aligned stores
                got = np.where(j < have,
                               tile[p * row_bytes + np.minimum(j, have - 1)],
                               0)
                assert (got != SENTINEL).all()
                out[row, f0:f1] = got
                writes[row, f0:f1] += 1
    return out, scale, amax_rows, writes, scale_writes


EMULATED = [
    (2, 3, 5, 7, 3, 128),    # conv1: one chunk of 3 channels, mostly padding
    (2, 3, 5, 7, 1, 3),      # k 1, nothing padded, byte stores
    (2, 5, 6, 9, 5, 127),    # k 5, odd K: byte stores
    (3, 40, 4, 4, 3, 361),   # chunks of 16 + 16 + 8 channels, small map
    (17, 8, 2, 2, 3, 72),    # 8 channels, images share a block, 17 ragged
    (2, 64, 9, 33, 3, 640),  # ragged columns and rows
    (2, 64, 14, 14, 7, 3200),  # k 7: the plan shrinks to fit
]


@pytest.mark.parametrize("b,c,h,w,k,k_pad", EMULATED)
def test_kernel_emulation_matches_plain(rng, b, c, h, w, k, k_pad):
    """The kernel's plan, both passes and its stores, emulated, write every
    row byte and every scale once, read only staged halo and written row
    tile, and give the plain version's int8 rows bit for bit and its row
    amax; the scale is the card's ``quantize_rows`` scale bit for bit."""
    x = torch.as_tensor(rng.normal(size=(b, c, h, w)).astype(np.float32))
    _check_emulation(x, k, k_pad)


@pytest.mark.parametrize("b,c,h,w,k,k_pad", [
    (2, 40, 8, 16, 3, 368),  # chunks of 32 + 8: two buffers, a ragged end
    (1, 96, 4, 8, 3, 864),   # three chunks
    (2, 48, 4, 8, 1, 48),    # k 1, chunks of 32 + 16
    (1, 36, 4, 16, 5, 901),  # k 5, byte stores, chunks of 16 + 16 + 4
])
def test_kernel_emulation_with_chunks_matches_plain(rng, monkeypatch, b, c,
                                                    h, w, k, k_pad):
    """The same with the full-size tiles a large call takes (the tile
    count's floor lifted), so the channels come in several chunks: pass
    2 reuses pass 1's last chunk and the two buffers alternate."""
    monkeypatch.setattr(tp, "_Q8_MIN_TILES", 1)
    x = torch.as_tensor(rng.normal(size=(b, c, h, w)).astype(np.float32))
    assert -(-c // tp._q8_plan(b, c, h, w, k).cc) >= 2
    _check_emulation(x, k, k_pad)


def _check_emulation(x: torch.Tensor, k: int, k_pad: int) -> None:
    out, scale, amax, writes, scale_writes = _emulate_q8(x, k, k_pad)
    assert (writes == 1).all() and (scale_writes == 1).all()
    rows = tp.conv_patches_plain(x, k, k_pad)
    want_q, _ = tp.conv_patches_q8_plain(x, k, k_pad)
    np.testing.assert_array_equal(out, want_q.numpy().astype(np.int16))
    np.testing.assert_array_equal(amax, rows.abs().amax(dim=-1).numpy())
    np.testing.assert_array_equal(scale, _card_scale(rows).numpy())


@pytest.mark.parametrize("k", [1, 3])
def test_kernel_emulation_ties_and_zero_rows(k):
    """Exact .5 ties round half to even, and all-zero rows (a whole zero
    image and the zero rows of another) give scale 0 and zero bytes."""
    x = _tie_image(2, 20, 5, 6, seed=3)
    rows = tp.conv_patches_plain(x, k, 20 * k * k)
    live = rows[:, : 20 * k * k]
    assert (live.abs() % 1 == 0.5).any()  # the ties are there
    _check_emulation(x, k, 20 * k * k + 4)
    xq, _ = tp.conv_patches_q8_plain(x, k, 20 * k * k)
    halves = live.abs() % 1 == 0.5
    assert (xq[:, : 20 * k * k][halves].abs() % 2 == 0).all()
    z = _zero_image(3, 8, 6, 5, seed=4)
    _check_emulation(z, k, 8 * k * k)
    xq, scale = tp.conv_patches_q8_plain(z, k, 8 * k * k)
    assert (scale[:30] == 0).all() and (xq[:30] == 0).all()
    assert (scale[30:60] == 0).sum() > 15


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 16, 1, 9),
                                   (3, 40, 6, 6)])
def test_row_amax_is_the_neighbourhoods_channel_amax(rng, shape, k, layout):
    """A row's amax is the largest, over its K x K positions, of each
    position's amax over the channels (0 outside the image, padded
    features 0): what phase 1 keeps."""
    x = _layout(torch.as_tensor(rng.normal(size=shape).astype(np.float32)),
                layout)
    b, c, h, w = shape
    pos = x.abs().amax(dim=1, keepdim=True)  # [B, 1, H, W]
    r = k // 2
    neigh = F.max_pool2d(F.pad(pos, (r, r, r, r)), k, stride=1)
    want = neigh.permute(0, 2, 3, 1).reshape(-1)
    rows = tp.conv_patches_plain(x, k, c * k * k + 5)
    assert torch.equal(rows.abs().amax(dim=-1), want)


@pytest.mark.parametrize("shapes,batch", [(VGG16_IMAGENET, 16),
                                          (VGG16_CIFAR10, 128)])
def test_q8_plan_fits_every_vgg16_conv(shapes, batch):
    """Shared memory within 48 KB, every chunk's first feature on a
    16-byte boundary, a quad of channels for every thread in each chunk,
    the tile count that fills the card where the rows allow it, the grid
    within CUDA's limits."""
    for c, s in shapes:
        pl = tp._q8_plan(batch, c, s, s, 3)
        npix = pl.tb * pl.th * pl.tw
        rows = batch * s * s
        k_pad = -(-c * 9 // BLOCK) * BLOCK
        assert pl.smem <= 48 * 1024 and k_pad % 16 == 0
        assert pl.cc >= c or pl.cc % 16 == 0
        assert all(c0 * 9 % 16 == 0 for c0 in range(0, c, pl.cc))
        assert npix * -(-min(c, pl.cc) // 4) >= tp._Q8_THREADS  # busy
        assert pl.tiles * npix >= rows and pl.tiles < 2 ** 31
        assert pl.tiles >= min(tp._Q8_MIN_TILES, rows // 8)
        assert pl.tw <= 32 and pl.th <= s and pl.tb <= batch


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_q8_plan_never_needs_more_than_48kb(k):
    for b in (1, 3, 16, 128):
        for c in (1, 3, 4, 17, 64, 512):
            for h, w in ((1, 1), (2, 2), (7, 1), (1, 7), (64, 1), (300, 1),
                         (300, 3), (14, 14), (33, 65), (224, 224)):
                pl = tp._q8_plan(b, c, h, w, k)
                assert pl.smem <= 48 * 1024, (b, c, h, w, k, pl)
                assert pl.cc >= c or pl.cc % 16 == 0


def test_q8_store_width_follows_k_pad():
    assert tp._q8_store_width(torch.zeros((4, 640), dtype=torch.int8)) == 16
    assert tp._q8_store_width(torch.zeros((4, 72), dtype=torch.int8)) == 1
    shifted = torch.zeros(4 * 640 + 1, dtype=torch.int8)[1:].view(4, 640)
    assert tp._q8_store_width(shifted) == 1


def test_q8_wrapper_refuses_bad_calls():
    x = torch.zeros((1, 3, 4, 4))
    with pytest.raises(ValueError, match="exceed the padded K"):
        tp.conv_patches_q8_cuda(x, 3, 26)
    with pytest.raises(ValueError, match="must be odd"):
        tp.conv_patches_q8_cuda(x, 2, 64)
    with pytest.raises(ValueError, match=r"\[B, C, H, W\]"):
        tp.conv_patches_q8_cuda(x[0], 3, 27)
    with pytest.raises(ValueError, match=r"require\(s\) grad"):
        tp.conv_patches_q8_cuda(x.clone().requires_grad_(), 3, 27)
    with pytest.raises(ValueError, match="unsupported device"):
        tp.conv_patches_q8_cuda(x.to("meta"), 3, 27)


def _mini_program(precision: str):
    from repro_torch.engine import CompileOptions, compile_network
    from repro_torch.models.cnn import mini_cnn_config, params_from_numpy

    cfg = mini_cnn_config(4, 12, (8, 16, 16))
    rng = np.random.default_rng(3)
    params = {}
    for i, (ci, co) in enumerate(cfg.conv_channels, start=1):
        wt = rng.normal(size=(co, ci, 3, 3)) * np.sqrt(2 / (ci * 9))
        wt[np.abs(wt) < np.quantile(np.abs(wt), 0.7)] = 0.0
        params[f"conv{i}"] = {"w": wt.astype(np.float32),
                              "b": np.zeros(co, np.float32)}
    params["fc"] = {"w": (rng.normal(size=(16, 4)) / 4).astype(np.float32),
                    "b": np.zeros(4, np.float32)}
    return compile_network(cfg, params_from_numpy(params),
                           options=CompileOptions(precision=precision,
                                                  block=16, tile=16),
                           device="cpu")


def test_int8_conv_fused_route_equals_float_rows_route(monkeypatch):
    """Each int8 conv of a mini program through ``_run_conv`` takes the
    fused route (one ``conv_patches_q8_cuda`` call, no float rows) and
    gives the float rows' route's output (patch rows, ``quantize_rows``,
    the walk and the Output Indexing Unit) bit for bit."""
    prog = _mini_program("int8")
    disp = executor._Dispatch(torch.device("cpu"))
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(3, 1, 12, 12)).astype(np.float32))
    calls = []
    fused = executor.conv_patches_q8_cuda
    monkeypatch.setattr(executor, "conv_patches_q8_cuda",
                        lambda *a: calls.append(a) or fused(*a))
    for op in prog.convs:
        prepared = disp.prepare(op.bp, op.bias)
        n = len(calls)
        y, counts = executor._run_conv(op, x, disp, prepared)
        assert len(calls) == n + 1 and counts is None
        b, _, h, w = x.shape
        rows = tp.conv_patches_cuda(x, op.kernel, op.bp.k_in)
        want = disp.walk(quantize_rows(rows), prepared)
        want = want.index_select(1, prepared.inv_order)
        want = want[:, :op.c_out] + prepared.bias
        want = want.reshape(b, h, w, op.c_out).permute(0, 3, 1, 2)
        want = torch.relu(executor.channel_norm(want))
        if op.pool_after:
            want = executor.max_pool_2x2(want)
        assert torch.equal(y, want)
        x = y


def test_int8_convs_take_the_fused_route_with_and_without_stats(
        monkeypatch):
    """An int8 program's convs take their spmm rows from the fused launch
    once per conv, with or without ``collect_stats``; the stats add one
    float patch launch per conv, for the counters alone, and leave the
    logits as they are.  An fp32 program launches no fused kernel."""
    from repro_torch.engine import make_forward

    calls = {"fused": 0, "patches": 0}

    def counted(key, f):
        def wrapped(*a, **k):
            calls[key] += 1
            return f(*a, **k)
        return wrapped

    monkeypatch.setattr(executor, "conv_patches_q8_cuda",
                        counted("fused", executor.conv_patches_q8_cuda))
    monkeypatch.setattr(executor, "conv_patches_cuda",
                        counted("patches", executor.conv_patches_cuda))
    x = np.random.default_rng(6).normal(size=(2, 1, 12, 12)).astype(
        np.float32)
    make_forward(_mini_program("fp32"), device="cpu")(x)
    assert calls == {"fused": 0, "patches": 3}
    prog = _mini_program("int8")
    fused = make_forward(prog, device="cpu")(x)
    assert calls == {"fused": 3, "patches": 3}
    stats, _ = make_forward(prog, collect_stats=True, device="cpu")(x)
    assert calls == {"fused": 6, "patches": 6}
    assert torch.equal(fused, stats)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _card_check(x: torch.Tensor, k: int, k_pad: int, label) -> None:
    n0 = tp.conv_patches_q8_cuda.launches
    xq, scale = tp.conv_patches_q8_cuda(x, k, k_pad)
    torch.cuda.synchronize()
    assert tp.conv_patches_q8_cuda.launches == n0 + 1
    want_q, want_s = tp.conv_patches_q8_plain(x, k, k_pad)
    assert torch.equal(xq, want_q), label
    assert torch.equal(scale, want_s), label


@pytest.mark.gpu
def test_q8_kernel_matches_plain_at_every_imagenet_conv_on_card():
    """Every ImageNet VGG16 conv at 16 x 224^2 in the executor's layouts
    (the uploaded NCHW images, then channels-last maps) and the CIFAR-10
    convs at 128 x 32^2: one launch each, the plain version's int8 rows
    and row scales bit for bit."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for shapes, batch in ((VGG16_IMAGENET, 16), (VGG16_CIFAR10, 128)):
        for i, (c, s) in enumerate(shapes):
            base = torch.randn((batch, c, s, s), generator=gen, device=dev)
            x = _layout(base.relu() if i else base,
                        "nchw" if i == 0 else "channels_last")
            _card_check(x, 3, -(-c * 9 // BLOCK) * BLOCK, (batch, c, s))
            del base, x


@pytest.mark.gpu
def test_q8_kernel_ragged_shapes_on_card():
    """Odd maps, k_pad not a multiple of 16 (byte stores), every side,
    both halo modes (channels-last with C % 4 != 0, or a misaligned
    view, takes the strided loads), chunks with a ragged last one, a
    batch whose last tile of images is short, exact ties and all-zero
    rows."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [((3, 5, 7, 9), 1, 47), ((3, 5, 7, 9), 3, 48),
             ((2, 40, 9, 33), 3, 361), ((2, 40, 9, 33), 3, 368),
             ((2, 6, 5, 5), 5, 151), ((2, 12, 8, 8), 7, 592),
             ((17, 8, 2, 2), 3, 80), ((16, 64, 14, 14), 3, 640),
             ((3, 512, 5, 3), 3, 4608), ((1, 1, 3, 300), 3, 16)]
    for (b, c, h, w), k, k_pad in cases:
        base = torch.randn((b, c, h, w), generator=gen, device=dev)
        flat = torch.empty(base.numel() + 1, device=dev)[1:]
        shifted = flat.view(b, h, w, c)
        shifted.copy_(base.permute(0, 2, 3, 1))
        for x in (base, _layout(base, "channels_last"),
                  shifted.permute(0, 3, 1, 2)):
            _card_check(x, k, k_pad, ((b, c, h, w), k, k_pad,
                                      tp._halo_mode(x)))
    for x in (_tie_image(3, 20, 9, 7, seed=3), _zero_image(3, 20, 9, 7, 4)):
        for layout in ("nchw", "channels_last"):
            _card_check(_layout(x.to(dev), layout), 3, 20 * 9 + 12, layout)


@pytest.mark.gpu
def test_served_int8_forward_quantizes_in_the_patch_kernel_on_card(
        monkeypatch):
    """A served VGG16 int8 forward launches the fused kernel once per conv
    (13) and ``quantize_rows`` for the FC alone, with the logits of the
    same forward on the plain version; an fp32 forward launches it
    never."""
    dev = _card()
    from repro_torch.core.synthetic import synthesize_network
    from repro_torch.engine import CompileOptions, compile_network
    from repro_torch.engine import make_forward
    from repro_torch.models.cnn import params_from_numpy, vgg16_config

    stats, layers = synthesize_network("cifar10", seed=0)
    cfg = vgg16_config(num_classes=10, input_hw=stats.input_hw)
    rng = np.random.default_rng(1)
    params = {}
    for i, layer in enumerate(layers, start=1):
        spec = layer.spec
        params[f"conv{i}"] = {
            "w": layer.weights.reshape(spec.c_out, spec.c_in, 3, 3),
            "b": np.zeros(spec.c_out, np.float32)}
    params["fc"] = {"w": (rng.normal(size=(512, 10)) / np.sqrt(512))
                    .astype(np.float32), "b": np.zeros(10, np.float32)}
    bits = {f"conv{i}": layer.pattern_bits
            for i, layer in enumerate(layers, start=1)}
    progs = {p: compile_network(cfg, params_from_numpy(params, dev), bits,
                                options=CompileOptions(precision=p),
                                device=dev)
             for p in ("fp32", "int8")}
    quantized = []
    quant = executor.quantize_rows
    monkeypatch.setattr(executor, "quantize_rows",
                        lambda x: quantized.append(x.shape) or quant(x))
    images = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
    fwd = make_forward(progs["int8"], device=dev)
    fwd(images)
    torch.cuda.synchronize()
    n0, quantized[:] = tp.conv_patches_q8_cuda.launches, []
    logits = fwd(images)
    torch.cuda.synchronize()
    assert tp.conv_patches_q8_cuda.launches - n0 == 13
    assert quantized == [(8, progs["int8"].fc.bp.k_in)]
    n0 = tp.conv_patches_q8_cuda.launches
    make_forward(progs["fp32"], device=dev)(images)
    torch.cuda.synchronize()
    assert tp.conv_patches_q8_cuda.launches == n0
    monkeypatch.setattr(executor, "conv_patches_q8_cuda",
                        tp.conv_patches_q8_plain)
    plain = make_forward(progs["int8"], device=dev)(images)
    assert torch.equal(logits, plain)
