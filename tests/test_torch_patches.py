"""The conv patch kernel (``kernels/patches.py``) on the CPU and on the card.

On the CPU: the wrapper's plain version against an im2col built
independently of ``F.unfold``, the kernel's tiling emulated step by step
against the plain version, its plan and access modes, and the executor's
conv layer (spmm input, output and skip counts) against the layer as it
ran before the kernel.  On the card (``-m gpu``): the kernel against its
plain version bit for bit at every VGG16 conv shape, ragged shapes, and a
served forward.  The file imports no JAX, so the card's run collects it.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.engine import executor  # noqa: E402
from repro_torch.engine.stats import skip_patterns_and_masks  # noqa: E402
from repro_torch.kernels import patches as tp  # noqa: E402
from repro_torch.kernels._build import find_nvcc  # noqa: E402

# VGG16's convs (C_in, side of the map) at the benchmark's two inputs
VGG16_IMAGENET = [(3, 224), (64, 224), (64, 112), (128, 112), (128, 56),
                  (256, 56), (256, 56), (256, 28), (512, 28), (512, 28),
                  (512, 14), (512, 14), (512, 14)]
VGG16_CIFAR10 = [(c, s // 7) for c, s in VGG16_IMAGENET]
BLOCK = 128  # the served programs' brick depth: K is padded to it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one worker per core; torch's own intra-op pool
    would oversubscribe the cores the other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    """``x`` as NCHW-contiguous, or as the channels-last view the executor
    hands on (the permuted [B, H, W, C] of the spmm's output)."""
    if layout == "nchw":
        return x.contiguous()
    return x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _im2col(x: torch.Tensor, k: int, k_pad: int) -> torch.Tensor:
    """Padded patch rows from shifted slices of the zero-padded map,
    without ``F.unfold``: [B*H*W, k_pad], feature c*k*k + dy*k + dx."""
    b, c, h, w = x.shape
    r = k // 2
    xp = F.pad(x, (r, r, r, r))
    taps = torch.stack([xp[:, :, dy:dy + h, dx:dx + w]
                        for dy in range(k) for dx in range(k)], dim=2)
    rows = taps.permute(0, 3, 4, 1, 2).reshape(b * h * w, c * k * k)
    out = torch.zeros((b * h * w, k_pad), dtype=x.dtype)
    out[:, :c * k * k] = rows
    return out


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("c", [3, 64, 128])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_plain_version_is_padded_im2col(rng, k, c, padded, layout):
    """On a CPU tensor the wrapper runs its plain version: the rows of
    ``extract_patches`` zero-padded to ``k_pad``, equal to an im2col made
    without ``F.unfold``, in either layout, and counting no launch."""
    x = _layout(torch.as_tensor(
        rng.normal(size=(2, c, 5, 7)).astype(np.float32)), layout)
    k_pad = c * k * k + (37 if padded else 0)
    before = tp.conv_patches_cuda.launches
    got = tp.conv_patches_cuda(x, k, k_pad)
    assert tp.conv_patches_cuda.launches == before
    assert got.shape == (2 * 5 * 7, k_pad) and got.is_contiguous()
    rows = tp.extract_patches(x, k).reshape(-1, c * k * k)
    assert torch.equal(got, F.pad(rows, (0, k_pad - c * k * k)))
    assert torch.equal(got, _im2col(x, k, k_pad))


def _emulate(x: torch.Tensor, k: int, k_pad: int):
    """``csrc/conv_patches.cu`` step by step on the CPU: each block
    (tile, chunk) of ``_patch_plan`` stages its halo from the image
    (zero outside it) into a shared-memory array that starts as NaN, then
    writes its pixels' features in stores of ``vec`` floats.  Returns the
    output (NaN where nothing wrote) and how often each entry was
    written."""
    xn = x.numpy()
    b, c, h, w = xn.shape
    pl = tp._patch_plan(b, c, h, w, k)
    kk, r = k * k, k // 2
    hh, hw = pl.th + k - 1, pl.tw + k - 1
    plane = (hh * hw) | 1
    assert 4 * pl.tb * pl.cc * plane == pl.smem
    vec = 4 if k_pad % 4 == 0 else 1
    xp = np.pad(xn, ((0, 0), (0, 0), (r, r + pl.th), (r, r + pl.tw)))
    out = np.full((b * h * w, k_pad), np.nan, np.float32)
    writes = np.zeros(out.shape, np.int32)
    tiles_x, tiles_y = -(-w // pl.tw), -(-h // pl.th)
    assert pl.tiles == -(-b // pl.tb) * tiles_y * tiles_x
    for bx in range(pl.tiles):
        t = bx
        x0 = (t % tiles_x) * pl.tw
        t //= tiles_x
        y0 = (t % tiles_y) * pl.th
        b0 = (t // tiles_y) * pl.tb
        for by in range(pl.chunks):
            c0 = by * pl.cc
            nc, nb = min(pl.cc, c - c0), min(pl.tb, b - b0)
            smem = np.full(pl.tb * pl.cc * plane, np.nan, np.float32)
            for bb in range(nb):
                for ci in range(nc):
                    at = (bb * pl.cc + ci) * plane
                    smem[at:at + hh * hw] = xp[b0 + bb, c0 + ci,
                                               y0:y0 + hh,
                                               x0:x0 + hw].reshape(-1)
            f0 = c0 * kk
            f1 = k_pad if c0 + pl.cc >= c else (c0 + pl.cc) * kk
            assert (f1 - f0) % vec == 0
            f = np.arange(f0, f1)
            ch, tap = f // kk, f % kk
            dy, dx = tap // k, tap % k
            for p in range(pl.tb * pl.th * pl.tw):
                px, rr = p % pl.tw, p // pl.tw
                py, bb = rr % pl.th, rr // pl.th
                gy, gx = y0 + py, x0 + px
                if bb >= nb or gy >= h or gx >= w:
                    continue
                row = ((b0 + bb) * h + gy) * w + gx
                assert (row * k_pad + f0) % vec == 0  # aligned stores
                idx = (bb * pl.cc * plane + py * hw + px
                       + (ch - c0) * plane + dy * hw + dx)
                live = ch < c
                assert idx[live].max(initial=0) < smem.size
                out[row, f0:f1] = np.where(live, smem[np.where(live, idx, 0)],
                                           0.0)
                writes[row, f0:f1] += 1
    return out, writes


@pytest.mark.parametrize("b,c,h,w,k,k_pad", [
    (2, 3, 5, 7, 3, 128),    # conv1: one chunk, mostly padding
    (2, 3, 5, 7, 1, 3),      # k 1, nothing padded, 4-byte stores
    (2, 5, 6, 9, 5, 127),    # k 5, odd K: 4-byte stores
    (3, 40, 4, 4, 3, 361),   # two chunks (32 + 8), images share a block
    (17, 8, 2, 2, 3, 72),    # 16 images a block, 17: a ragged last tile
    (2, 64, 9, 33, 3, 640),  # rows cut in two tiles of 17, ragged rows
    (2, 64, 14, 14, 7, 3200),  # k 7
])
def test_kernel_emulation_matches_plain(rng, b, c, h, w, k, k_pad):
    """The kernel's tiling, halo staging and stores, emulated, write every
    output once, read only staged halo, and give the plain version's
    rows bit for bit."""
    x = torch.as_tensor(rng.normal(size=(b, c, h, w)).astype(np.float32))
    out, writes = _emulate(x, k, k_pad)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, tp.conv_patches_plain(x, k, k_pad))


def _halo_order(mode: int, nb: int, nc: int, hh: int, hw: int) -> list:
    """The (image, channel, row, column) each step of the kernel's halo
    loop stages, in its order, for halo ``mode``."""
    staged = []
    if mode == 1:
        nq = nc // 4
        for i in range(nb * hh * hw * nq):
            q, pos = i % nq, i // nq
            xx, pos = pos % hw, pos // hw
            staged += [(pos // hh, 4 * q + j, pos % hh, xx) for j in range(4)]
        return staged
    for i in range(nb * hh * hw * nc):
        xx, row = i % hw, i // hw
        yy, ci, bb = row % hh, (row // hh) % nc, row // (hh * nc)
        staged.append((bb, ci, yy, xx))
    return staged


@pytest.mark.parametrize("mode,nc", [(0, 8), (1, 8), (0, 3)])
def test_halo_loop_stages_each_element_once(mode, nc):
    nb, hh, hw = 3, 4, 6
    staged = _halo_order(mode, nb, nc, hh, hw)
    assert sorted(staged) == [(b, c, y, x) for b in range(nb)
                              for c in range(nc) for y in range(hh)
                              for x in range(hw)]
    fastest = {0: 3, 1: 1}[mode]  # columns for any strides, else channels
    assert staged[1][fastest] == staged[0][fastest] + 1


@pytest.mark.parametrize("shapes,batch", [(VGG16_IMAGENET, 16),
                                          (VGG16_CIFAR10, 128)])
def test_patch_plan_fits_every_vgg16_conv(shapes, batch):
    """About 64 output pixels a block, halo within 48 KB, 16-byte store
    alignment kept across chunks, the grid within CUDA's limits."""
    for c, s in shapes:
        pl = tp._patch_plan(batch, c, s, s, 3)
        assert pl.smem <= 48 * 1024
        assert 32 <= pl.tb * pl.th * pl.tw <= 64
        assert pl.tw <= 32 and pl.th <= s and pl.tb <= batch
        assert pl.cc == min(c, 32) and (pl.chunks == 1 or pl.cc % 4 == 0)
        assert pl.chunks * pl.cc >= c > (pl.chunks - 1) * pl.cc
        assert pl.tiles * pl.tb * pl.th * pl.tw >= batch * s * s
        assert pl.tiles < 2 ** 31 and pl.chunks <= 65535


def test_patch_plan_shrinks_to_fit_shared_memory():
    pl = tp._patch_plan(128, 512, 2, 2, 7)  # 16 images of 8 x 8 halos
    assert pl.smem <= 48 * 1024 and pl.tb < 16 and pl.cc == 32


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_patch_plan_halo_never_needs_more_than_48kb(k):
    """The kernel takes no more shared memory than a block gets without
    opting in, and refuses a plan that would: every plan fits, down to
    one-column maps, where a tile is one tall column of pixels."""
    for b in (1, 3, 16, 128):
        for c in (1, 3, 4, 64, 512):
            for h, w in ((1, 1), (2, 2), (7, 1), (1, 7), (64, 1), (300, 1),
                         (300, 3), (14, 14), (33, 65), (224, 224)):
                pl = tp._patch_plan(b, c, h, w, k)
                assert pl.smem <= 48 * 1024, (b, c, h, w, k, pl)


def test_halo_mode_and_store_width_follow_the_layout(rng):
    x = torch.zeros((2, 64, 6, 6))
    assert tp._halo_mode(x) == 0  # NCHW: columns innermost
    assert tp._halo_mode(_layout(x, "channels_last")) == 1
    assert tp._halo_mode(_layout(torch.zeros((2, 6, 6, 6)),
                                 "channels_last")) == 0  # C % 4 != 0
    shifted = torch.zeros(2 * 6 * 6 * 64 + 1)[1:].view(2, 6, 6, 64)
    assert tp._halo_mode(shifted.permute(0, 3, 1, 2)) == 0  # misaligned
    assert tp._halo_mode(torch.zeros((2, 1, 6, 6))) == 0
    assert tp._store_width(torch.zeros((4, 640))) == 4
    assert tp._store_width(torch.zeros((4, 47))) == 1


def test_wrapper_refuses_bad_calls():
    x = torch.zeros((1, 3, 4, 4))
    with pytest.raises(ValueError, match="exceed the padded K"):
        tp.conv_patches_cuda(x, 3, 26)
    with pytest.raises(ValueError, match="must be odd"):
        tp.conv_patches_cuda(x, 2, 64)
    with pytest.raises(ValueError, match=r"\[B, C, H, W\]"):
        tp.conv_patches_cuda(x[0], 3, 27)


def _mini_program():
    from repro_torch.engine import compile_network
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
    return compile_network(cfg, params_from_numpy(params), device="cpu")


def test_run_conv_keeps_spmm_input_output_and_skip_counts():
    """Each conv of a mini program through ``_run_conv`` with skip
    counting: the spmm sees the padded rows the layer built before the
    kernel (unfold, transpose, pad), the counts read the unpadded
    features as before, and the layer's output is unchanged."""
    prog = _mini_program()
    disp = executor._Dispatch(torch.device("cpu"))
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(3, 1, 12, 12)).astype(np.float32))
    x[2] = 0.0  # a dead slot
    valid = torch.tensor([True, True, False])
    seen = []
    walk = disp.walk
    disp.walk = lambda operand, prepared: (seen.append(operand)
                                           or walk(operand, prepared))
    for op in prog.convs:
        kk = op.kernel * op.kernel
        _, masks = skip_patterns_and_masks(op.pattern_bits, kk)
        masks = torch.as_tensor(masks)
        prepared = disp.prepare(op.bp, op.bias)
        y, counts = executor._run_conv(op, x, disp, prepared, masks, valid)
        b, _, h, w = x.shape
        rows = tp.extract_patches(x, op.kernel).reshape(b * h * w, -1)
        want_counts = executor.zero_selection_counts(
            rows, op.c_in, kk, masks, valid.repeat_interleave(h * w))
        assert torch.equal(counts, want_counts)
        padded = executor._pad_features(rows, op.bp.k_in)
        (operand,) = seen[-1]
        assert torch.equal(operand, padded)
        want = walk((padded,), prepared).index_select(1, prepared.inv_order)
        want = want[:, :op.c_out] + prepared.bias
        want = want.reshape(b, h, w, op.c_out).permute(0, 3, 1, 2)
        want = torch.relu(executor.channel_norm(want))
        if op.pool_after:
            want = executor.max_pool_2x2(want)
        assert torch.equal(y, want)
        x = y


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _k_pad(c: int, k: int = 3) -> int:
    return -(-c * k * k // BLOCK) * BLOCK


@pytest.mark.gpu
def test_kernel_matches_plain_at_every_vgg16_conv_on_card():
    """Every VGG16 conv shape at 16 x 224^2 and 128 x 32^2, NCHW and
    channels-last: one launch each, the plain version's rows bit for
    bit."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for shapes, batch in ((VGG16_IMAGENET, 16), (VGG16_CIFAR10, 128)):
        for c, s in shapes:
            base = torch.randn((batch, c, s, s), generator=gen, device=dev)
            for layout in ("nchw", "channels_last"):
                x = _layout(base, layout)
                n0 = tp.conv_patches_cuda.launches
                got = tp.conv_patches_cuda(x, 3, _k_pad(c))
                torch.cuda.synchronize()
                assert tp.conv_patches_cuda.launches == n0 + 1
                want = tp.conv_patches_plain(x, 3, _k_pad(c))
                assert torch.equal(got, want), (batch, c, s, layout)
                del got, want
            del base


@pytest.mark.gpu
def test_kernel_ragged_shapes_on_card():
    """Odd maps, K not a multiple of 4 (4-byte stores), every side, both
    halo modes (channels-last with C % 4 != 0, or a misaligned view,
    takes the strided 4-byte loads), and a batch whose last tile of
    images is short."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [((3, 5, 7, 9), 1, 47), ((3, 5, 7, 9), 3, 47),
             ((2, 40, 9, 33), 3, 361), ((2, 6, 5, 5), 5, 151),
             ((2, 12, 8, 8), 7, 589), ((17, 8, 2, 2), 3, 72),
             ((16, 64, 14, 14), 3, 640)]
    for (b, c, h, w), k, k_pad in cases:
        base = torch.randn((b, c, h, w), generator=gen, device=dev)
        flat = torch.empty(base.numel() + 1, device=dev)[1:]
        shifted = flat.view(b, h, w, c)
        shifted.copy_(base.permute(0, 2, 3, 1))
        for x in (base, _layout(base, "channels_last"),
                  shifted.permute(0, 3, 1, 2)):
            got = tp.conv_patches_cuda(x, k, k_pad)
            torch.cuda.synchronize()
            assert torch.equal(got, tp.conv_patches_plain(x, k, k_pad)), (
                (b, c, h, w), k, k_pad, tp._halo_mode(x))


@pytest.mark.gpu
def test_served_forward_launches_once_a_conv_on_card(monkeypatch):
    """A VGG16 forward launches the kernel once per conv (13), and its
    logits equal those of the same forward on the plain patch rows."""
    dev = _card()
    from repro_torch.core.synthetic import synthesize_network
    from repro_torch.engine import compile_network, make_forward
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
    prog = compile_network(cfg, params_from_numpy(params, dev), bits,
                           device=dev)
    images = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
    fwd = make_forward(prog, device=dev)
    fwd(images)
    torch.cuda.synchronize()
    n0 = tp.conv_patches_cuda.launches
    logits = fwd(images)
    torch.cuda.synchronize()
    assert tp.conv_patches_cuda.launches - n0 == len(prog.convs) == 13
    monkeypatch.setattr(executor, "conv_patches_cuda", tp.conv_patches_plain)
    plain = make_forward(prog, device=dev)(images)
    assert torch.equal(logits, plain)
