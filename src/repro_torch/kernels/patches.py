"""Conv patch extraction (im2col) for Hopper, with its plain version.

    out[(b*H + y)*W + x, c*k*k + dy*k + dx] = x[b, c, y + dy - k//2, x + dx - k//2]

zero where a tap falls outside the image, and zero in the features from
``C*k*k`` to ``k_pad``: the padded patch rows a conv's pattern spmm reads
(``engine/lowering.conv_matrix``'s feature order).  ``conv_patches_cuda``
replaces no TPU kernel (the reference leaves im2col to XLA); it replaces
the port's ``F.unfold``, the transposing copy of its result and the zero
pad, one launch a layer in place of one a image.  The CUDA C++ is in
``csrc/conv_patches.cu``, built with ``nvcc`` for ``sm_90a`` at first use
(``_build.py``) and called through ctypes on PyTorch's current stream.

It is bound by bytes: a copy whose writes (the padded rows) are ``k*k``
times its reads and more.  Each output byte is written once, by 16-byte
stores where ``k_pad`` allows (:func:`_store_width`); each block stages
its tile's input halo for a chunk of channels in shared memory
(:func:`_patch_plan`), read in the order the strides favour
(:func:`_halo_mode`), so each activation leaves device memory about
once.  The input is read through its strides: the channels-last
activations between the executor's layers take no copy.

Beside the kernel is its plain version (the tests and the chip smoke run
compare against it) and a plain-integer launch counter,
``conv_patches_cuda.launches``, that grows by one per kernel launch and
nowhere else.  The wrapper takes its plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.

``conv_patches_q8_cuda`` is the int8 programs' twin (``csrc/
conv_patches_q8.cu``): the same rows quantized per row as
``core/quantize.quantize_rows`` quantizes them, int8 rows and float32 row
scales written in one launch, the float32 rows never written.  A block
owns a tile of pixels and all their channels (:func:`_q8_plan`) and
streams the tile's halo through shared memory twice, chunk by chunk:
once for each halo position's channel amax, whose largest over a
pixel's K x K positions is its row's amax, once to write the rows.  It
has its own plain version and counter, ``conv_patches_q8_cuda.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import quantize_rows
from repro_torch.kernels._build import load_library
from repro_torch.kernels._grad_guard import refuse_grad

__all__ = ["PatchPlan", "PatchQ8Plan", "conv_patches_cuda",
           "conv_patches_plain", "conv_patches_q8_cuda",
           "conv_patches_q8_plain", "extract_patches"]

_KERNEL_SIDES = (1, 3, 5, 7)  # csrc/conv_patches.cu's instantiations
_TILE_PIXELS = 64  # output pixels a block writes, about
_TILE_COLS = 32  # widest tile row
_CHUNK = 32  # input channels a block stages
_SMEM = 48 * 1024  # shared memory a block takes without opting in
_MAX_GRID_Y = 65535
_Q8_THREADS = 128  # csrc/conv_patches_q8.cu's block
_Q8_GROUP = 16  # channels a chunk counts in: 16*k*k bytes of a row
_Q8_MIN_TILES = 3 * 132  # blocks that fill the H100's SMs three deep


class PatchPlan(NamedTuple):
    """How the kernel cuts one call: a block stages ``cc`` channels of a
    tile of ``tb`` images x ``th`` rows x ``tw`` columns of output pixels
    (``smem`` bytes of halo) and writes their features; ``tiles`` x
    ``chunks`` blocks."""

    tb: int
    th: int
    tw: int
    cc: int
    tiles: int
    chunks: int
    smem: int


def _even(n: int, most: int) -> int:
    """The side of the fewest pieces of at most ``most`` that cut ``n``
    evenly (their last one the shortest by less than one a piece)."""
    pieces = -(-n // most)
    return -(-n // pieces)


def _patch_plan(b: int, c: int, h: int, w: int, k: int) -> PatchPlan:
    """The kernel's plan for x [b, c, h, w] and side ``k``, from these
    shapes alone.  About ``_TILE_PIXELS`` output pixels a block: rows of
    at most ``_TILE_COLS`` columns cut evenly, then as many rows, then
    as many images, as fill it (the small maps of the deep layers take
    several images a block).  ``_CHUNK`` channels a block, all of them
    where there are fewer; a chunk of a multiple of 4 channels keeps each
    block's first feature on a 16-byte boundary.  The tile's images, then
    its channels, are halved until the halo fits ``_SMEM``."""
    tw = _even(w, _TILE_COLS)
    th = _even(h, max(1, _TILE_PIXELS // tw))
    tb = max(1, min(b, _TILE_PIXELS // (th * tw)))
    cc = min(c, _CHUNK)
    plane = ((th + k - 1) * (tw + k - 1)) | 1

    def smem():
        return 4 * tb * cc * plane

    while smem() > _SMEM and tb > 1:
        tb = -(-tb // 2)
    while smem() > _SMEM and cc > 4:
        cc = max(4, (cc // 2) // 4 * 4)
    tiles = -(-b // tb) * -(-h // th) * -(-w // tw)
    return PatchPlan(tb, th, tw, cc, tiles, -(-c // cc), smem())


def _halo_mode(x: torch.Tensor) -> int:
    """How the blocks read their halo, from ``x``'s strides: 1 when the
    channels are the innermost axis and 4 of them make one aligned
    16-byte load (C and the other strides multiples of 4, x 16-byte
    aligned, as the executor's channels-last activations are), else 0
    (columns innermost, 4 bytes a load: NCHW, and any strides)."""
    sb, sc, sy, sx = x.stride()
    if (sc == 1 and x.shape[1] % 4 == 0 and sb % 4 == 0 and sy % 4 == 0
            and sx % 4 == 0 and x.data_ptr() % 16 == 0):
        return 1
    return 0


def _store_width(out: torch.Tensor) -> int:
    """Floats a store: 4 (16 bytes) when every row starts 16-byte aligned
    (``k_pad`` a multiple of 4, the output 16-byte aligned), else 1."""
    return 4 if out.shape[1] % 4 == 0 and out.data_ptr() % 16 == 0 else 1


def extract_patches(x: torch.Tensor, k: int) -> torch.Tensor:
    """im2col for stride-1 'same' convs: [B, C, H, W] -> [B, H, W, C*k*k].

    Feature index is ``c * k*k + (dy*k + dx)``, the layout of
    ``lowering.conv_matrix``; ``F.unfold`` orders its features exactly so
    (channel-major, then kernel row, then kernel column).
    """
    b, c, h, w = x.shape
    cols = F.unfold(x, kernel_size=k, padding=k // 2)  # [B, C*k*k, H*W]
    return cols.transpose(1, 2).reshape(b, h, w, c * k * k)


def _validate(x: torch.Tensor, k: int, k_pad: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv_patches: x must be [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"conv_patches: the 'same' side k must be odd, "
                         f"got {k}")
    if x.shape[1] * k * k > k_pad:
        raise ValueError(f"conv_patches: {x.shape[1] * k * k} features "
                         f"exceed the padded K={k_pad}")


def conv_patches_plain(x: torch.Tensor, k: int, k_pad: int) -> torch.Tensor:
    """Plain version of :func:`conv_patches_cuda`: :func:`extract_patches`
    as rows [B*H*W, C*k*k], zero-padded to ``k_pad`` features."""
    _validate(x, k, k_pad)
    b, c, h, w = x.shape
    rows = extract_patches(x, k).reshape(b * h * w, c * k * k)
    return F.pad(rows, (0, k_pad - c * k * k))


def conv_patches_cuda(x: torch.Tensor, k: int, k_pad: int) -> torch.Tensor:
    """Patch rows of a stride-1 'same' conv: x [B, C, H, W] (any strides)
    -> float32 [B*H*W, k_pad], row-major, features past ``C*k*k`` zero.
    On the card x must be float32 and ``k`` one of 1, 3, 5, 7.  An input
    that requires grad raises, on any device: the kernel has no
    backward."""
    refuse_grad("conv_patches_cuda", x=x)
    if x.device.type == "cpu":
        return conv_patches_plain(x, k, k_pad)
    if x.device.type != "cuda":
        raise ValueError(f"conv_patches_cuda: unsupported device {x.device}")
    _validate(x, k, k_pad)
    if x.dtype != torch.float32:
        raise ValueError(f"conv_patches_cuda: float32 input only, got "
                         f"{x.dtype}")
    if k not in _KERNEL_SIDES:
        raise ValueError(f"conv_patches_cuda: k={k} is not one of "
                         f"{_KERNEL_SIDES}")
    b, c, h, w = x.shape
    out = torch.empty((b * h * w, k_pad), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    plan = _patch_plan(b, c, h, w, k)
    if plan.chunks > _MAX_GRID_Y or plan.tiles >= 2 ** 31:
        raise ValueError(f"conv_patches_cuda: grid {plan.tiles} x "
                         f"{plan.chunks} exceeds the kernel's limits")
    fn = load_library().conv_patches_f32
    err = fn(x.data_ptr(), *x.stride(), out.data_ptr(), b, c, h, w, k, k_pad,
             plan.tb, plan.th, plan.tw, plan.cc, _halo_mode(x),
             _store_width(out), x.device.index or 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_patches_f32 launch failed: CUDA error {err}")
    conv_patches_cuda.launches += 1
    return out


conv_patches_cuda.launches = 0


class PatchQ8Plan(NamedTuple):
    """How the int8 kernel cuts one call: a block owns a tile of ``tb``
    images x ``th`` rows x ``tw`` columns of output pixels and all the
    channels, staged ``cc`` at a time (``smem`` bytes); ``tiles``
    blocks."""

    tb: int
    th: int
    tw: int
    cc: int
    tiles: int
    smem: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _q8_smem(tb: int, th: int, tw: int, cc: int, c: int, k: int) -> int:
    """A block's shared memory (``q8_layout`` in the CUDA source): each
    halo position's offset in x (8 bytes), the staged halo of
    ``round16(cc)`` channels a position (two buffers where ``c > cc``),
    the tile's int8 rows of a chunk, each halo position's channel amax
    and each pixel's inverse scale, output row and halo position."""
    n_pos = tb * (th + k - 1) * (tw + k - 1)
    npix = tb * th * tw
    cca = _round16(cc)
    rows = _round16(8 * n_pos) + (2 if c > cc else 1) * n_pos * cca * 4
    return rows + npix * cca * k * k + 4 * n_pos + 12 * npix


def _q8_plan(b: int, c: int, h: int, w: int, k: int) -> PatchQ8Plan:
    """The int8 kernel's plan for x [b, c, h, w] and side ``k``, from these
    shapes alone.  A tile of 32 output pixels (up to 128 where the
    channels make fewer than 8 quads, so a chunk still gives every thread
    a quad), halved down to 8 until the call makes ``_Q8_MIN_TILES``
    blocks; cut near square (``_even``'s columns of at most the tile's
    square root, rounded up to a power of two), then as many rows and
    images as fill it.  The chunk doubles from 16 channels until a
    chunk's quads (4 channels of one pixel) are twice the block's
    threads, or holds all the channels where there are fewer; 16 | cc
    keeps each chunk's first feature on a 16-byte boundary.  The chunk,
    then the tile's images, rows and columns are halved until the block's
    shared memory fits ``_SMEM``."""
    rows = b * h * w
    pixels = 32 if c > _Q8_GROUP else max(32, 128 // -(-c // 4))
    while pixels > 8 and -(-rows // pixels) < _Q8_MIN_TILES:
        pixels //= 2
    tw = _even(w, 2 ** (pixels.bit_length() // 2))
    th = _even(h, max(1, pixels // tw))
    tb = max(1, min(b, pixels // (th * tw)))
    cc = _Q8_GROUP
    while cc * tb * th * tw < 8 * _Q8_THREADS and cc < 256:
        cc *= 2
    cc = min(c, cc)
    while _q8_smem(tb, th, tw, cc, c, k) > _SMEM:
        if cc > _Q8_GROUP:
            cc = max(_Q8_GROUP, (cc // 2) // _Q8_GROUP * _Q8_GROUP)
        elif tb > 1:
            tb = -(-tb // 2)
        elif th > 1:
            th = -(-th // 2)
        else:
            tw = -(-tw // 2)
    tiles = -(-b // tb) * -(-h // th) * -(-w // tw)
    return PatchQ8Plan(tb, th, tw, cc, tiles,
                       _q8_smem(tb, th, tw, cc, c, k))


def _q8_store_width(xq: torch.Tensor) -> int:
    """Bytes a store: 16 when every row starts 16-byte aligned (``k_pad`` a
    multiple of 16, the rows 16-byte aligned), else 1."""
    return 16 if xq.shape[1] % 16 == 0 and xq.data_ptr() % 16 == 0 else 1


def conv_patches_q8_plain(
    x: torch.Tensor, k: int, k_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`conv_patches_q8_cuda`:
    ``quantize_rows(conv_patches_plain(x, k, k_pad))``.  On a CUDA tensor
    PyTorch computes the row scale ``amax / 127`` as ``amax * fl(1/127)``
    (its division by a scalar), which the kernel does; on the CPU it
    divides, which can differ in the last bit."""
    return quantize_rows(conv_patches_plain(x, k, k_pad))


def conv_patches_q8_cuda(
    x: torch.Tensor, k: int, k_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 patch rows of a stride-1 'same' conv and their row scales:
    x [B, C, H, W] (any strides) -> (int8 [B*H*W, k_pad], row-major,
    features past ``C*k*k`` zero; float32 [B*H*W]), equal to
    :func:`conv_patches_q8_plain` bit for bit.  On the card x must be
    float32 and ``k`` one of 1, 3, 5, 7.  An input that requires grad
    raises, on any device: the kernel has no backward."""
    refuse_grad("conv_patches_q8_cuda", x=x)
    if x.device.type == "cpu":
        return conv_patches_q8_plain(x, k, k_pad)
    if x.device.type != "cuda":
        raise ValueError(f"conv_patches_q8_cuda: unsupported device "
                         f"{x.device}")
    _validate(x, k, k_pad)
    if x.dtype != torch.float32:
        raise ValueError(f"conv_patches_q8_cuda: float32 input only, got "
                         f"{x.dtype}")
    if k not in _KERNEL_SIDES:
        raise ValueError(f"conv_patches_q8_cuda: k={k} is not one of "
                         f"{_KERNEL_SIDES}")
    b, c, h, w = x.shape
    xq = torch.empty((b * h * w, k_pad), dtype=torch.int8, device=x.device)
    scale = torch.empty(b * h * w, dtype=torch.float32, device=x.device)
    if xq.numel() == 0:
        return xq, scale
    plan = _q8_plan(b, c, h, w, k)
    if plan.tiles >= 2 ** 31 or b * h * w >= 2 ** 31:
        raise ValueError(f"conv_patches_q8_cuda: {b * h * w} rows in "
                         f"{plan.tiles} blocks exceed the kernel's limits")
    fn = load_library().conv_patches_q8
    err = fn(x.data_ptr(), *x.stride(), xq.data_ptr(), scale.data_ptr(), b,
             c, h, w, k, k_pad, plan.tb, plan.th, plan.tw, plan.cc,
             _halo_mode(x), _q8_store_width(xq), x.device.index or 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_patches_q8 launch failed: CUDA error {err}")
    conv_patches_q8_cuda.launches += 1
    return xq, scale


conv_patches_q8_cuda.launches = 0
