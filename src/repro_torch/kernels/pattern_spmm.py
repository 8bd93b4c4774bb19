"""Block-pattern sparse matmul kernels for Hopper, with their plain versions.

    y[:, tile_t] = sum_{k < nnz[t]}  x[:, block_ids[t,k]] @ w_comp[t, k]

``pattern_spmm_cuda`` replaces ``pattern_spmm_pallas`` and
``pattern_spmm_quant_cuda`` replaces ``pattern_spmm_pallas_quant``, both
in ``src/repro/kernels/pattern_spmm.py``.  The CUDA C++ is in
``csrc/pattern_spmm.cu``, built with ``nvcc`` for ``sm_90a`` at first use
(``_build.py``) and called through ctypes on PyTorch's current stream.

What bounds the fp32 kernel on the H100: its operations, at the CUDA
cores' 67 TFLOP/s.  IEEE fp32 has no tensor-core path (TF32 misses the
2e-5 bar), and a VGG16 forward's bricks hold more operations per byte
than that rate needs.  At the serving shapes (8 batch slots, 128 x 128
bricks) the deep layers have only 32 to 512 rows and 1 to 4 output
tiles, too few thread blocks for 132 SMs if each walked its tile's bricks
alone.  What the design does about it: :func:`_split_plan` picks, from
the shapes alone, a tile shape and a number of splits S that give about two
waves of blocks; each block walks one run of its tile's bricks and, with
S > 1, writes a partial that a second launch sums in the fixed order
0..S-1 (no atomics: bit-identical from run to run; S does not follow the
row count, so a row's result does not depend on the batch it is in).
Each thread holds an 8 x 8 (or 4 x 8) register tile read from shared
memory as float4, and ``cp.async`` stages the gathered x slices and
bricks of the next two steps while this one computes: 16-byte copies
where block, tile and K allow it, 4-byte copies otherwise
(:func:`_copy_width`).

The int8 kernel is bound by its bytes: the int8 tensor-core rate
outruns device memory.  It runs the same split walk under its own plan
(:func:`_quant_plan`: runs of at least 3 bricks, row tiles of 16, 32 or
64), each warp's products on the tensor cores (``mma.sync`` m16n8k32,
int8 in, exact int32 per brick), each brick's partial folded into an
fp32 accumulator in k order with the plain version's rounding.  8-bit MMAs
take B K-major, so it reads a K-major copy of the bricks
(:func:`kmajor_bricks`) that the executor makes once per program;
``cp.async`` stages 16, 4 or 1 bytes a copy (:func:`_quant_copy_width`).

Beside each kernel is its plain PyTorch version (the tests and the chip
smoke run compare against it) and a plain-integer launch counter,
``<wrapper>.launches``, that grows by one per call that launches the
kernel and nowhere else; ``<wrapper>.reduce_launches`` counts the split
reduction's launches.  A wrapper takes its plain version only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sparse import pattern_spmm_torch, pattern_spmm_torch_quant
from repro_torch.kernels._build import load_library
from repro_torch.kernels._grad_guard import refuse_grad

__all__ = [
    "SplitPlan",
    "kmajor_bricks",
    "pattern_spmm_cuda",
    "pattern_spmm_quant_cuda",
    "pattern_spmm_plain",
    "pattern_spmm_quant_plain",
]

_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y, which counts tiles
_SMS = 132  # streaming multiprocessors of the H100 SXM
# The fp32 kernel's block tiles (rows, columns, depth staged a step), by
# the config index csrc/pattern_spmm.cu's launch_config instantiates:
# 8 x 8 outputs a thread for 64 rows, 4 x 8 for 32, 4 x 4 for tiles of
# <= 32 columns.
_TILE_SHAPES = ((64, 128, 16), (32, 128, 16), (64, 32, 16), (32, 128, 32))
# The int8 plan splits a tile's bricks only from this many slots on, into
# runs of at least _QUANT_MIN_RUN (scripts/spmm_plan_sweep.py --kernel
# int8 measured every split count at VGG16's layers).
_QUANT_SPLIT_FROM = 8
_QUANT_MIN_RUN = 3
# The int8 kernel's block tiles (rows, columns, depth staged a step), by
# the config index its launch_config instantiates: 8 warps of 32 x 32
# outputs for 64 rows, 8 of 16 x 32 for 32 rows, 4 of 16 x 32 for 16
# rows, 2 of 16 x 32 for tiles of <= 32 columns.
_QUANT_TILE_SHAPES = ((64, 128, 64), (32, 128, 64), (16, 128, 64),
                      (32, 32, 64))


class SplitPlan(NamedTuple):
    """How a kernel cuts one call: block tile ``config`` (an index into
    ``_TILE_SHAPES``, or ``_QUANT_TILE_SHAPES`` for int8: ``bm`` x
    ``bn``, ``bk`` deep a step),
    ``splits`` runs of at most ``chunk`` bricks per tile of ``k_max``
    bricks (a tile of n bricks runs ``ceil(n / splits)`` each), and the
    first launch's ``blocks``."""

    config: int
    bm: int
    bn: int
    bk: int
    splits: int
    chunk: int
    blocks: int


def _splits(slabs: int, k_max: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): the bricks of a tile cut into runs of ``chunk``
    (down to one) until ``slabs`` column slabs give two waves of ``sms``
    blocks.  From the output tiles and ``k_max`` alone, never the rows."""
    chunk = -(-k_max // max(1, min(k_max, -(-2 * sms // slabs))))
    splits = -(-k_max // chunk) if k_max else 1  # no run of k_max is empty
    return splits, chunk


def _split_plan(m: int, t: int, tile: int, k_max: int,
                sms: int = _SMS) -> SplitPlan:
    """The fp32 kernel's plan for ``m`` rows, ``t`` output tiles of
    ``tile`` columns and ``k_max`` brick slots a tile, from these shapes
    alone (never from values or from how many rows are live).

    The split count follows the output tiles and ``k_max`` only, never
    the rows: the bits of an output depend on where its tile's bricks
    are split, so a request's logits are the same whether its batch has
    8 rows or 64, and a service's accumulated skip statistics equal a
    one-shot forward's.  The bricks are split (down to runs of one) until
    the column slabs alone give two waves of ``sms`` blocks; the row
    tiles add to that.  The block tile changes no bit of the result: 32
    columns for tiles of <= 32; else, by the blocks the grid holds at 32
    rows a block, 32 rows and 32-deep steps up to three waves (few
    blocks an SM: longer steps amortize each step's wait), 32 rows and
    16-deep steps up to eight (more blocks resident), 64 rows above
    (``scripts/spmm_plan_sweep.py`` measured each at VGG16's layers)."""
    bn = 32 if tile <= 32 else 128
    slabs = t * -(-tile // bn)
    splits, chunk = _splits(slabs, k_max, sms)
    blocks32 = -(-m // 32) * slabs * splits
    if tile <= 32:
        config = 2
    elif blocks32 <= 3 * sms:
        config = 3
    elif blocks32 <= 8 * sms:
        config = 1
    else:
        config = 0
    bm, bn, bk = _TILE_SHAPES[config]
    return SplitPlan(config, bm, bn, bk, splits, chunk,
                     -(-m // bm) * slabs * splits)


def _quant_plan(m: int, t: int, tile: int, k_max: int,
                sms: int = _SMS) -> SplitPlan:
    """The int8 kernel's plan for ``m`` rows, ``t`` output tiles of
    ``tile`` columns and ``k_max`` brick slots a tile, from these shapes
    alone.

    The split count follows the output tiles and ``k_max`` only, never
    the rows, so a row's bits are the same in a batch of any size.  A
    tile of fewer than ``_QUANT_SPLIT_FROM`` slots is walked whole: its
    at most 14 steps are short, and the layers that have such tiles
    (VGG16's conv1-3 and the FC) hold the most rows: 8192 at CIFAR-10's
    8 slots, 802,816 (conv1-2) at ImageNet's 16 (the benchmark's
    ``vgg16_imagenet_int8.bulk``), whose fp32 partials would cost more
    traffic than the split saves.  Larger tiles are split as
    the fp32 plan splits them (:func:`_splits`), in runs of at least
    ``_QUANT_MIN_RUN`` bricks: each brick is 4x fewer bytes than fp32's,
    so a one-brick run's partial outweighs its walk.  The rows choose
    only the block tile, which changes no bit: 32 columns for tiles of
    <= 32; else 16 rows up to 128 (an m16 MMA; more blocks at the deep
    layers, nothing wasted at the FC's 8), 32 rows up to eight waves of
    blocks, 64 above."""
    bn = 32 if tile <= 32 else 128
    slabs = t * -(-tile // bn)
    splits, chunk = 1, max(k_max, 1)
    if k_max >= _QUANT_SPLIT_FROM:
        _, chunk = _splits(slabs, k_max, sms)
        chunk = max(chunk, _QUANT_MIN_RUN)
        splits = -(-k_max // chunk)
    if tile <= 32:
        config = 3
    elif m <= 128:
        config = 2
    elif -(-m // 32) * slabs * splits <= 8 * sms:
        config = 1
    else:
        config = 0
    bm, bn, bk = _QUANT_TILE_SHAPES[config]
    return SplitPlan(config, bm, bn, bk, splits, chunk,
                     -(-m // bm) * slabs * splits)


def _copy_width(x, w_comp, block: int, tile: int) -> int:
    """Floats per ``cp.async`` of the fp32 kernel: 4 (16 bytes) when every
    row it copies starts 16-byte aligned (block, tile and K multiples of
    4 floats, x and the bricks 16-byte aligned), else 1 (block 9 and tile
    8 take this)."""
    aligned = (block % 4 == 0 and tile % 4 == 0 and x.shape[1] % 4 == 0
               and x.data_ptr() % 16 == 0 and w_comp.data_ptr() % 16 == 0)
    return 4 if aligned else 1


def _quant_copy_width(xq, w_kmajor, block: int) -> int:
    """Bytes per copy of the int8 kernel's staging: 16 when every row it
    copies (a gathered x slice, a K-major brick row) starts 16-byte
    aligned (block and K multiples of 16, both bases 16-byte aligned), 4
    when they are multiples of 4 and 4-byte aligned, else 1 (block 9)."""
    k_in = xq.shape[1]
    for width in (16, 4):
        if (block % width == 0 and k_in % width == 0
                and xq.data_ptr() % width == 0
                and w_kmajor.data_ptr() % width == 0):
            return width
    return 1


def kmajor_bricks(w_comp: torch.Tensor) -> torch.Tensor:
    """The bricks [T, k_max, block, tile] as a K-major copy [T, k_max,
    tile, block]: the layout the int8 kernel's MMAs read B in.  One more
    copy of the int8 weights on the device, made once per program by the
    executor; the saved program keeps only ``w_comp``."""
    return w_comp.transpose(2, 3).contiguous()


def pattern_spmm_plain(x, w_comp, block_ids, nnz, block: int) -> torch.Tensor:
    """Plain version of :func:`pattern_spmm_cuda`: float32 [M, T*tile] in
    reordered column order.  Walks all k_max slots (the padded ones hold
    zero weights), so ``nnz`` is not needed."""
    return pattern_spmm_torch(
        x.float(), w_comp, block_ids, block, out_dtype=torch.float32
    )


def pattern_spmm_quant_plain(
    xq, w_comp, block_ids, w_scales, nnz, block: int
) -> torch.Tensor:
    """Plain version of :func:`pattern_spmm_quant_cuda`: the weight-side
    dequantized float32 [M, T*tile], before the activation row scale."""
    return pattern_spmm_torch_quant(xq, None, w_comp, block_ids, w_scales, block)


class _Geometry(NamedTuple):
    m: int
    k_in: int
    t: int
    k_max: int
    block: int
    tile: int


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _operands(x, w_comp, block_ids, nnz, block, w_dtype):
    """Validate the kernel operands; return contiguous views and geometry."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    m, k_in = x.shape
    if w_comp.dim() != 4:
        raise ValueError(f"w_comp must be 4-D, got {tuple(w_comp.shape)}")
    t, k_max, blk, tile = w_comp.shape
    if blk != block or k_in % block:
        raise ValueError(f"K={k_in} / block={block} / brick depth {blk} disagree")
    if t > _MAX_GRID_Y:
        raise ValueError(f"{t} tiles exceed the kernel grid limit {_MAX_GRID_Y}")
    dev = x.device
    _check("w_comp", w_comp, w_dtype, (t, k_max, block, tile), dev)
    _check("block_ids", block_ids, torch.int32, (t, k_max), dev)
    _check("nnz", nnz, torch.int32, (t,), dev)
    return (x.contiguous(), w_comp.contiguous(), block_ids.contiguous(),
            nnz.contiguous(), _Geometry(m, k_in, t, k_max, block, tile))


def pattern_spmm_cuda(x, w_comp, block_ids, nnz, block: int, *,
                      plan: SplitPlan | None = None) -> torch.Tensor:
    """fp32 block-pattern spmm: x [M, K] -> float32 [M, T*tile], reordered
    columns.  ``block_ids`` and ``nnz`` are int32 on x's device; a bf16 or
    fp16 ``x`` is upcast to float32 (what ``jnp.dot(bf16, fp32)`` does).
    ``plan`` defaults to :func:`_split_plan` of the shapes.  An input that
    requires grad raises, on any device: the kernel has no backward."""
    refuse_grad("pattern_spmm_cuda", x=x, w_comp=w_comp)
    if x.device.type == "cpu":
        return pattern_spmm_plain(x, w_comp, block_ids, nnz, block)
    if x.device.type != "cuda":
        raise ValueError(f"pattern_spmm_cuda: unsupported device {x.device}")
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    _check("x", x, torch.float32, x.shape, x.device)
    x, w, ids, n, g = _operands(x, w_comp, block_ids, nnz, block,
                                torch.float32)
    y = torch.empty((g.m, g.t * g.tile), dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    if plan is None:
        plan = _split_plan(g.m, g.t, g.tile, g.k_max)
    ws = (torch.empty((plan.splits, g.m, g.t * g.tile), dtype=torch.float32,
                      device=x.device) if plan.splits > 1 else y)
    fn = load_library().pattern_spmm_f32
    err = fn(x.data_ptr(), w.data_ptr(), ids.data_ptr(), n.data_ptr(),
             y.data_ptr(), ws.data_ptr(), g.m, g.k_in, g.t, g.k_max, g.block,
             g.tile, plan.config, plan.splits,
             _copy_width(x, w, g.block, g.tile), x.device.index or 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    pattern_spmm_cuda.launches += 1
    if plan.splits > 1:
        pattern_spmm_cuda.reduce_launches += 1
    return y


pattern_spmm_cuda.launches = 0
pattern_spmm_cuda.reduce_launches = 0


def pattern_spmm_quant_cuda(
    xq, w_comp, block_ids, w_scales, nnz, block: int, *,
    w_kmajor: torch.Tensor | None = None, plan: SplitPlan | None = None,
) -> torch.Tensor:
    """int8 block-pattern spmm: xq int8 [M, K], int8 bricks with per-brick
    float32 ``w_scales`` [T, k_max] -> float32 [M, T*tile] in reordered
    columns, dequantized on the weight side only (the caller multiplies
    the per-row activation scale).  ``w_kmajor`` is
    :func:`kmajor_bricks` of ``w_comp``, made here per call when not
    given; ``plan`` defaults to :func:`_quant_plan` of the shapes.  An
    input that requires grad raises, on any device."""
    refuse_grad("pattern_spmm_quant_cuda", xq=xq, w_comp=w_comp,
                w_scales=w_scales)
    if xq.device.type == "cpu":
        return pattern_spmm_quant_plain(
            xq, w_comp, block_ids, w_scales, nnz, block
        )
    if xq.device.type != "cuda":
        raise ValueError(f"pattern_spmm_quant_cuda: unsupported device {xq.device}")
    _check("xq", xq, torch.int8, xq.shape, xq.device)
    x, w, ids, n, g = _operands(xq, w_comp, block_ids, nnz, block, torch.int8)
    _check("w_scales", w_scales, torch.float32, ids.shape, xq.device)
    if w_kmajor is None:
        w_kmajor = kmajor_bricks(w)
    _check("w_kmajor", w_kmajor, torch.int8, (g.t, g.k_max, g.tile, g.block),
           xq.device)
    wk = w_kmajor.contiguous()
    y = torch.empty((g.m, g.t * g.tile), dtype=torch.float32,
                    device=xq.device)
    if y.numel() == 0:
        return y
    if plan is None:
        plan = _quant_plan(g.m, g.t, g.tile, g.k_max)
    ws = (torch.empty((plan.splits, g.m, g.t * g.tile), dtype=torch.float32,
                      device=xq.device) if plan.splits > 1 else y)
    fn = load_library().pattern_spmm_i8
    err = fn(x.data_ptr(), wk.data_ptr(), ids.data_ptr(),
             w_scales.contiguous().data_ptr(), n.data_ptr(), y.data_ptr(),
             ws.data_ptr(), g.m, g.k_in, g.t, g.k_max, g.block, g.tile,
             plan.config, plan.splits, _quant_copy_width(x, wk, g.block),
             xq.device.index or 0,
             torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    pattern_spmm_quant_cuda.launches += 1
    if plan.splits > 1:
        pattern_spmm_quant_cuda.reduce_launches += 1
    return y


pattern_spmm_quant_cuda.launches = 0
pattern_spmm_quant_cuda.reduce_launches = 0
