"""Block-pattern sparse matmul kernels for Hopper, with their plain versions.

    y[:, tile_t] = sum_{k < nnz[t]}  x[:, block_ids[t,k]] @ w_comp[t, k]

``pattern_spmm_cuda`` replaces ``pattern_spmm_pallas`` and
``pattern_spmm_quant_cuda`` replaces ``pattern_spmm_pallas_quant``, both
in ``src/repro/kernels/pattern_spmm.py``.  The CUDA C++ is in
``csrc/pattern_spmm.cu``, built with ``nvcc`` for ``sm_90a`` at first use
(``_build.py``) and called through ctypes on PyTorch's current stream.

What bounds them on the H100: the fp32 kernel by its operations — IEEE
fp32 has no tensor-core path (TF32 is not IEEE), so its ceiling is the
CUDA cores' fp32 rate, and a VGG16 forward's bricks hold more
operations per byte than that rate needs; the int8 kernel by its bytes,
since the int8 tensor-core rate outruns device memory.  At the serving
shapes (8 batch slots, 128x128 bricks) the deep layers are further held
by their grid: the 4x4 and 2x2 maps give 128 and 32 rows, so 8 to 16
thread blocks for 132 SMs (``PERF.md`` has the per-layer times).
What the design does about it: one thread block per (64-row tile, output
tile, 64-column slab) walks only that tile's ``nnz[t]`` real bricks —
the padded slots are never read — and stages the gathered x slice and
the brick in shared memory 32 rows of depth at a time, so each staged
value is reused by 16 threads from shared memory instead of device
memory.  It is a simple SIMT kernel: ``wgmma``, TMA, int8 MMA and a
split of the deep layers' depth over more blocks are later work.

Beside each kernel is its plain PyTorch version (the tests and the chip
smoke run compare against it) and a plain-integer launch counter,
``<wrapper>.launches``, that grows by one per kernel launch and nowhere
else.  A wrapper takes its plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sparse import pattern_spmm_torch, pattern_spmm_torch_quant
from repro_torch.kernels._build import load_library

__all__ = [
    "pattern_spmm_cuda",
    "pattern_spmm_quant_cuda",
    "pattern_spmm_plain",
    "pattern_spmm_quant_plain",
]

_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y, which counts tiles


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


def _launch(fn, tensors, out, g: _Geometry, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(a.data_ptr() for a in tensors), out.data_ptr(),
             g.m, g.k_in, g.t, g.k_max, g.block, g.tile, device.index or 0,
             stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def pattern_spmm_cuda(x, w_comp, block_ids, nnz, block: int) -> torch.Tensor:
    """fp32 block-pattern spmm: x [M, K] -> float32 [M, T*tile], reordered
    columns.  ``block_ids`` and ``nnz`` are int32 on x's device; a bf16 or
    fp16 ``x`` is upcast to float32 (what ``jnp.dot(bf16, fp32)`` does)."""
    if x.device.type == "cpu":
        return pattern_spmm_plain(x, w_comp, block_ids, nnz, block)
    if x.device.type != "cuda":
        raise ValueError(f"pattern_spmm_cuda: unsupported device {x.device}")
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    _check("x", x, torch.float32, x.shape, x.device)
    *ops, geom = _operands(x, w_comp, block_ids, nnz, block, torch.float32)
    y = torch.empty((geom.m, geom.t * geom.tile), dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    _launch(load_library().pattern_spmm_f32, ops, y, geom, x.device)
    pattern_spmm_cuda.launches += 1
    return y


pattern_spmm_cuda.launches = 0


def pattern_spmm_quant_cuda(
    xq, w_comp, block_ids, w_scales, nnz, block: int
) -> torch.Tensor:
    """int8 block-pattern spmm: xq int8 [M, K], int8 bricks with per-brick
    float32 ``w_scales`` [T, k_max] -> float32 [M, T*tile] in reordered
    columns, dequantized on the weight side only (the caller multiplies
    the per-row activation scale)."""
    if xq.device.type == "cpu":
        return pattern_spmm_quant_plain(
            xq, w_comp, block_ids, w_scales, nnz, block
        )
    if xq.device.type != "cuda":
        raise ValueError(f"pattern_spmm_quant_cuda: unsupported device {xq.device}")
    _check("xq", xq, torch.int8, xq.shape, xq.device)
    x, w, ids, n, geom = _operands(xq, w_comp, block_ids, nnz, block, torch.int8)
    _check("w_scales", w_scales, torch.float32, ids.shape, xq.device)
    y = torch.empty((geom.m, geom.t * geom.tile), dtype=torch.float32,
                    device=xq.device)
    if y.numel() == 0:
        return y
    _launch(load_library().pattern_spmm_i8, (x, w, ids, w_scales.contiguous(), n),
            y, geom, xq.device)
    pattern_spmm_quant_cuda.launches += 1
    return y


pattern_spmm_quant_cuda.launches = 0
