"""Int8 quantization of compressed weights onto the paper's 4-bit cells.

Port of ``repro/core/quantize.py``.  Weights are stored as per-brick
symmetric int8: in the compressed layout a row-group is one stored
``[block, tile]`` brick, and each brick gets one float32 scale
(``w_scales[t, k] = max|brick| / 127``), so ``w ≈ w_scales[t, k] * q``
with ``|w - s*q| <= s/2`` elementwise.  An int8 weight occupies
``ceil(8 / cell_bits)`` cells (:func:`n_cell_slices`).

Activations are quantized dynamically per row (one scale per im2col
window) right before the spmm (:func:`quantize_rows`); the row scale
multiplies once in the spmm's output epilogue.  The weight-side helpers
are host numpy, copied from the reference so the stored arrays are
bit-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sparse import BlockPatternWeight

__all__ = [
    "WEIGHT_BITS",
    "QMAX",
    "n_cell_slices",
    "group_scales",
    "quantize_groups",
    "dequantize_groups",
    "quantize_bp",
    "dequantize_bp",
    "quantize_rows",
]

WEIGHT_BITS = 8  # stored weight precision (symmetric int8)
QMAX = 2 ** (WEIGHT_BITS - 1) - 1  # 127


def n_cell_slices(cell_bits: int = 4, weight_bits: int = WEIGHT_BITS) -> int:
    """Cells per stored weight: ``ceil(weight_bits / cell_bits)``."""
    if cell_bits < 1:
        raise ValueError(f"cell_bits must be >= 1, got {cell_bits}")
    return -(-weight_bits // cell_bits)


def group_scales(w: np.ndarray, group_ndim: int = 2) -> np.ndarray:
    """Symmetric scale per group: ``max|group| / QMAX``.

    The trailing ``group_ndim`` axes form one group.  All-zero groups get
    scale 0.0 (their quantized weights are 0 and dequantize exactly).
    """
    w = np.asarray(w, np.float32)
    axes = tuple(range(w.ndim - group_ndim, w.ndim))
    return (np.abs(w).max(axis=axes) / QMAX).astype(np.float32)


def quantize_groups(
    w: np.ndarray, scales: np.ndarray, group_ndim: int = 2
) -> np.ndarray:
    """Round-to-nearest symmetric int8 of ``w`` under per-group ``scales``."""
    w = np.asarray(w, np.float32)
    s = np.asarray(scales, np.float32).reshape(scales.shape + (1,) * group_ndim)
    inv = np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)
    q = np.rint(w * inv)
    return np.clip(q, -QMAX, QMAX).astype(np.int8)


def dequantize_groups(
    q: np.ndarray, scales: np.ndarray, group_ndim: int = 2
) -> np.ndarray:
    s = np.asarray(scales, np.float32).reshape(scales.shape + (1,) * group_ndim)
    return (np.asarray(q, np.float32) * s).astype(np.float32)


def quantize_bp(bp: BlockPatternWeight) -> BlockPatternWeight:
    """Quantize a compressed weight to int8 bricks + per-brick scales.

    Returns a new :class:`BlockPatternWeight` whose ``w_comp`` is int8
    ``[T, k_max, block, tile]`` and whose ``w_scales`` is float32
    ``[T, k_max]``, on the same device.  Padded brick slots are all-zero,
    so their scale is 0 and they stay numerically inert.
    """
    if bp.w_scales is not None:
        return bp
    wc = bp.w_comp.cpu().numpy().astype(np.float32)
    scales = group_scales(wc, group_ndim=2)  # [T, k_max]
    q = quantize_groups(wc, scales, group_ndim=2)
    return dataclasses.replace(
        bp,
        w_comp=torch.from_numpy(q).to(bp.device),
        w_scales=torch.from_numpy(scales).to(bp.device),
    )


def dequantize_bp(bp: BlockPatternWeight) -> BlockPatternWeight:
    """Inverse of :func:`quantize_bp` (up to the quantization error)."""
    if bp.w_scales is None:
        return bp
    wc = dequantize_groups(
        bp.w_comp.cpu().numpy(), bp.w_scales.cpu().numpy(), group_ndim=2
    )
    return dataclasses.replace(
        bp, w_comp=torch.from_numpy(wc).to(bp.device), w_scales=None
    )


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 of activations.

    x: [M, K] float; returns (q int8 [M, K], scales float32 [M]).  The op
    order is the reference's, so the results are bit-equal to it: amax,
    ``amax / QMAX``, ``where(amax > 0, QMAX / amax, 0)``, ``x * inv``,
    round half to even (``torch.round`` = ``jnp.round``), clip, int8.
    All-zero rows get scale 0 and quantize to exact zeros.
    """
    amax = x.abs().amax(dim=-1)
    scale = (amax / QMAX).float()
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    inv = torch.where(amax > 0, QMAX / safe, torch.zeros_like(amax))
    q = torch.clamp(torch.round(x * inv[:, None]), -QMAX, QMAX)
    return q.to(torch.int8), scale
