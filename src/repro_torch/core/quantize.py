"""Int8 quantization of compressed weights onto the paper's 4-bit cells.

Port of ``repro/core/quantize.py``.  Weights are stored as per-brick
symmetric int8: in the compressed layout a row-group is one stored
``[block, tile]`` brick, and each brick gets one float32 scale
(``w_scales[t, k] = max|brick| / 127``), so ``w ≈ w_scales[t, k] * q``
with ``|w - s*q| <= s/2`` elementwise.  An int8 weight occupies
``ceil(8 / cell_bits)`` cells (:func:`n_cell_slices`).

Activations are quantized dynamically per row (one scale per im2col
window) right before the spmm (:func:`quantize_rows`); the row scale
multiplies once in the spmm's output epilogue.  The executor's int8 convs
get the same rows and scales, bit for bit, from the patch kernel itself
(``kernels.patches.conv_patches_q8_cuda``), which never writes the float
rows; :func:`quantize_rows` quantizes the FC's rows.  The weight-side
helpers are host numpy, copied from the reference so the stored arrays
are bit-equal.
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
    "cells_for_magnitude",
    "cell_slices",
    "compose_cell_slices",
]

WEIGHT_BITS = 8  # stored weight precision (symmetric int8)
QMAX = 2 ** (WEIGHT_BITS - 1) - 1  # 127


def n_cell_slices(cell_bits: int = 4, weight_bits: int = WEIGHT_BITS) -> int:
    """Cells per stored weight: ``ceil(weight_bits / cell_bits)``."""
    if cell_bits < 1:
        raise ValueError(f"cell_bits must be >= 1, got {cell_bits}")
    return -(-weight_bits // cell_bits)


def cells_for_magnitude(
    mag, cell_bits: int = 4, weight_bits: int = WEIGHT_BITS
) -> np.ndarray:
    """Minimum cell slices needed to store magnitudes exactly.

    ``mag``: non-negative integer magnitudes (scalar or array), the
    largest |q| a row-group holds in some integer grid.  A magnitude of
    ``m`` needs ``bit_length(m)`` magnitude bits plus the sign bit of
    the sign-magnitude cell layout (:func:`cell_slices`), so
    ``ceil((bit_length(m) + 1) / cell_bits)`` cells; all-zero groups
    need none.  The result never exceeds :func:`n_cell_slices` for
    magnitudes within the ``weight_bits`` budget — this is the
    range→cell-count map the certification pass
    (``analysis/ranges.py`` in the reference) tabulates per OU row-group.
    """
    if cell_bits < 1:
        raise ValueError(f"cell_bits must be >= 1, got {cell_bits}")
    m = np.asarray(mag, np.int64)
    if m.size and m.min() < 0:
        raise ValueError("magnitudes must be non-negative")
    if m.size and m.max() >= (1 << (weight_bits - 1)):
        raise ValueError(
            f"magnitude {int(m.max())} exceeds the {weight_bits}-bit "
            "signed weight budget"
        )
    # bit_length(m) for integer m > 0 is exactly frexp's binary exponent
    bits = np.frexp(m.astype(np.float64))[1].astype(np.int64)
    cells = -(-(bits + 1) // cell_bits)
    return np.where(m > 0, cells, 0)


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


def cell_slices(q: np.ndarray, cell_bits: int = 4) -> np.ndarray:
    """Decompose int8 weights into unsigned cell slices, sign-magnitude.

    q: int8 array; returns uint8 ``[..., n_cell_slices]``: little-endian
    ``cell_bits``-bit magnitude digits, with the sign bit stored in the
    top slice's most significant spare bit.  Lossless for |q| <= QMAX
    (which :func:`quantize_groups` guarantees).
    """
    q = np.asarray(q)
    if q.dtype != np.int8:
        raise ValueError(f"expected int8 weights, got {q.dtype}")
    n = n_cell_slices(cell_bits)
    mag = np.abs(q.astype(np.int16)).astype(np.uint16)
    out = np.empty(q.shape + (n,), np.uint8)
    for i in range(n):
        out[..., i] = (mag >> (i * cell_bits)) & ((1 << cell_bits) - 1)
    # sign in the top slice's spare bit (magnitude uses weight_bits-1 bits)
    sign_bit = (WEIGHT_BITS - 1) - (n - 1) * cell_bits
    out[..., n - 1] |= ((q < 0).astype(np.uint8)) << sign_bit
    return out


def compose_cell_slices(slices: np.ndarray, cell_bits: int = 4) -> np.ndarray:
    """Inverse of :func:`cell_slices`: slices -> int8 weights."""
    slices = np.asarray(slices, np.uint16)
    n = n_cell_slices(cell_bits)
    if slices.shape[-1] != n:
        raise ValueError(
            f"expected {n} slices of {cell_bits} bits, got {slices.shape[-1]}"
        )
    sign_bit = (WEIGHT_BITS - 1) - (n - 1) * cell_bits
    top = slices[..., n - 1]
    neg = (top >> sign_bit) & 1
    top = top & ((1 << sign_bit) - 1)
    mag = np.zeros(slices.shape[:-1], np.int16)
    for i in range(n - 1):
        mag |= slices[..., i].astype(np.int16) << (i * cell_bits)
    mag |= top.astype(np.int16) << ((n - 1) * cell_bits)
    return np.where(neg == 1, -mag, mag).astype(np.int8)
