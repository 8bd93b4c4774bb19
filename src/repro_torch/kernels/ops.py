"""Dispatch for the port's ops through the Hopper kernels' wrappers.

Every op calls the wrappers in ``kernels/pattern_spmm.py``,
``kernels/ou_mvm.py`` and ``kernels/flash_attention.py``, which pick
by the tensor's device: on a CUDA tensor they launch their kernel or
raise, on a CPU tensor they run their plain PyTorch version.  There is
no second route: :func:`default_backend` only names the one a tensor
takes.  Unlike the reference there is no row-tile argument: the CUDA
kernel picks its own tiles and masks the ragged edge, so nothing is
padded to a TPU sublane minimum here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import quantize_rows
from repro_torch.core.sparse import BlockPatternWeight
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ou_mvm import ou_mvm_cuda
from repro_torch.kernels.pattern_spmm import (
    pattern_spmm_cuda,
    pattern_spmm_quant_cuda,
)

__all__ = ["default_backend", "flash_attention", "ou_mvm", "pattern_spmm",
           "pattern_spmm_quant_rows", "pattern_spmm_raw"]


def default_backend(x: torch.Tensor) -> str:
    """The route the wrappers take for ``x``: ``'cuda'`` (the kernel) for
    a CUDA tensor, ``'torch'`` (the plain version) otherwise."""
    return "cuda" if x.is_cuda else "torch"


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    axis = axis % x.dim()
    # F.pad lists (before, after) pairs from the last axis backwards
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def pattern_spmm_raw(
    xm: torch.Tensor,
    w_comp: torch.Tensor,
    block_ids: torch.Tensor,
    block: int,
    w_scales: torch.Tensor | None = None,
    nnz: torch.Tensor | None = None,
    w_kmajor: torch.Tensor | None = None,
) -> torch.Tensor:
    """Compressed spmm in *reordered* column order (no inverse permutation).

    xm: [M, K]; returns float32 [M, T*tile].  With ``w_scales`` (int8
    ``w_comp`` + per-brick scales) the activations are quantized per row
    (:func:`~repro_torch.core.quantize.quantize_rows`), the int8 variant
    runs, and the row scale multiplies in the epilogue here.  The CUDA
    kernels need ``nnz`` as an int32 tensor on the device; the plain
    versions walk every slot and do not read it.  ``w_kmajor`` is the
    int8 bricks' K-major copy (``kernels.pattern_spmm.kmajor_bricks``),
    made per call by the int8 kernel's wrapper when not given.
    """
    if nnz is None and default_backend(xm) == "cuda":
        raise ValueError("the CUDA kernels need nnz as a device tensor")
    if w_scales is None:
        return pattern_spmm_cuda(xm, w_comp, block_ids, nnz, block)
    xq, x_scale = quantize_rows(xm)
    return pattern_spmm_quant_rows(xq, x_scale, w_comp, block_ids, w_scales,
                                   nnz, block, w_kmajor=w_kmajor)


def pattern_spmm_quant_rows(
    xq: torch.Tensor,
    x_scale: torch.Tensor,
    w_comp: torch.Tensor,
    block_ids: torch.Tensor,
    w_scales: torch.Tensor,
    nnz: torch.Tensor | None,
    block: int,
    w_kmajor: torch.Tensor | None = None,
) -> torch.Tensor:
    """The int8 half of :func:`pattern_spmm_raw`: the int8 kernel over
    rows that :func:`~repro_torch.core.quantize.quantize_rows` (or the
    patch kernel ``conv_patches_q8_cuda``, bit for bit the same) made
    (``xq`` int8 [M, K], ``x_scale`` float32 [M]), times the row scale.
    Returns float32 [M, T*tile] in reordered column order."""
    y = pattern_spmm_quant_cuda(xq, w_comp, block_ids, w_scales, nnz, block,
                                w_kmajor=w_kmajor)
    return y * x_scale[:, None]


def pattern_spmm(
    x: torch.Tensor,
    bp: BlockPatternWeight,
    nnz: torch.Tensor | None = None,
    inv_order: torch.Tensor | None = None,
    w_kmajor: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = x @ W for a block-pattern compressed weight.  x: [..., K].

    Quantized weights (``bp.w_scales is not None``) dispatch the int8
    variant; the output dtype follows ``x`` either way.  ``nnz`` (int32)
    and ``inv_order`` (int64) are the device copies of the weight's
    numpy tables, and ``w_kmajor`` the int8 bricks' K-major copy; the
    executor makes them once per program, and they are made here (or by
    the kernel's wrapper) per call when not given.
    """
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    if nnz is None:
        nnz = torch.as_tensor(bp.nnz, dtype=torch.int32, device=x.device)
    if inv_order is None:
        inv_order = torch.as_tensor(bp.inv_order, dtype=torch.int64,
                                    device=x.device)
    y = pattern_spmm_raw(
        xm, bp.w_comp, bp.block_ids, bp.block, w_scales=bp.w_scales, nnz=nnz,
        w_kmajor=w_kmajor,
    )
    y = y.index_select(1, inv_order)  # the Output Indexing Unit
    return y.reshape(*lead, bp.n_out).to(x.dtype)


def ou_mvm(
    x: torch.Tensor, w: torch.Tensor, ou_rows: int = 9, ou_cols: int = 8
) -> torch.Tensor:
    """Paper-faithful OU-granular MVM with all-zero input skip.

    x [R], w [R, C], any float type -> float32 [C].  On a CUDA tensor it
    runs the CUDA kernel (or raises); on a CPU tensor its plain version.
    """
    return ou_mvm_cuda(x, w, ou_rows=ou_rows, ou_cols=ou_cols)


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    kv_len: int | None = None,
) -> torch.Tensor:
    """GQA flash attention.  Returns [B, Hq, Sq, D] in q's dtype.

    The kernel folds GQA itself (query head ``h`` reads key head
    ``h // (Hq / Hkv)``), so the key heads are never repeated, and it
    masks its own ragged tiles, so nothing is padded.  Query positions
    start at 0; ``kv_len`` (default Sk) masks the keys at and after it.
    """
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                scale=scale, kv_len=kv_len)
