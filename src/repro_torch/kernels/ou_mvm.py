"""OU-granular crossbar matrix-vector multiply for Hopper, with its plain
version (paper §IV-A).

    y = x @ W, walked in ou_rows x ou_cols Operation Units; a row band
    whose input slice is all zero (x[band] == 0) is skipped and reads no
    weights — the Input Preprocessing Unit's all-zero detection.

``ou_mvm_cuda`` replaces ``ou_mvm_pallas`` in
``src/repro/kernels/ou_mvm.py``.  The CUDA C++ is in ``csrc/ou_mvm.cu``,
built with ``nvcc`` for ``sm_90a`` at first use (``_build.py``) and
called through ctypes on PyTorch's current stream.  It is bound by bytes
(two operations per weight of a live band): a skipped band reads no
weights.  Each thread block owns a slab of 4 columns (one float4 a
weight row) and walks every row of it, so a call is one launch with no
reduction across blocks (at these sizes one costs as much as the walk);
the block sums its 512 row-lanes by a fixed tree, so a rerun gives the
same bits.  Each thread reads its 4 columns of a weight row as one
16-byte load where C and the alignment allow it (:func:`_ou_vec`, else
one column a block), 16 rows in flight.  x and its band flags pass
through shared memory 8192 rows at a time, so any R works.  The skip
is lossless — a zero band adds nothing — except that a skipped band's
weights never reach the output at all, so a non-finite weight there
does not turn the output into NaN as ``x @ w`` would.

Beside the kernel is its plain PyTorch version (the tests and the chip
smoke run compare against it) and a plain-integer launch counter,
``ou_mvm_cuda.launches``, that grows by one per kernel launch and
nowhere else.  The wrapper takes its plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import load_library
from repro_torch.kernels._grad_guard import refuse_grad

__all__ = ["OuPlan", "band_flags", "ou_mvm_cuda", "ou_mvm_plain"]

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_OU_THREADS = 512  # row-lanes a block (csrc/ou_mvm.cu's THREADS)
_OU_CHUNK = 512 * 16  # rows of x a block holds (csrc/ou_mvm.cu's CHUNK)


class OuPlan(NamedTuple):
    """How the kernel cuts one call: ``blocks`` slabs of ``cols``
    columns, one a block; each of a block's ``_OU_THREADS`` row-lanes
    walks ``rows_per_lane`` rows at most, in ``chunks`` passes of x
    through shared memory."""

    cols: int
    blocks: int
    rows_per_lane: int
    chunks: int


def _ou_plan(r: int, c: int, vec: int) -> OuPlan:
    """The kernel's plan for w [r, c], a thread reading ``vec`` columns,
    from these shapes alone (never from which bands are live)."""
    return OuPlan(vec, -(-c // vec), -(-r // _OU_THREADS),
                  -(-r // _OU_CHUNK))


def _ou_vec(w: torch.Tensor) -> int:
    """Columns a thread reads per load: 4 (one float4) when C % 4 == 0
    and w is 16-byte aligned, else 1."""
    return 4 if w.shape[1] % 4 == 0 and w.data_ptr() % 16 == 0 else 1


def band_flags(x: torch.Tensor, ou_rows: int) -> torch.Tensor:
    """bool [n_bands]: does row band b of ``x`` hold a nonzero?  The IEEE
    comparison, so -0.0 counts as zero and NaN as nonzero; the ragged
    last band is padded with zeros, as the reference pads it."""
    n_bands = -(-x.shape[0] // ou_rows)
    xb = F.pad(x, (0, n_bands * ou_rows - x.shape[0]))
    return (xb.view(n_bands, ou_rows) != 0).any(dim=1)


def _validate(x, w, ou_rows: int, ou_cols: int) -> None:
    if x.dim() != 1 or w.dim() != 2 or w.shape[0] != x.shape[0]:
        raise ValueError(
            f"ou_mvm: expected x [R] and w [R, C], got {tuple(x.shape)} "
            f"and {tuple(w.shape)}"
        )
    if x.dtype not in _FLOATS or w.dtype not in _FLOATS:
        raise ValueError(
            f"ou_mvm: float inputs only, got {x.dtype} and {w.dtype}"
        )
    if x.device != w.device:
        raise ValueError(f"ou_mvm: x on {x.device}, w on {w.device}")
    if ou_rows < 1 or ou_cols < 1:
        raise ValueError(f"ou_mvm: OU {ou_rows}x{ou_cols} must be positive")


def ou_mvm_plain(x: torch.Tensor, w: torch.Tensor, ou_rows: int = 9,
                 ou_cols: int = 8) -> torch.Tensor:
    """Plain version of :func:`ou_mvm_cuda`: float32 [C].

    The bands are reshaped, masked by their flags (a ``where``, so a
    skipped band's weights are never multiplied), and their partials
    summed in band order.  ``ou_cols`` groups columns only; it does not
    change any column's sum.
    """
    _validate(x, w, ou_rows, ou_cols)
    x, w = x.float(), w.float()
    r, c = w.shape
    flags = band_flags(x, ou_rows)
    n_bands = flags.shape[0]
    pad = n_bands * ou_rows - r
    xb = F.pad(x, (0, pad)).view(n_bands, ou_rows)
    wb = F.pad(w, (0, 0, 0, pad)).view(n_bands, ou_rows, c)
    wb = torch.where(flags[:, None, None], wb, torch.zeros((), device=w.device))
    partials = (xb[:, :, None] * wb).sum(dim=1)  # [n_bands, C]
    y = torch.zeros(c, dtype=torch.float32, device=w.device)
    for b in range(n_bands):
        y = y + partials[b]
    return y


def ou_mvm_cuda(x: torch.Tensor, w: torch.Tensor, ou_rows: int = 9,
                ou_cols: int = 8) -> torch.Tensor:
    """OU-walked MVM: x [R], w [R, C], any float type (upcast to float32)
    -> float32 [C], skipping all-zero input bands.  An input that requires
    grad raises, on any device: the kernel has no backward."""
    refuse_grad("ou_mvm_cuda", x=x, w=w)
    if x.device.type == "cpu":
        return ou_mvm_plain(x, w, ou_rows, ou_cols)
    if x.device.type != "cuda":
        raise ValueError(f"ou_mvm_cuda: unsupported device {x.device}")
    _validate(x, w, ou_rows, ou_cols)
    x = x.float().contiguous()
    w = w.float().contiguous()
    r, c = w.shape
    y = torch.empty(c, dtype=torch.float32, device=x.device)
    if c == 0:
        return y
    err = load_library().ou_mvm_f32(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), r, c, ou_rows, _ou_vec(w),
        x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ou_mvm_f32 launch failed: CUDA error {err}")
    ou_mvm_cuda.launches += 1
    return y


ou_mvm_cuda.launches = 0
