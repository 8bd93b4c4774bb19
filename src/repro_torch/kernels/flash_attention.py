"""Flash-Attention-2 forward for Hopper, with its plain version.

    o[b, h] = softmax(scale * q[b, h] k[b, h // group]^T + mask) v[b, h // group]

    mask: keys at positions >= kv_len, after the query (causal) or at or
    before query - window (sliding window) score -inf; a query row that
    sees no key at all is 0.

``flash_attention_cuda`` replaces ``flash_attention_pallas`` in
``src/repro/kernels/flash_attention.py``.  The CUDA C++ is in
``csrc/flash_attention.cu``, built with ``nvcc`` for ``sm_90a`` at first
use (``_build.py``) and called through ctypes on PyTorch's current stream.
It is bound by operations at the generation path's prefill shapes; key
tiles above the causal diagonal, below the window or past ``kv_len`` are
never read.  It has two routes, picked by the input type and never on a
failure:

- bf16 and fp16 inputs: the tensor-core kernel.  Q K^T and P V run as
  ``mma.sync`` products with fp32 accumulators; K and V stay 16-bit in
  shared memory, double-buffered with ``cp.async``; P is split into two
  16-bit terms so P V keeps the reference's fp32 P to 2^-16 of each p
  (bf16's unit roundoff squared).  It
  takes D a multiple of 8, sequence, head and batch strides that are
  multiples of 8 elements and 16-byte aligned tensors, and raises on
  anything else.
- fp32 inputs: the SIMT kernel on the CUDA cores (fp32's 2e-5 tolerance
  cannot be met through 16-bit tensor-core inputs).

The kernel folds GQA itself (query head ``h`` reads key head
``h // group``) and addresses every tensor through its strides with a
unit stride along D, so it reads a ``[B, S, H, D]`` cache through a
transposed view and writes its output into ``[B, Sq, Hq, D]`` memory: the
returned ``[B, Hq, Sq, D]`` tensor is that memory's transposed view, and
``transpose(1, 2).reshape(B, Sq, Hq * D)`` of it copies nothing.

Beside the kernel is its plain PyTorch version (the oracle's meaning,
:func:`repro_torch.kernels.ref.flash_attention_ref`) and plain-integer
launch counters that grow by one per kernel launch and nowhere else:
``flash_attention_cuda.launches`` counts both routes,
``.launches_tensor_core`` and ``.launches_simt`` each one.  The wrapper
takes its plain version only for a tensor on the CPU; for a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import load_library
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["MAX_HEAD_DIM", "flash_attention_cuda", "flash_attention_plain"]

MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_ROWS = 65535  # CUDA's limit on gridDim.y, which counts B * Hq


def _validate(q, k, v, window, kv_len) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            "flash_attention: expected q [B, Hq, Sq, D] and k, v "
            f"[B, Hkv, Sk, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}"
        )
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(
            f"flash_attention: {hq} query heads are not a multiple of "
            f"{k.shape[1]} key heads"
        )
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            "flash_attention: q, k and v must share one of float32, "
            f"bfloat16, float16; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q on {q.device}, k on {k.device}, v on "
            f"{v.device}"
        )
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if kv_len is not None and kv_len < 0:
        raise ValueError(f"flash_attention: kv_len {kv_len} must be >= 0")


def _check_tensor_core(q, k, v) -> None:
    """The tensor-core route copies 16-byte chunks (8 elements): D, the
    batch, head and sequence strides and every base address must be
    multiples of them."""
    d = q.shape[-1]
    if d % 8:
        raise ValueError(
            f"flash_attention_cuda: the 16-bit route takes a head dimension "
            f"that is a multiple of 8, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if any(s % 8 for s in strides) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention_cuda: the 16-bit route needs {name}'s "
                f"batch, head and sequence strides in multiples of 8 "
                f"elements and a 16-byte aligned base; got strides "
                f"{t.stride()} at address {t.data_ptr():#x}")


def flash_attention_plain(q, k, v, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None,
                          kv_len: int | None = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention_cuda`: [B, Hq, Sq, D] in
    q's dtype, computed by the oracle on the folded heads (float32 scores
    and sums, no repeated key heads)."""
    _validate(q, k, v, window, kv_len)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = flash_attention_ref(
        q.reshape(b * hq, sq, d), k.reshape(b * hkv, sk, d),
        v.reshape(b * hkv, sk, d), scale=scale, causal=causal, window=window,
        kv_len=kv_len,
    )
    return out.reshape(b, hq, sq, d)


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_cuda(q, k, v, causal: bool = True,
                         window: int | None = None,
                         scale: float | None = None,
                         kv_len: int | None = None) -> torch.Tensor:
    """FA-2 forward: q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D] (Hq a
    multiple of Hkv, D <= 128, any strides) -> [B, Hq, Sq, D] in q's
    dtype.  Query positions start at 0; ``kv_len`` (default Sk) masks the
    keys at and after it; ``scale`` defaults to D ** -0.5."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, scale, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda: unsupported device {q.device}")
    _validate(q, k, v, window, kv_len)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention_cuda: head dimension {d} > {MAX_HEAD_DIM}")
    if b * hq > _MAX_HEAD_ROWS:
        raise ValueError(
            f"flash_attention_cuda: {b * hq} head rows exceed the grid "
            f"limit {_MAX_HEAD_ROWS}")
    q, k, v = _unit_last(q), _unit_last(k), _unit_last(v)
    tensor_core = q.dtype != torch.float32
    if tensor_core:
        _check_tensor_core(q, k, v)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    scale = float(scale) if scale is not None else d ** -0.5
    kv = sk if kv_len is None else min(int(kv_len), sk)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load_library()
    fn = lib.flash_attention_fwd_mma if tensor_core else lib.flash_attention_fwd
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, hq, hkv, sq, sk, d, *strides, scale,
        int(causal), int(window or 0), kv, q.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    if tensor_core:
        flash_attention_cuda.launches_tensor_core += 1
    else:
        flash_attention_cuda.launches_simt += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tensor_core = 0
flash_attention_cuda.launches_simt = 0
