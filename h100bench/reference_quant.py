"""The plain quantized reference: ``reference.py``'s forward with each
spmm's operands quantized, in plain PyTorch and float64.

It imports torch alone and reads only what the benchmark made itself
(the seeded weights and images).  The layer equations are
``reference.py``'s: per conv a 3x3 'same' convolution, plus bias, the
per-sample, per-channel scale normalisation ``x / (std_hw(x) + 1e-5)``
(population std), ReLU, a 2x2 max pool where the configuration says;
then a global average pool and the FC.  With ``bits`` given, each conv
and the FC multiply quantized operands, the scheme the program's
``core/quantize`` describes at ``bits`` bits:

  * the input rows, per row (a conv's im2col window of ``C_in * 9``
    values, the FC's feature vector): symmetric, scale ``max|row| /
    qmax`` with ``qmax = 2**(bits - 1) - 1``, round half to even, clip
    to ``+-qmax`` (``quantize_rows``; an all-zero row stays zero);
  * the weights, symmetric per output channel (a conv filter's
    ``C_in * 9`` values, an FC column), scale ``max|w| / qmax``, round
    half to even.

One departure from the program: it quantizes each stored ``[block,
tile]`` brick of the compressed weight with its own scale, and a brick's
rows follow the kernel-reordering permutation, so its groups are not a
layer's output channels; a plain forward over the dense weights cannot
form them.  Per output channel is the nearest grouping a dense forward
has.  Both give each weight at most half a step of error, a step being
its group's largest magnitude over ``qmax``.

``bits=8`` is what a correct int8 program reads against the float64
unquantized reference (``reference.logits``); ``bits=4`` is the control,
the step below int8, which a limit on ``max_logit_err`` has to refuse.
``bits=None`` is the unquantized forward through the same im2col and
matrix products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5

__all__ = ["quantize_rows", "quantize_out_channels", "forward", "logits"]


def _qmax(bits: int) -> int:
    if bits < 2:
        raise ValueError(f"bits must be >= 2, got {bits}")
    return 2 ** (bits - 1) - 1


def quantize_rows(x: torch.Tensor, bits: int | None) -> torch.Tensor:
    """``x [..., K]`` with each row over its last axis quantized
    symmetrically to ``bits`` and dequantized again (``None``: ``x``)."""
    if bits is None:
        return x
    qmax = _qmax(bits)
    amax = x.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    q = torch.clamp(torch.round(x * (qmax / safe)), -qmax, qmax)
    return q * (amax / qmax)


def quantize_out_channels(w: torch.Tensor, bits: int | None,
                          axis: int) -> torch.Tensor:
    """``w`` quantized symmetrically to ``bits`` with one scale per index
    of ``axis`` (the output channel) and dequantized again."""
    if bits is None:
        return w
    moved = w.movedim(axis, -1)
    flat = quantize_rows(moved.reshape(-1, moved.shape[-1]).T, bits).T
    return flat.reshape(moved.shape).movedim(-1, axis)


def _conv(x: torch.Tensor, w: torch.Tensor, bits: int | None,
          wbits: int | None):
    """A 'same' convolution as im2col rows times the filter matrix, the
    rows quantized per window to ``bits``, the filters to ``wbits``."""
    b, _, h, wd = x.shape
    c_out, _, k, _ = w.shape
    rows = F.unfold(x, k, padding=k // 2).transpose(1, 2)  # [B, H*W, C*k*k]
    wm = quantize_out_channels(w, wbits, 0).reshape(c_out, -1)
    y = quantize_rows(rows, bits) @ wm.T  # [B, H*W, C_out]
    return y.transpose(1, 2).reshape(b, c_out, h, wd)


def forward(config: dict, params: dict, x: torch.Tensor,
            bits: int | None, weights: bool = True) -> torch.Tensor:
    """Logits ``[B, classes]`` of images ``x [B, C, H, W]`` in ``x``'s
    dtype; ``params`` ``{convN: {w, b}, fc: {w, b}}`` in the same dtype.
    ``weights=False`` takes the weights as given (already quantized, say)
    and quantizes the input rows alone."""
    wbits = bits if weights else None
    pool_after = set(config["pool_after"])
    for i in range(1, len(config["conv_channels"]) + 1):
        p = params[f"conv{i}"]
        x = _conv(x, p["w"], bits, wbits) + p["b"][None, :, None, None]
        x = x / (torch.std(x, dim=(2, 3), correction=0, keepdim=True) + EPS)
        x = torch.relu(x)
        if i in pool_after:
            x = F.max_pool2d(x, kernel_size=2, stride=2)
    x = x.mean(dim=(2, 3))
    w = quantize_out_channels(params["fc"]["w"], wbits, 1)
    return quantize_rows(x, bits) @ w + params["fc"]["b"]


def logits(config: dict, params: dict, images: torch.Tensor,
           bits: int | None, block: int = 8) -> torch.Tensor:
    """Float64 logits ``[N, classes]`` (on the CPU) of ``images``
    (float32 ``[N, C, H, W]`` on the weights' device), ``block`` images
    at a time, each spmm's operands quantized to ``bits``."""
    p = {k: {n: t.double() for n, t in v.items()} for k, v in params.items()}
    out = []
    with torch.no_grad():
        for s in range(0, images.shape[0], block):
            xb = images[s:s + block].double()
            out.append(forward(config, p, xb, bits).cpu())
    return torch.cat(out)
