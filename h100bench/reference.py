"""The plain reference: a dense VGG-style forward in plain PyTorch.

It imports nothing of the program and reads only what the benchmark made
itself (the seeded weights and images).  The layer equations are those
the program serves: per conv a 3x3 'same' convolution with the pruned
dense weights, plus bias, the per-sample, per-channel scale
normalisation ``x / (std_hw(x) + 1e-5)`` (population std), ReLU, a 2x2
max pool where the configuration says; then a global average pool and
the FC.

:func:`logits` computes it in float64, blocks of images at a time, so
the program's float32 rounding is what a comparison with it reads.
:func:`logits` with ``tf32=True`` is the control: the same forward in
float32 with every convolution's and the FC's operands rounded to TF32
(10 explicit mantissa bits, round to nearest, ties away), which is what
the card's TF32 tensor cores compute from; it is the step below float32
that a later change would be tempted to take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5

__all__ = ["forward", "logits", "round_tf32"]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32's 10 mantissa bits (ties away from
    zero), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def forward(config: dict, params: dict, x: torch.Tensor,
            tf32: bool = False) -> torch.Tensor:
    """Logits ``[B, classes]`` of images ``x [B, C, H, W]`` in ``x``'s
    dtype; ``params`` ``{convN: {w, b}, fc: {w, b}}`` in the same dtype."""
    rnd = round_tf32 if tf32 else (lambda t: t)
    pool_after = set(config["pool_after"])
    for i in range(1, len(config["conv_channels"]) + 1):
        p = params[f"conv{i}"]
        x = F.conv2d(rnd(x), rnd(p["w"]), padding=p["w"].shape[-1] // 2)
        x = x + p["b"][None, :, None, None]
        x = x / (torch.std(x, dim=(2, 3), correction=0, keepdim=True) + EPS)
        x = torch.relu(x)
        if i in pool_after:
            x = F.max_pool2d(x, kernel_size=2, stride=2)
    x = x.mean(dim=(2, 3))
    return rnd(x) @ rnd(params["fc"]["w"]) + params["fc"]["b"]


def logits(config: dict, params: dict, images: torch.Tensor,
           block: int = 16, tf32: bool = False) -> torch.Tensor:
    """Reference logits of ``images`` (float32 ``[N, C, H, W]`` on the
    device the weights are on), ``block`` images at a time: float64, or
    the TF32 control in float32.  Returns float64 ``[N, classes]``.

    TF32 is switched off in the library for the call (the float64 path
    cannot take it; the control rounds its operands itself), and the
    previous settings are restored."""
    dtype = torch.float32 if tf32 else torch.float64
    p = {k: {n: t.to(dtype) for n, t in v.items()} for k, v in params.items()}
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        with torch.no_grad():
            for s in range(0, images.shape[0], block):
                xb = images[s:s + block].to(dtype)
                out.append(forward(config, p, xb, tf32=tf32).double().cpu())
        return torch.cat(out)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
