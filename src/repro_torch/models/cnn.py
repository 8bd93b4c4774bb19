"""CNNs in PyTorch: the paper's (modified) VGG16 and a miniature CNN.

Port of ``repro/models/cnn.py``.  VGG16 keeps all 13 conv layers and a
single FC layer (the paper's §V-A).  Params are plain dicts of tensors
``{convN: {w, b}, fc: {w, b}}``; conv weights use layout
``[C_out, C_in, Kh, Kw]`` and the FC weight ``[d_in, d_out]``, as in the
reference.  ``cnn_apply`` is the dense forward the compiled engine is
held against.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.synthetic import VGG16_CONV_CHANNELS

__all__ = [
    "CNNConfig",
    "vgg16_config",
    "mini_cnn_config",
    "init_cnn",
    "params_from_numpy",
    "cnn_apply",
    "channel_norm",
    "max_pool_2x2",
    "conv_weight_names",
]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    conv_channels: tuple[tuple[int, int], ...]  # (c_in, c_out) per conv
    pool_after: frozenset[int]  # 1-based conv indices followed by 2x2 maxpool
    num_classes: int
    input_hw: int
    kernel: int = 3

    @property
    def num_convs(self) -> int:
        return len(self.conv_channels)


def vgg16_config(num_classes: int = 10, input_hw: int = 32) -> CNNConfig:
    return CNNConfig(
        conv_channels=tuple(VGG16_CONV_CHANNELS),
        pool_after=frozenset({2, 4, 7, 10, 13}),
        num_classes=num_classes,
        input_hw=input_hw,
    )


def mini_cnn_config(
    num_classes: int = 4, input_hw: int = 12, widths: Sequence[int] = (8, 16, 16)
) -> CNNConfig:
    chans, c = [], 1
    for w in widths:
        chans.append((c, w))
        c = w
    return CNNConfig(
        conv_channels=tuple(chans),
        pool_after=frozenset({len(widths) - 1}),
        num_classes=num_classes,
        input_hw=input_hw,
    )


def init_cnn(
    cfg: CNNConfig,
    generator: torch.Generator,
    device: str | torch.device = "cpu",
) -> dict:
    """He-normal conv weights, zero biases, drawn from ``generator``."""
    params: dict = {}
    k = cfg.kernel
    for i, (ci, co) in enumerate(cfg.conv_channels, start=1):
        fan_in = ci * k * k
        w = torch.randn((co, ci, k, k), generator=generator)
        params[f"conv{i}"] = {
            "w": (w * float(np.sqrt(2.0 / fan_in))).to(device),
            "b": torch.zeros(co, device=device),
        }
    feat = cfg.conv_channels[-1][1]  # global average pool
    w = torch.randn((feat, cfg.num_classes), generator=generator)
    params["fc"] = {
        "w": (w * float(np.sqrt(1.0 / feat))).to(device),
        "b": torch.zeros(cfg.num_classes, device=device),
    }
    return params


def params_from_numpy(params: dict, device: str | torch.device = "cpu") -> dict:
    """``{name: {w, b}}`` of arrays -> the same dict of float32 tensors.

    The bridge that feeds one set of parameters (e.g. the reference's
    pytree converted to numpy) to both packages.
    """
    return {
        name: {
            key: torch.tensor(np.asarray(val, np.float32), device=device)
            for key, val in layer.items()
        }
        for name, layer in params.items()
    }


def channel_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel scale normalisation (BN stand-in, stateless).

    x: [B, C, H, W].  Reduces over the spatial axes only, with the
    population std (``correction=0``, as ``jnp.std``), so a sample's
    activations never depend on which other samples share the batch; an
    all-zero dead row normalises against its own statistics.
    """
    return x / (torch.std(x, dim=(2, 3), correction=0, keepdim=True) + eps)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool.  x: [B, C, H, W]."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def cnn_apply(cfg: CNNConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense forward pass -> logits [B, num_classes].  x: [B, C, H, W]."""
    for i in range(1, cfg.num_convs + 1):
        p = params[f"conv{i}"]
        x = F.conv2d(x, p["w"], padding=p["w"].shape[-1] // 2)
        x = x + p["b"][None, :, None, None]
        x = torch.relu(channel_norm(x))
        if i in cfg.pool_after:
            x = max_pool_2x2(x)
    x = x.mean(dim=(2, 3))  # global average pool
    return x @ params["fc"]["w"] + params["fc"]["b"]


def conv_weight_names(cfg: CNNConfig) -> list[str]:
    return [f"conv{i}" for i in range(1, cfg.num_convs + 1)]
