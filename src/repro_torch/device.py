"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["host_array", "resolve_device"]


def host_array(a) -> np.ndarray:
    """A tensor (read off its device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when ``None`` is given and CUDA is unavailable: the port never
    drops to the CPU on its own, the caller asks for it by name.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
