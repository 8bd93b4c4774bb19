"""The kernel wrappers' refusal of inputs that require grad.

The CUDA kernels are forward only, launched through ``ctypes`` outside
autograd, as the reference's Pallas kernels have no backward either (it
trains through XLA).  A wrapper given an input that requires grad would
return an output cut off from the graph, so it raises instead, on every
device: training runs on the plain routes, which
``models.transformer.apply_model(..., kernels=False)`` selects.
"""

from __future__ import annotations

import torch

__all__ = ["refuse_grad"]


def refuse_grad(name: str, **inputs) -> None:
    """Raise ``ValueError`` if any tensor of ``inputs`` requires grad."""
    bad = [k for k, t in inputs.items()
           if isinstance(t, torch.Tensor) and t.requires_grad]
    if bad:
        raise ValueError(
            f"{name}: {', '.join(bad)} require(s) grad, and the kernel has "
            f"no backward; train on the plain routes "
            f"(apply_model(..., kernels=False))")
