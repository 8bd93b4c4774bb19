"""The kernel wrappers' refusal of inputs that require grad, and of fake
tensors.

The CUDA kernels are forward only, launched through ``ctypes`` outside
autograd, as the reference's Pallas kernels have no backward either (it
trains through XLA).  A wrapper given an input that requires grad would
return an output cut off from the graph, so it raises instead, on every
device: training runs on the plain routes, which
``models.transformer.apply_model(..., kernels=False)`` selects.

A fake tensor (``torch._subclasses.fake_tensor``, the dry run's
stand-ins) has no storage a kernel could read, and on the CPU it would
quietly take the plain version in the kernel's place; so a wrapper
given one raises too, and the dry run asks for the plain routes by
argument (``launch.steps.build_step``).
"""

from __future__ import annotations

import torch

__all__ = ["refuse_grad"]


def refuse_grad(name: str, **inputs) -> None:
    """Raise ``ValueError`` if any tensor of ``inputs`` requires grad or
    is a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    fake = [k for k, t in inputs.items() if isinstance(t, FakeTensor)]
    if fake:
        raise ValueError(
            f"{name}: {', '.join(fake)} is/are fake tensor(s), which no "
            f"kernel can read; take the plain routes by argument "
            f"(apply_model(..., kernels=False))")
    bad = [k for k, t in inputs.items()
           if isinstance(t, torch.Tensor) and t.requires_grad]
    if bad:
        raise ValueError(
            f"{name}: {', '.join(bad)} require(s) grad, and the kernel has "
            f"no backward; train on the plain routes "
            f"(apply_model(..., kernels=False))")
