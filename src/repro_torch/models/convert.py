"""The reference's language-model parameters as the port's.

``lm_params_from_numpy`` takes the reference's parameter pytree (from
``repro.models.transformer.init_params``) with every leaf turned into a
numpy array — ``jax.tree.map(np.asarray, params)`` — and returns the same
tree of torch tensors on ``device``, dtypes kept, including the stacked
``body`` whose leading axis is the period index.  The statics are not
converted: :func:`repro_torch.models.transformer.init_statics` rebuilds
them (layer kinds, attention configs, sparse layouts) with the port's
own copy of the reference's numpy, so they equal the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["lm_params_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def lm_params_from_numpy(params, device=None):
    """The reference's param tree (numpy leaves) as torch tensors on
    ``device`` (``None``: ``cuda``, raising without one)."""
    device = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return _tensor(tree, device)

    return conv(params)
