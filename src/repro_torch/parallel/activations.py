"""Activation sharding context (sequence parallelism between layers).

Port of ``repro/parallel/activations.py``.  The launcher installs a mesh
+ rules context; model code calls ``shard_activation(x, spec)`` where the
residual stream enters the layers, and ``models/attention.py`` reads
:func:`current_mesh` to take the sharded flash-decode route.

The reference's ``with_sharding_constraint`` asks its compiler to keep
the stream split as ``("batch", "seq_shard", None)``, ``seq_shard`` over
``model``.  The port computes on that split explicitly in the sharded
train step only: inside ``parallel.tensor.tensor_parallel_ctx`` with
``n > 1`` model ranks and ``n`` dividing the sequence,
:func:`shard_activation` returns this rank's slab of positions
``[r S / n, (r + 1) S / n)`` (its gradient all-gathered, so what computed
the whole stream gets its whole gradient on every rank), and the layers
take and return that slab (``models.transformer._apply_layer_tp``).
Where ``n`` does not divide the sequence (whisper's 1500 frames over 16)
the stream stays whole, as ``logical_to_pspec`` keeps a dimension that
does not divide.  Outside that context, the serving paths' included, it
returns ``x``: the batch rows a rank serves are its own already.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.parallel import tensor
from repro_torch.parallel.sharding import AxisRules, DEFAULT_RULES

__all__ = ["activation_sharding_ctx", "shard_activation", "current_mesh"]

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None
)


@contextlib.contextmanager
def activation_sharding_ctx(mesh, rules: AxisRules = DEFAULT_RULES):
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_mesh():
    """The ``DeviceMesh`` of the innermost context, or None."""
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else None


def shard_activation(x: torch.Tensor, spec: tuple[str | None, ...]
                     ) -> torch.Tensor:
    """``x`` ``[B, S, ...]``, whole on every rank, as the stream between
    layers holds it (module docstring): this rank's slab of the sequence
    inside a tensor-parallel context whose ``model`` size divides ``S``,
    else ``x``.  ``spec`` names its logical axes as the reference's call
    does."""
    tp = tensor.current()
    if tp is None or not tensor.seq_splits(tp.size, x.shape[1]):
        return x
    return tensor.split_sequence(x, tp)
