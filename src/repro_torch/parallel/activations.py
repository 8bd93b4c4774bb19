"""Activation sharding context (sequence parallelism between layers).

Port of ``repro/parallel/activations.py``.  The launcher installs a mesh
+ rules context; model code calls ``shard_activation(x, spec)`` at layer
boundaries, and ``models/attention.py`` reads :func:`current_mesh` to
take the sharded flash-decode route.  Outside a context it is a no-op.

:func:`shard_activation` returns ``x`` unchanged even inside a context:
the reference's ``with_sharding_constraint`` is a layout hint to the
compiler with no numerical effect, and the port's model weights and
activations are replicated on every rank (SPMD), so there is nothing to
re-lay out.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

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
    """``x`` unchanged (module docstring); ``spec`` names its logical axes
    as the reference's call does."""
    return x
