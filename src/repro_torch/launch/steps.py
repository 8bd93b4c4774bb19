"""Parameter and optimizer-state placement for the sharded train step.

Port of the placement helpers of ``src/repro/launch/steps.py``:
:func:`param_shardings` (every parameter leaf placed by its logical spec
under the default rules) and :func:`_zero1` (ZeRO-1: the optimizer
moments split further over ``data``).  Both return trees of
``parallel.sharding.Placement``, this rank's share of each leaf.

The rest of the reference module is left out: ``build_step`` AOT-lowers
a jitted step on ``ShapeDtypeStruct`` stand-ins for the multi-pod dry
run, which has no PyTorch counterpart, and ``cache_pspec`` /
``cache_shardings`` only serve ``build_step`` (``ROADMAP.md``, "Out of
scope").  The port's sharded step is ``runtime.train.make_train_step``
with ``shardings=``.
"""

from __future__ import annotations

from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    _map,
    _shape,
    mesh_axis_sizes,
    placement,
    tree_shardings,
)

__all__ = ["param_shardings"]


def param_shardings(specs, shapes, mesh):
    """The :class:`~repro_torch.parallel.sharding.Placement` of every
    parameter: its logical spec resolved under ``DEFAULT_RULES``."""
    return tree_shardings(specs, shapes, mesh, DEFAULT_RULES)


def _zero1(p_shard, p_shapes, mesh):
    """ZeRO-1: shard optimizer moments over 'data' on the first dim that is
    currently unsharded and divisible — on top of the param sharding.
    The spec keeps a ``None`` for every dim before the one split, as the
    reference's ``P(*spec)`` does."""
    dsize = mesh_axis_sizes(mesh).get("data", 1)

    def one(pl, shape):
        shape = _shape(shape)
        spec = list(pl.pspec) + [None] * (len(shape) - len(pl.pspec))
        for i, (ax, dim) in enumerate(zip(spec, shape)):
            if ax is None and dim % dsize == 0 and dsize > 1:
                spec[i] = "data"
                return placement(tuple(spec), shape, mesh)
        return pl

    return _map(one, p_shard, p_shapes)
