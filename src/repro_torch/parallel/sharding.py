"""Logical-axis sharding rules (DP / TP / EP / SP + pod axis).

Port of ``repro/parallel/sharding.py``.  Every sharded operand carries a
tuple of *logical* axis names (its "spec"); :func:`logical_to_pspec`
resolves those through a rules table into a partition spec for a mesh,
returned as the plain tuple ``tuple(PartitionSpec(...))`` is in the
reference.  Divisibility is checked: a dimension that does not divide
evenly over its mesh axes is replicated (callers pad what must shard —
heads, vocabulary, the tiles of a block-pattern weight).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` in SPMD
style, so "placing" an operand means keeping this rank's slab of it:
:func:`shard_block_pattern` returns the rank's contiguous tile slab.
The reference's ``tree_pspecs`` / ``tree_shardings`` place the LLM
training parameters and wait for the port's training step (``ROADMAP.md``
item 11.7).

Rules (defaults):
  batch        -> ('pod', 'data')   data parallel, pods are extra DP
  seq_shard    -> 'model'           sequence parallelism
  heads/ff/... -> 'model'           tensor parallel
  expert       -> 'model'           expert parallel
  tiles        -> 'model'           block-pattern weight tiles
  embed/state  -> None              replicated
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "BP_LOGICAL_SPECS",
    "logical_to_pspec",
    "mesh_axis_sizes",
    "shard_block_pattern",
    "pad_to_multiple",
    "padded_heads",
]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: tuple[tuple[str, tuple[str, ...] | None], ...]

    def get(self, name: str) -> tuple[str, ...] | None:
        for k, v in self.rules:
            if k == name:
                return v
        raise KeyError(f"no sharding rule for logical axis {name!r}")


DEFAULT_RULES = AxisRules(
    rules=(
        ("batch", ("pod", "data")),
        ("data_only", ("data",)),
        ("seq", None),
        ("seq_shard", ("model",)),
        ("embed", None),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("ff", ("model",)),
        ("vocab", ("model",)),
        ("expert", ("model",)),
        ("tiles", ("model",)),  # block-pattern compressed weight tiles
        ("kv_lora", None),
        ("q_lora", None),
        ("state", None),
        ("conv", None),
        ("layers", None),
        ("unsharded", None),
    )
)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``
    and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def logical_to_pspec(
    spec: tuple[str | None, ...] | None,
    shape: tuple[int, ...],
    mesh,
    rules: AxisRules = DEFAULT_RULES,
) -> tuple:
    """Resolve a logical spec to a partition spec, checking divisibility.

    Returns a tuple with one entry per leading dimension: ``None``
    (replicated), a mesh axis name, or a tuple of names; trailing
    ``None`` entries are dropped, as ``PartitionSpec`` drops them.
    """
    if spec is None:
        return ()
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} vs shape {shape}")
    sizes = mesh_axis_sizes(mesh)
    out: list = []
    for name, dim in zip(spec, shape):
        axes = None if name is None else rules.get(name)
        axes = tuple(a for a in axes or () if a in sizes)
        if not axes or dim % math.prod(sizes[a] for a in axes) != 0:
            out.append(None)  # absent axes, or a dim that does not divide
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


# Logical axis specs of a BlockPatternWeight's operands: the tile axis is
# the tensor-parallel dimension of the compressed spmm (the 'tiles' rule
# above), everything else replicates.  ``w_scales`` only exists on
# quantized weights and shards the same way as its bricks; ``nnz`` is the
# per-tile brick count the CUDA kernels read.
BP_LOGICAL_SPECS: dict[str, tuple[str | None, ...]] = {
    "w_comp": ("tiles", None, None, None),
    "block_ids": ("tiles", None),
    "w_scales": ("tiles", None),
    "nnz": ("tiles",),
}


def shard_block_pattern(bp, mesh, model_axis: str = "model"):
    """This rank's contiguous tile slab of a ``BlockPatternWeight``.

    ``w_comp``, ``block_ids``, ``nnz`` (and ``w_scales`` when quantized)
    keep the tiles ``[r * T / n, (r + 1) * T / n)`` of this rank's
    coordinate ``r`` along ``model_axis`` (of size ``n``).  An operand
    stays whole when the axis is absent from the mesh or does not divide
    the tile count; callers pad first (``engine/partition.pad_bp_tiles``).
    The geometry and permutations (``n_out``, ``inv_order``) are the
    whole layer's.  Returns a new dataclass instance.
    """
    rules = AxisRules(rules=(("tiles", (model_axis,)),))
    rank = None
    placed = {}
    for field, spec in BP_LOGICAL_SPECS.items():
        arr = getattr(bp, field, None)
        if arr is None:
            continue
        if logical_to_pspec(spec, tuple(arr.shape), mesh, rules) == ():
            continue
        if rank is None:
            rank = mesh.get_local_rank(model_axis)
        per = arr.shape[0] // mesh_axis_sizes(mesh)[model_axis]
        placed[field] = arr[rank * per:(rank + 1) * per]
    return dataclasses.replace(bp, **placed)


def pad_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def padded_heads(n_heads: int, shards: int = 16) -> int:
    """Head count padded so the head axis shards (MaxText-style padding).

    Padded heads carry zero weights in the in/out projections, so they are
    numerically inert.
    """
    return pad_to_multiple(n_heads, shards)
