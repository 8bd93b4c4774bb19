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
:func:`shard_block_pattern` returns the rank's contiguous tile slab, and
:func:`tree_shardings` gives, for every leaf of a parameter tree, a
:class:`Placement` — the port's ``NamedSharding``: which mesh axes split
each dim and this rank's slab along them.  :func:`shard_tensor` cuts a
whole tensor to the rank's slab and :func:`gather_tensor` all-gathers
the slabs back over the mesh groups that split it.  A dim split by
several axes ``(a, b)`` is cut major-first, as ``PartitionSpec`` cuts
it: slab ``coord(a) * size(b) + coord(b)``.

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

import torch
import torch.distributed as dist

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "BP_LOGICAL_SPECS",
    "Placement",
    "logical_to_pspec",
    "mesh_axis_sizes",
    "placement",
    "tree_pspecs",
    "tree_shardings",
    "shard_tensor",
    "cut_slab",
    "gather_tensor",
    "shard_tree",
    "gather_tree",
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


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the structure.  Only dicts and lists are
    containers, so a spec tuple, a shape and a :class:`Placement` are
    leaves."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape: a tensor's (or anything with ``.shape``), or the
    leaf itself as a tuple of ints."""
    return tuple(int(d) for d in getattr(leaf, "shape", leaf))


def _entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one partition-spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def tree_pspecs(specs, shapes, mesh, rules: AxisRules = DEFAULT_RULES):
    """A logical-spec tree and a shape tree (tensors or shapes) -> the tree
    of partition specs, each the tuple :func:`logical_to_pspec` gives
    (``tuple(P)`` of the reference's, leaf for leaf)."""
    return _map(lambda s, sh: logical_to_pspec(s, _shape(sh), mesh, rules),
                specs, shapes)


@dataclasses.dataclass(frozen=True)
class Placement:
    """This rank's share of one leaf on a mesh (the reference's
    ``NamedSharding``).

    ``shape`` is the whole leaf's and ``pspec`` its partition spec; dim
    ``d`` splits into ``blocks[d]`` equal slabs over the axes of
    ``pspec[d]``, of which this rank keeps slab ``index[d]``."""

    shape: tuple[int, ...]
    pspec: tuple
    blocks: tuple[int, ...]
    index: tuple[int, ...]

    @property
    def whole(self) -> bool:
        return all(b == 1 for b in self.blocks)

    @property
    def slab_shape(self) -> tuple[int, ...]:
        return tuple(d // b for d, b in zip(self.shape, self.blocks))

    @property
    def slices(self) -> tuple[slice, ...]:
        return tuple(slice(i * n, (i + 1) * n)
                     for i, n in zip(self.index, self.slab_shape))


def placement(pspec: tuple, shape, mesh) -> Placement:
    """This rank's :class:`Placement` of a leaf of ``shape`` under
    ``pspec`` (its coordinate along each axis from
    ``mesh.get_local_rank``)."""
    shape = _shape(shape)
    sizes = mesh_axis_sizes(mesh)
    blocks, index = [], []
    for d, dim in enumerate(shape):
        n, i = 1, 0
        for a in _entry_axes(pspec[d] if d < len(pspec) else None):
            n, i = n * sizes[a], i * sizes[a] + mesh.get_local_rank(a)
        if dim % n:
            raise ValueError(f"dim {d} of {shape} does not split over "
                             f"{pspec[d]!r} ({n} slabs)")
        blocks.append(n)
        index.append(i)
    return Placement(shape, tuple(pspec), tuple(blocks), tuple(index))


def tree_shardings(specs, shapes, mesh, rules: AxisRules = DEFAULT_RULES):
    """The :class:`Placement` of every leaf: :func:`tree_pspecs` on this
    rank of ``mesh``."""
    return _map(lambda p, sh: placement(p, sh, mesh),
                tree_pspecs(specs, shapes, mesh, rules), shapes)


def shard_tensor(full: torch.Tensor, pl: Placement) -> torch.Tensor:
    """This rank's slab of the whole tensor ``full``, a tensor of its own
    (the whole tensor itself when nothing splits it)."""
    if tuple(full.shape) != pl.shape:
        raise ValueError(f"tensor of shape {tuple(full.shape)} placed as "
                         f"{pl.shape}")
    return full if pl.whole else full[pl.slices].clone()


def cut_slab(slab: torch.Tensor, pl: Placement, sub: Placement
             ) -> torch.Tensor:
    """The part of ``pl``'s slab of a leaf that ``sub``, a placement of
    the same leaf inside it, keeps (ZeRO-1's moment slab of a param
    slab), a tensor of its own (the slab itself when they are equal)."""
    if tuple(slab.shape) != pl.slab_shape or sub.shape != pl.shape:
        raise ValueError(f"slab {tuple(slab.shape)} of {pl.shape} cut as "
                         f"{sub.slab_shape} of {sub.shape}")
    cut = tuple(slice(s.start - p.start, s.stop - p.start)
                for s, p in zip(sub.slices, pl.slices))
    if any(c.start < 0 or c.stop > n for c, n in zip(cut, pl.slab_shape)):
        raise ValueError(f"{sub} does not lie inside {pl}")
    return slab if sub.slab_shape == pl.slab_shape else slab[cut].clone()


def gather_tensor(slab: torch.Tensor, pl: Placement, mesh,
                  axes: tuple[str, ...] | None = None) -> torch.Tensor:
    """All-gather the slabs of ``pl`` back into the whole tensor: along
    each split dim, over each of its axes' mesh groups, minor axis first.
    ``axes`` limits the gather to those axes (the rest stay split)."""
    sizes = mesh_axis_sizes(mesh)
    out = slab
    for d, entry in enumerate(pl.pspec):
        for a in reversed(_entry_axes(entry)):
            if sizes[a] == 1 or (axes is not None and a not in axes):
                continue
            parts = [torch.empty_like(out) for _ in range(sizes[a])]
            dist.all_gather(parts, out.contiguous(), group=mesh.get_group(a))
            out = torch.cat(parts, dim=d)
    return out


def shard_tree(tree, placements):
    """:func:`shard_tensor` over matching trees."""
    return _map(shard_tensor, tree, placements)


def gather_tree(tree, placements, mesh):
    """:func:`gather_tensor` over matching trees; every rank of ``mesh``
    calls it, leaf for leaf in the same order."""
    return _map(lambda t, pl: gather_tensor(t, pl, mesh), tree, placements)


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
