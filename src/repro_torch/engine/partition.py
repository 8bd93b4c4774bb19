"""How a ``CompiledNetwork`` is meant to spread over several devices.

Port of ``repro/engine/partition.py``.  The paper's OU-based
accelerator scales by spreading a sparse network's crossbar tiles over
many parallel arrays; the engine spreads each layer's compressed spmm
operands over a mesh of devices the same way:

  * **tile-parallel** (the ``model`` axis): the ``n_tiles`` axis of every
    :class:`~repro_torch.core.sparse.BlockPatternWeight` is zero-padded up
    to a multiple of the shard count (:func:`pad_bp_tiles`) and split
    contiguously (:func:`tile_assignment`).  Each device computes the
    output columns of its own tiles; the executor scatters the partial
    outputs into full width and all-reduces them before the inverse
    output permutation (the Output Indexing Unit stays global).  Padding
    tiles carry zero bricks and ``nnz == 0``, so they are numerically
    inert, like the crossbar mapper's grey area.
  * **batch-parallel** (the ``data`` axis): batch rows are split across
    devices; activation-skip counters are all-reduced, so the measured
    statistics equal the single-device run's.

:class:`NetworkPartition` is the declarative record of that split.  It
rides on ``CompiledNetwork.partition`` and through ``serialize.py``, so a
program partitioned by either package loads, prices and runs the same in
the other; ``executor.make_forward(..., mesh=...)`` realizes it on a
``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sparse import BlockPatternWeight
from repro_torch.parallel.sharding import mesh_axis_sizes, pad_to_multiple

__all__ = [
    "NetworkPartition",
    "padded_tiles",
    "tile_assignment",
    "pad_bp_tiles",
    "partition_from_mesh",
    "partition_network",
]


@dataclasses.dataclass(frozen=True)
class NetworkPartition:
    """Declarative split of a compiled program over a device mesh.

    ``model`` tile-parallel shards x ``data`` batch-parallel shards; the
    axis names bind the split to mesh axes at execution time.
    """

    data: int = 1
    model: int = 1
    data_axis: str = "data"
    model_axis: str = "model"

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"invalid partition {self.data}x{self.model}")

    @property
    def n_chips(self) -> int:
        return self.data * self.model

    def to_manifest(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_manifest(cls, entry: dict) -> "NetworkPartition":
        return cls(
            data=int(entry["data"]),
            model=int(entry["model"]),
            data_axis=entry.get("data_axis", "data"),
            model_axis=entry.get("model_axis", "model"),
        )


def padded_tiles(n_tiles: int, shards: int) -> int:
    """Tile count padded up so ``shards`` devices hold equal tile slabs."""
    return pad_to_multiple(n_tiles, max(shards, 1))


def tile_assignment(n_tiles: int, shards: int) -> np.ndarray:
    """Contiguous padded-tile indices per shard: int [shards, tiles/shard].

    Every padded tile index appears exactly once; entries ``>= n_tiles``
    are padding tiles (all-zero bricks after :func:`pad_bp_tiles`).
    """
    shards = max(shards, 1)
    per = padded_tiles(n_tiles, shards) // shards
    return np.arange(shards * per, dtype=np.int64).reshape(shards, per)


def _pad_tiles(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` with ``pad`` zero entries appended along its first axis."""
    return F.pad(t, [0, 0] * (t.dim() - 1) + [0, pad])


def pad_bp_tiles(bp: BlockPatternWeight, shards: int) -> BlockPatternWeight:
    """Copy of ``bp`` with the tile axis zero-padded for ``shards`` devices.

    Padded tiles have all-zero ``w_comp`` bricks, ``block_ids == 0`` (they
    would gather block 0 and multiply by zeros) and ``nnz == 0``, so the
    CUDA kernels write zeros for them without reading a brick.  ``n_out``
    and the permutations are untouched: padded output columns sit past
    every ``inv_order`` entry, so the inverse permutation drops them and
    ``dense()`` reconstructs the identical matrix.  Quantized weights pad
    ``w_scales`` with zeros too.  Tensors stay on ``bp``'s device.
    """
    pad = padded_tiles(bp.n_tiles, shards) - bp.n_tiles
    if pad == 0:
        return bp
    return dataclasses.replace(
        bp,
        w_comp=_pad_tiles(bp.w_comp, pad),
        block_ids=_pad_tiles(bp.block_ids, pad),
        nnz=np.pad(np.asarray(bp.nnz), (0, pad)).astype(np.int32),
        w_scales=(None if bp.w_scales is None
                  else _pad_tiles(bp.w_scales, pad)),
    )


def partition_from_mesh(mesh, partition: NetworkPartition | None = None):
    """Resolve (and validate) a partition against a ``DeviceMesh``.

    With ``partition=None`` the split is read off the mesh's ``data`` /
    ``model`` dim sizes (absent dims count as 1).  An explicit partition
    must name dims the mesh has, at the sizes the mesh has: a program
    partitioned for 4 devices must not silently run on 2.
    """
    axis_sizes = mesh_axis_sizes(mesh)
    if partition is None:
        return NetworkPartition(
            data=axis_sizes.get("data", 1), model=axis_sizes.get("model", 1)
        )
    for axis, want in (
        (partition.data_axis, partition.data),
        (partition.model_axis, partition.model),
    ):
        have = axis_sizes.get(axis, 1)
        if want != have:
            raise ValueError(
                f"partition wants {axis}={want} but mesh has {axis}={have} "
                f"(mesh shape {axis_sizes})"
            )
    return partition


def partition_network(
    program,
    data: int = 1,
    model: int = 1,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """Record a partition on a compiled program (weights stay unpadded).

    Returns a new ``CompiledNetwork`` carrying the partition; tile padding
    happens when the executor realizes the partition on a mesh, so the
    stored artifact (and ``serialize.py``) keeps the compact operands.
    The partition is statically verified against the program (axis names
    distinct, tile assignment a disjoint cover of every layer's padded
    tile axis) and an invalid split raises
    :class:`~repro_torch.analysis.diagnostics.VerificationError` here, at
    declaration time.
    """
    part = NetworkPartition(
        data=data, model=model, data_axis=data_axis, model_axis=model_axis
    )
    from repro_torch.analysis.verify import verify_partition

    verify_partition(program, part).raise_if_errors("partition_network")
    return dataclasses.replace(program, partition=part)
