"""How a ``CompiledNetwork`` is meant to spread over several devices.

Port of the data half of ``repro/engine/partition.py``: what crossbar
pricing needs (``hardware_report``'s ``chips`` section) and what the
saved manifest carries.

  * **tile-parallel** (the ``model`` axis): the ``n_tiles`` axis of every
    :class:`~repro_torch.core.sparse.BlockPatternWeight` is padded up to a
    multiple of the shard count and split contiguously
    (:func:`tile_assignment`); padding tiles hold no bricks.
  * **batch-parallel** (the ``data`` axis): batch rows are split across
    devices.

:class:`NetworkPartition` is the declarative record of that split.  It
rides on ``CompiledNetwork.partition`` and through ``serialize.py``, so a
program partitioned by either package loads and prices the same in the
other.  Executing a partition (padding the bricks, the scatter and the
all-reduce) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["NetworkPartition", "padded_tiles", "tile_assignment"]


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
    mult = max(shards, 1)
    return ((n_tiles + mult - 1) // mult) * mult


def tile_assignment(n_tiles: int, shards: int) -> np.ndarray:
    """Contiguous padded-tile indices per shard: int [shards, tiles/shard].

    Every padded tile index appears exactly once; entries ``>= n_tiles``
    are padding tiles.
    """
    shards = max(shards, 1)
    per = padded_tiles(n_tiles, shards) // shards
    return np.arange(shards * per, dtype=np.int64).reshape(shards, per)
