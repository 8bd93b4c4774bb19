"""Weight index buffer encoding + overhead accounting (paper §IV-C, §V-D).

Copied from ``repro/core/indexing.py``: host numpy, so every number it
produces is bit-equal to the reference's.

Because kernels are reordered inside every input channel, the architecture
stores, pattern block by pattern block (in placement order):

  - the output-channel index of every stored kernel (<= 9 bits for 512
    output channels),
  - per pattern: the pattern shape bitmask (k bits) and its size.

All-zero-pattern kernels are not stored in the crossbars, so they cost no
index either — the paper's index overhead is dominated by the nonzero-
pattern kernel count.

``decode_placements`` reconstructs every weight's (crossbar, row, col) from
the index stream alone, replaying the greedy placement strategy — the same
procedure §IV-C describes for the Output Indexing Unit.  Tests assert it
round-trips against the mapper's actual placements.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.mapping import (
    CrossbarConfig,
    LayerMapping,
    Placement,
    _Packer,
    PatternBlock,
)

__all__ = ["IndexStream", "build_index_stream", "index_overhead_bits",
           "decode_placements"]


@dataclasses.dataclass
class IndexStream:
    """The serialized index content for one layer."""

    # per stored (split) block, in placement order:
    block_patterns: list[int]  # pattern bitmask
    block_channels: list[int]  # input channel
    block_kernel_ids: list[tuple[int, ...]]  # output-channel index list
    c_out: int
    kernel_size: int

    @property
    def stored_kernels(self) -> int:
        return sum(len(ids) for ids in self.block_kernel_ids)

    @property
    def num_blocks(self) -> int:
        return len(self.block_patterns)


def build_index_stream(mapping: LayerMapping) -> IndexStream:
    return IndexStream(
        block_patterns=[p.block.pattern for p in mapping.placements],
        block_channels=[p.block.channel for p in mapping.placements],
        block_kernel_ids=[p.block.kernel_ids for p in mapping.placements],
        c_out=mapping.c_out,
        kernel_size=mapping.kernel_size,
    )


def index_overhead_bits(stream: IndexStream) -> dict[str, int]:
    """Index buffer size (paper §V-D).

    kernel indexes: ceil(log2(C_out)) bits per stored kernel.
    pattern table:  per block, the pattern shape (k bits) + size
                    (ceil(log2(k+1)) bits) + channel id — the paper calls
                    this part negligible; we count it anyway.
    """
    idx_bits = max(1, math.ceil(math.log2(max(stream.c_out, 2))))
    kernel_bits = stream.stored_kernels * idx_bits
    k = stream.kernel_size
    per_block = k + math.ceil(math.log2(k + 1)) + 16  # shape + size + channel
    table_bits = stream.num_blocks * per_block
    return {
        "kernel_index_bits": kernel_bits,
        "pattern_table_bits": table_bits,
        "total_bits": kernel_bits + table_bits,
        "bits_per_kernel_index": idx_bits,
    }


def decode_placements(
    stream: IndexStream, config: CrossbarConfig = CrossbarConfig()
) -> list[Placement]:
    """Reconstruct weight placement purely from the index stream (§IV-C).

    'First, we get the index of the pattern with the biggest pattern size
    ... if there are enough rows behind the current block for next block,
    then we know it is placed there, otherwise ... in new columns.'

    The decoder replays the exact packer used by the mapper, which is the
    point: placement is a *deterministic function of the index stream*, so
    the hardware never stores coordinates.
    """
    packer = _Packer(config)
    cpw = config.cells_per_weight
    for pat, chan, ids in zip(
        stream.block_patterns, stream.block_channels, stream.block_kernel_ids
    ):
        height = bin(int(pat)).count("1")
        block = PatternBlock(
            channel=chan, pattern=pat, height=height, kernel_ids=tuple(ids)
        )
        packer.place(block, block.n_kernels * cpw)
    packer.finish()
    return packer.placements
