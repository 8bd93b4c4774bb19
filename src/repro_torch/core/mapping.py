"""Kernel-reordering weight mapping onto RRAM crossbars (paper §III-B, Figs 4-5).

Copied from ``repro/core/mapping.py``: host numpy, so every number it
produces is bit-equal to the reference's.

Workflow, per convolution layer and per input channel:

  1. group kernels (one per output channel) by their pattern,
  2. drop all-zero-pattern kernels entirely (never stored, never computed),
  3. compress each group by deleting the pattern's zero rows -> a dense
     *pattern block* of shape [pattern_size, n_kernels_with_that_pattern],
  4. sort the channel's blocks by pattern size (rows) descending,
  5. greedily pack blocks onto 512x512 crossbars:
       - the first block opens a column *strip* at the top,
       - the next block goes *below* the previous one (left-aligned) if the
         strip has enough rows left,
       - otherwise it opens a new strip in fresh columns (top-aligned); the
         rows left behind in the old strip are wasted ("grey area"),
  6. channels are mapped one after another onto the same running packing
     ("store all the weights channel by channel").

Each 16-bit weight occupies ``cells_per_weight`` adjacent 4-bit cells
(bit-slicing); widths below are tracked in *cells*.

The mapping also emits the index stream the architecture needs (paper §IV-C,
§V-D): per stored kernel, its output-channel index; per layer, the pattern
shape table.  ``indexing.py`` sizes the overhead, ``simulator.py`` prices
energy/cycles, ``ou.py`` derives the OU schedule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import numpy as np

from repro_torch.core.patterns import ALL_ZERO, PatternDict, pattern_sizes

__all__ = [
    "BLOCK_ORDERS",
    "CrossbarConfig",
    "MappingCandidate",
    "Placement",
    "PatternBlock",
    "LayerMapping",
    "NaiveMapping",
    "map_layer",
    "map_layer_naive",
]

# packing orders map_layer understands; the optimizer (core/mapsearch.py)
# searches over them and the verifier (V205) rejects anything else
BLOCK_ORDERS = ("pattern", "channel", "width", "similarity", "hybrid")


@dataclasses.dataclass(frozen=True)
class CrossbarConfig:
    """Hardware geometry (paper Table I)."""

    rows: int = 512
    cols: int = 512  # in cells
    cells_per_weight: int = 4  # 16-bit weights / 4 bits per cell
    ou_rows: int = 9
    ou_cols: int = 8  # in cells

    @property
    def weight_cols(self) -> int:
        return self.cols // self.cells_per_weight


@dataclasses.dataclass(frozen=True)
class MappingCandidate:
    """One point of the mapping design space (geometry + strategy tags).

    A candidate pins down everything ``hardware_report`` needs to price a
    layer — crossbar dims, cells per weight, OU shape, the crossbar
    packing order (``block_order``, a ``map_layer`` order) — plus the
    operand-level column ``reorder`` strategy
    (``core/sparse.reorder_columns``), which never changes the priced
    hardware numbers but does change the compressed operand's brick
    count.  ``core/mapsearch.py`` searches over candidates per layer;
    the chosen one rides on ``CompiledConv.mapping`` and in the saved
    manifest (format v3).

    Deliberately *not* validated at construction: the verifier
    (V205/V206) owns validity so corrupted saves surface as diagnostics,
    not construction errors.
    """

    rows: int = 512
    cols: int = 512  # in cells
    cells_per_weight: int = 4
    ou_rows: int = 9
    ou_cols: int = 8  # in cells
    block_order: str = "pattern"
    reorder: str = "pattern"

    def crossbar_config(self) -> CrossbarConfig:
        return CrossbarConfig(
            rows=self.rows,
            cols=self.cols,
            cells_per_weight=self.cells_per_weight,
            ou_rows=self.ou_rows,
            ou_cols=self.ou_cols,
        )

    def sort_key(self) -> tuple:
        """Deterministic total order (search tie-breaking)."""
        return (
            self.rows, self.cols, self.cells_per_weight,
            self.ou_rows, self.ou_cols, self.block_order, self.reorder,
        )

    def to_manifest(self) -> dict:
        return {
            "rows": self.rows,
            "cols": self.cols,
            "cells_per_weight": self.cells_per_weight,
            "ou_rows": self.ou_rows,
            "ou_cols": self.ou_cols,
            "block_order": self.block_order,
            "reorder": self.reorder,
        }

    @classmethod
    def from_manifest(cls, entry: dict) -> "MappingCandidate":
        return cls(
            rows=int(entry["rows"]),
            cols=int(entry["cols"]),
            cells_per_weight=int(entry["cells_per_weight"]),
            ou_rows=int(entry["ou_rows"]),
            ou_cols=int(entry["ou_cols"]),
            block_order=str(entry["block_order"]),
            reorder=str(entry["reorder"]),
        )


@dataclasses.dataclass(frozen=True)
class PatternBlock:
    """A compressed dense block: kernels of one pattern in one input channel."""

    channel: int  # input channel index
    pattern: int  # pattern bitmask
    height: int  # pattern size (rows)
    kernel_ids: tuple[int, ...]  # output-channel indices, in mapped order

    @property
    def n_kernels(self) -> int:
        return len(self.kernel_ids)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one (possibly split) block landed."""

    block: PatternBlock
    crossbar: int
    row0: int
    col0: int  # in cells
    width_cells: int

    @property
    def height(self) -> int:
        return self.block.height


@dataclasses.dataclass
class LayerMapping:
    """Result of mapping one layer with the pattern-pruned scheme."""

    config: CrossbarConfig
    placements: list[Placement]
    num_crossbars: int
    cells_used: int  # nonzero weight cells actually stored
    cells_wasted: int  # grey area inside claimed strips
    stored_kernels: int  # kernel instances with a nonzero pattern
    total_kernels: int  # C_out * C_in kernel instances
    c_out: int
    c_in: int
    kernel_size: int

    @property
    def cells_total(self) -> int:
        return self.num_crossbars * self.config.rows * self.config.cols

    @property
    def utilization(self) -> float:
        return self.cells_used / max(self.cells_total, 1)


@dataclasses.dataclass
class NaiveMapping:
    """The Fig-1 baseline: one filter per logical column, zeros stored."""

    config: CrossbarConfig
    num_crossbars: int
    rows_total: int  # C_in * K
    cols_total: int  # C_out * cells_per_weight
    c_out: int
    c_in: int
    kernel_size: int

    @property
    def cells_total(self) -> int:
        return self.num_crossbars * self.config.rows * self.config.cols


class _Packer:
    """Greedy strip packer over a growing list of crossbars (Fig 5)."""

    def __init__(self, config: CrossbarConfig):
        self.cfg = config
        self.crossbar = 0
        self.col0 = 0  # start column (cells) of the current strip
        self.strip_w = 0  # current strip width (cells)
        self.row = 0  # next free row in the current strip
        self.wasted = 0
        self.placements: list[Placement] = []

    def _open_strip(self, w: int, h: int) -> tuple[int, int, int]:
        cfg = self.cfg
        # account waste left behind in the strip we are abandoning
        if self.strip_w > 0:
            self.wasted += (cfg.rows - self.row) * self.strip_w
        self.col0 += self.strip_w
        if self.col0 + w > cfg.cols:
            # move to a fresh crossbar; the rest of this one is waste
            self.wasted += (cfg.cols - self.col0) * cfg.rows
            self.crossbar += 1
            self.col0 = 0
        self.strip_w = w
        self.row = h
        return self.crossbar, 0, self.col0

    def place(self, block: PatternBlock, width_cells: int) -> None:
        cfg = self.cfg
        h, w = block.height, width_cells
        if w > cfg.cols:
            raise ValueError("block wider than crossbar; split before placing")
        if self.strip_w > 0 and cfg.rows - self.row >= h:
            # place below the previous block, left-aligned
            xb, r0, c0 = self.crossbar, self.row, self.col0
            if w > self.strip_w:
                if self.col0 + w <= cfg.cols:
                    # widen the strip; the rows above the widened part are grey
                    self.wasted += self.row * (w - self.strip_w)
                    self.strip_w = w
                else:
                    xb, r0, c0 = self._open_strip(w, h)
                    self.placements.append(
                        Placement(block, xb, r0, c0, w)
                    )
                    return
            if w < self.strip_w:
                self.wasted += h * (self.strip_w - w)
            self.row += h
            self.placements.append(Placement(block, xb, r0, c0, w))
        else:
            xb, r0, c0 = self._open_strip(w, h)
            self.placements.append(Placement(block, xb, r0, c0, w))

    def finish(self) -> tuple[int, int]:
        """Returns (num_crossbars, wasted_cells_inside_claimed_area)."""
        if self.strip_w > 0:
            self.wasted += (self.cfg.rows - self.row) * self.strip_w
        used_crossbars = self.crossbar + 1 if self.placements else 0
        return used_crossbars, self.wasted


def _blocks_for_channel(
    channel: int,
    bits_c: np.ndarray,
    sizes_c: np.ndarray,
) -> list[PatternBlock]:
    """Group one input channel's kernels by pattern (paper Fig 4 reorder)."""
    blocks: dict[int, list[int]] = {}
    for out_ch, b in enumerate(bits_c):
        b = int(b)
        if b == ALL_ZERO:
            continue
        blocks.setdefault(b, []).append(out_ch)
    out = [
        PatternBlock(
            channel=channel,
            pattern=b,
            height=int(sizes_c[kernels[0]]),
            kernel_ids=tuple(kernels),
        )
        for b, kernels in blocks.items()
    ]
    # sort by pattern size descending (paper Fig 5), stable by pattern id
    out.sort(key=lambda blk: (-blk.height, blk.pattern))
    return out


def _pattern_similarity_rank(patterns: Iterable[int]) -> dict[int, int]:
    """Greedy nearest-neighbour chain over a layer's unique patterns.

    Starts from the largest pattern (most set bits; ties toward the
    smaller bitmask) and repeatedly appends the unvisited pattern with
    the greatest bit overlap with the current one (ties: smaller
    symmetric difference, then smaller bitmask) — the bit-level
    column-similarity ordering of arXiv 2511.14202 applied at pattern
    granularity.  Returns pattern -> chain rank; fully deterministic.
    """
    uniq = sorted(set(int(p) for p in patterns))
    if not uniq:
        return {}
    pop = {p: bin(p).count("1") for p in uniq}
    cur = min(uniq, key=lambda p: (-pop[p], p))
    remaining = set(uniq)
    rank: dict[int, int] = {}
    while True:
        rank[cur] = len(rank)
        remaining.discard(cur)
        if not remaining:
            return rank
        cur = min(
            remaining,
            key=lambda p: (-bin(cur & p).count("1"),
                           bin(cur ^ p).count("1"), p),
        )


def map_layer(
    pattern_bits: np.ndarray,
    config: CrossbarConfig = CrossbarConfig(),
    kernel_size: int = 9,
    block_order: str = "pattern",
) -> LayerMapping:
    """Map one layer's pattern-pruned kernels onto crossbars.

    Args:
      pattern_bits: [C_out, C_in] packed pattern bitmask per kernel instance.
      config: crossbar geometry.
      kernel_size: flattened kernel size (9 for 3x3).
      block_order: packing order of the pattern blocks.
        'pattern' — all blocks sorted by (pattern size desc, pattern,
          channel): same-pattern blocks are adjacent, so strips hold blocks
          of near-identical width.  This matches the paper's index layout
          ('we store the indexes pattern by pattern in the same order as
          mapping the pattern blocks to the crossbar') and is required to
          reach the paper's reported area efficiency.  Default.
        'channel' — the paper's §III-B narration read literally: channels
          one after another, blocks sorted by pattern size inside each
          channel.  Mixes block widths inside strips and packs much worse;
          kept for comparison.
        'width' — beyond-paper: global sort by width desc then height desc
          (best-fit-decreasing flavour); slightly better than 'pattern'.
        'similarity' — beyond-paper: blocks follow the greedy
          pattern-similarity chain (``_pattern_similarity_rank``), width
          descending within a pattern, so strips hold near-identical
          *shapes* even when pattern ids are far apart.
        'hybrid' — beyond-paper: height descending first (the packer's
          strongest signal), similarity-chain rank within equal heights.

    Returns:
      LayerMapping with placements and area accounting.
    """
    bits = np.asarray(pattern_bits, dtype=np.int64)
    if bits.ndim != 2:
        raise ValueError(f"pattern_bits must be [C_out, C_in], got {bits.shape}")
    c_out, c_in = bits.shape
    sizes = pattern_sizes(bits)  # [C_out, C_in]

    blocks: list[PatternBlock] = []
    for c in range(c_in):
        blocks.extend(_blocks_for_channel(c, bits[:, c], sizes[:, c]))
    if block_order == "pattern":
        # pattern-major (paper §IV-C index order); width-descending inside a
        # pattern group so strip widths shrink monotonically
        blocks.sort(key=lambda b: (-b.height, b.pattern, -b.n_kernels, b.channel))
    elif block_order == "width":
        blocks.sort(key=lambda b: (-b.n_kernels, -b.height, b.pattern, b.channel))
    elif block_order in ("similarity", "hybrid"):
        rank = _pattern_similarity_rank(b.pattern for b in blocks)
        if block_order == "similarity":
            blocks.sort(
                key=lambda b: (rank[b.pattern], -b.n_kernels, b.channel)
            )
        else:
            blocks.sort(
                key=lambda b: (-b.height, rank[b.pattern], -b.n_kernels,
                               b.channel)
            )
    elif block_order != "channel":
        raise ValueError(f"unknown block_order {block_order!r}")

    packer = _Packer(config)
    cells_used = 0
    stored = 0
    cpw = config.cells_per_weight
    max_w_cells = config.cols

    for block in blocks:
        stored += block.n_kernels
        cells_used += block.height * block.n_kernels * cpw
        # split blocks wider than one crossbar
        max_kernels = max_w_cells // cpw
        ids = block.kernel_ids
        for i in range(0, len(ids), max_kernels):
            part = dataclasses.replace(block, kernel_ids=ids[i : i + max_kernels])
            packer.place(part, part.n_kernels * cpw)

    n_xbar, wasted = packer.finish()
    return LayerMapping(
        config=config,
        placements=packer.placements,
        num_crossbars=n_xbar,
        cells_used=cells_used,
        cells_wasted=wasted,
        stored_kernels=stored,
        total_kernels=c_out * c_in,
        c_out=c_out,
        c_in=c_in,
        kernel_size=kernel_size,
    )


def map_layer_naive(
    c_out: int,
    c_in: int,
    kernel_size: int = 9,
    config: CrossbarConfig = CrossbarConfig(),
) -> NaiveMapping:
    """The Fig-1 baseline: whole filters as columns, zeros included.

    The (C_in*K) x (C_out*cells_per_weight) dense matrix is tiled over
    crossbars; every tile is a full crossbar (the paper's reported baseline
    crossbar counts are ceil-tilings of the dense weight matrix).
    """
    rows = c_in * kernel_size
    cols = c_out * config.cells_per_weight
    n = math.ceil(rows / config.rows) * math.ceil(cols / config.cols)
    return NaiveMapping(
        config=config,
        num_crossbars=n,
        rows_total=rows,
        cols_total=cols,
        c_out=c_out,
        c_in=c_in,
        kernel_size=kernel_size,
    )
