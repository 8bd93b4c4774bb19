"""The ``CompiledNetwork`` artifact: what the engine compiler emits.

Port of ``repro/engine/program.py`` as data.  A compiled program is an
ordered op list — one ``CompiledConv`` per conv layer (im2col
conv-as-spmm + norm/ReLU + optional 2x2 maxpool), a global average pool,
and a ``CompiledFC`` head — each carrying real kernel operands (a
:class:`~repro_torch.core.sparse.BlockPatternWeight`).

The crossbar pricing (``hardware_report``, ``weight_bytes``) and the
static verifier (``verify``) are not ported yet; until they are, the
searched ``mapping``, the ``partition`` and the range ``certificate``
ride along as the raw manifest dicts ``serialize.py`` reads and writes,
so they round-trip verbatim.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.quantize import n_cell_slices
from repro_torch.core.sparse import BlockPatternWeight
from repro_torch.models.cnn import CNNConfig

__all__ = ["CompiledConv", "CompiledFC", "CompiledNetwork"]


@dataclasses.dataclass
class CompiledConv:
    """One conv layer lowered to an im2col spmm.

    ``bp`` operates on the *padded* matmul view: patches padded from
    ``c_in * kernel**2`` to ``bp.k_in`` rows, outputs padded from ``c_out``
    to ``bp.n_out`` columns (the executor slices the first ``c_out`` back
    out after the inverse permutation).  ``mapping`` is the searched
    crossbar mapping's manifest entry, or None for the fixed scheme.
    """

    name: str
    c_in: int
    c_out: int
    kernel: int  # spatial kernel side (3 for 3x3)
    out_hw: int  # output feature-map side at compile-time input_hw
    pool_after: bool
    bp: BlockPatternWeight
    bias: np.ndarray  # [c_out]
    pattern_bits: np.ndarray  # [c_out, c_in] packed kernel patterns
    mapping: dict | None = None

    @property
    def k_unpadded(self) -> int:
        return self.c_in * self.kernel * self.kernel


@dataclasses.dataclass
class CompiledFC:
    """The FC head lowered onto the same compressed-spmm path."""

    d_in: int
    d_out: int
    bp: BlockPatternWeight
    bias: np.ndarray  # [d_out]
    reorder: str = "pattern"


@dataclasses.dataclass
class CompiledNetwork:
    """Executable artifact: ordered ops + geometry.

    ``precision`` records the stored weight representation ('fp32', or
    'int8' for per-brick quantized weights + scales) and ``cell_bits``
    the RRAM cell width those weights are sliced over.  ``partition`` and
    ``certificate`` are manifest dicts carried for the slices that will
    use them (multi-device execution, range certification).
    """

    config: CNNConfig
    convs: list[CompiledConv]
    fc: CompiledFC
    block: int
    tile: int
    partition: dict | None = None
    precision: str = "fp32"
    cell_bits: int = 4
    certificate: dict | None = None

    @property
    def cells_per_weight(self) -> int | None:
        """Cell slices each stored weight occupies: ``ceil(8 / cell_bits)``
        for int8 programs, None for fp32 (no cell slices stored)."""
        if self.precision == "int8":
            return n_cell_slices(self.cell_bits)
        return None

    @property
    def num_ops(self) -> int:
        # convs + global-avg-pool + fc
        return len(self.convs) + 2
