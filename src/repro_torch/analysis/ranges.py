"""Range certificates of compiled programs, as data.

Port of the data types of ``repro/analysis/ranges.py``:
:class:`LayerRanges` and :class:`RangeCertificate` with their manifest
round trip (format v4's ``certificate`` entry).  A certificate comes from
the reference's certification pass (``compile_network(verify=...)``
there); here it loads with a saved program, is priced by
``CompiledNetwork.hardware_report`` as its ``certified_potential``
section, and saves back to the same manifest entry.  The interval pass
itself (``analyze_network``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

__all__ = ["LayerRanges", "RangeCertificate"]


@dataclasses.dataclass(frozen=True)
class LayerRanges:
    """Certified per-layer facts: bounds, extrema, minimum cell table.

    ``pre_lo``/``pre_hi`` bound the raw spmm + bias output (the logits,
    for the FC head); ``act_lo``/``act_hi`` bound the layer's *output*
    activations after norm/ReLU/pool.  The quantized-path fields are
    ``None`` on fp32 operands.  ``min_cells`` is the ``[T, k_max]``
    certified cells-per-weight table (0 for groups that vanish on the
    layer's uniform reference grid); ``certified_cells`` is its max —
    the cell count the whole layer provably fits in.
    """

    name: str
    pre_lo: float
    pre_hi: float
    act_lo: float
    act_hi: float
    acc_int32_max: int | None = None
    acc_fp32_max: float | None = None
    min_cells: tuple[tuple[int, ...], ...] | None = None
    certified_cells: int | None = None
    stored_cells: int | None = None

    def to_manifest(self) -> dict:
        return {
            "name": self.name,
            "pre_lo": self.pre_lo,
            "pre_hi": self.pre_hi,
            "act_lo": self.act_lo,
            "act_hi": self.act_hi,
            "acc_int32_max": self.acc_int32_max,
            "acc_fp32_max": self.acc_fp32_max,
            "min_cells": (
                None if self.min_cells is None
                else [list(row) for row in self.min_cells]
            ),
            "certified_cells": self.certified_cells,
            "stored_cells": self.stored_cells,
        }

    @classmethod
    def from_manifest(cls, entry: dict) -> "LayerRanges":
        mc = entry.get("min_cells")
        return cls(
            name=str(entry["name"]),
            pre_lo=float(entry["pre_lo"]),
            pre_hi=float(entry["pre_hi"]),
            act_lo=float(entry["act_lo"]),
            act_hi=float(entry["act_hi"]),
            acc_int32_max=(
                None if entry.get("acc_int32_max") is None
                else int(entry["acc_int32_max"])
            ),
            acc_fp32_max=(
                None if entry.get("acc_fp32_max") is None
                else float(entry["acc_fp32_max"])
            ),
            min_cells=(
                None if mc is None
                else tuple(tuple(int(c) for c in row) for row in mc)
            ),
            certified_cells=(
                None if entry.get("certified_cells") is None
                else int(entry["certified_cells"])
            ),
            stored_cells=(
                None if entry.get("stored_cells") is None
                else int(entry["stored_cells"])
            ),
        )


@dataclasses.dataclass(frozen=True)
class RangeCertificate:
    """The certification pass's output: one entry per spmm layer
    (convs in schedule order, then ``fc``), plus the declared input
    range it was derived from and whether every certified bound stays
    inside the fp32 range (``fp32_safe``)."""

    input_lo: float
    input_hi: float
    precision: str
    cell_bits: int
    fp32_safe: bool
    layers: tuple[LayerRanges, ...]

    def layer(self, name: str) -> LayerRanges | None:
        for entry in self.layers:
            if entry.name == name:
                return entry
        return None

    def certified_cells(self) -> dict[str, int]:
        """Per-layer certified cell counts (quantized layers only)."""
        return {
            entry.name: entry.certified_cells
            for entry in self.layers
            if entry.certified_cells is not None
        }

    def to_manifest(self) -> dict:
        return {
            "input_lo": self.input_lo,
            "input_hi": self.input_hi,
            "precision": self.precision,
            "cell_bits": self.cell_bits,
            "fp32_safe": self.fp32_safe,
            "layers": [entry.to_manifest() for entry in self.layers],
        }

    @classmethod
    def from_manifest(cls, entry: dict) -> "RangeCertificate":
        return cls(
            input_lo=float(entry["input_lo"]),
            input_hi=float(entry["input_hi"]),
            precision=str(entry["precision"]),
            cell_bits=int(entry["cell_bits"]),
            fp32_safe=bool(entry["fp32_safe"]),
            layers=tuple(
                LayerRanges.from_manifest(e) for e in entry["layers"]
            ),
        )
