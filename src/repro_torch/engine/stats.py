"""Measured activation-skip statistics (the engine side of paper §V-B).

Port of ``repro/engine/stats.py``, host numpy.  The executor emits one
raw counter per conv layer (``counts[c, p]`` = windows whose channel-``c``
selection under pattern ``p`` was all-zero, out of ``windows``), and the
classes here carry those counters across batches and requests.  Because
``channel_norm`` is per-sample, counters accumulated over scheduler
batches (dead slots masked out of counts and windows alike) equal one
stats forward over the concatenated live images.

``to_distribution``/``to_distributions`` convert the counters into the
crossbar simulator's :class:`~repro_torch.core.simulator.SkipDistribution`,
which ``CompiledNetwork.hardware_report`` prices energy and cycles from.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.patterns import bits_to_mask
from repro_torch.core.simulator import SkipDistribution

__all__ = [
    "LayerSkipStats",
    "ActivationStats",
    "skip_patterns_and_masks",
    "stats_from_counts",
]


def skip_patterns_and_masks(
    pattern_bits: np.ndarray, kernel_size: int
) -> tuple[tuple[int, ...], np.ndarray]:
    """The distinct patterns of a layer and their boolean position masks.

    Returns (patterns, masks) with masks ``[P, kernel_size]`` bool, row i
    the selected patch positions of ``patterns[i]``.  The ordering matches
    the counter columns the executor emits.
    """
    patterns = tuple(int(p) for p in np.unique(np.asarray(pattern_bits)))
    masks = np.stack([bits_to_mask(p, kernel_size) for p in patterns])
    return patterns, masks


@dataclasses.dataclass
class LayerSkipStats:
    """All-zero-selection counters for one conv layer.

    counts[c, i]: windows whose channel-``c`` input selection under
    ``patterns[i]`` was entirely zero, out of ``windows`` observed windows.
    The all-zero pattern selects nothing and always counts as skippable.
    ``occurrences[c, i]`` is how many output channels use pattern i on
    input channel c (weights :meth:`mean_skip`).
    """

    name: str
    kernel_size: int
    patterns: tuple[int, ...]
    windows: int
    counts: np.ndarray  # [C_in, P] int64
    occurrences: np.ndarray | None = None  # [C_in, P] int64

    def skip_fractions(self) -> np.ndarray:
        """Measured P(selection all-zero) per (channel, pattern), [C, P]."""
        return self.counts / max(self.windows, 1)

    def mean_skip(self) -> float:
        """Mean measured skip over the layer's real (channel, pattern)
        pairs, occurrence-weighted when known; the all-zero pattern is
        excluded."""
        frac = self.skip_fractions()
        nonzero = np.array([p != 0 for p in self.patterns])
        if not nonzero.any():
            return 0.0
        if self.occurrences is not None:
            w = self.occurrences * nonzero[None, :]
            total = w.sum()
            return float((frac * w).sum() / total) if total else 0.0
        return float(frac[:, nonzero].mean())

    def merge(self, other: "LayerSkipStats") -> "LayerSkipStats":
        if (other.name, other.patterns, other.kernel_size) != (
            self.name, self.patterns, self.kernel_size
        ) or other.counts.shape != self.counts.shape:
            raise ValueError(
                f"incompatible stats for layer {self.name!r}: "
                f"{other.patterns} vs {self.patterns}"
            )
        return LayerSkipStats(
            name=self.name,
            kernel_size=self.kernel_size,
            patterns=self.patterns,
            windows=self.windows + other.windows,
            counts=self.counts + other.counts,
            occurrences=self.occurrences,
        )

    def to_distribution(self) -> SkipDistribution:
        frac = self.skip_fractions()
        probs = {
            (c, pat): float(frac[c, i])
            for c in range(frac.shape[0])
            for i, pat in enumerate(self.patterns)
        }
        return SkipDistribution(probs=probs, windows=self.windows)


@dataclasses.dataclass
class ActivationStats:
    """Per-layer measured skip statistics for one or more forward passes."""

    layers: dict[str, LayerSkipStats]

    def merge(self, other: "ActivationStats") -> "ActivationStats":
        merged = dict(self.layers)
        for name, st in other.layers.items():
            merged[name] = merged[name].merge(st) if name in merged else st
        return ActivationStats(layers=merged)

    def mean_skip(self) -> float:
        if not self.layers:
            return 0.0
        return float(np.mean([st.mean_skip() for st in self.layers.values()]))

    def to_distributions(self) -> dict[str, SkipDistribution]:
        return {n: st.to_distribution() for n, st in self.layers.items()}


def stats_from_counts(
    convs,
    counts: dict[str, np.ndarray],
    windows: dict[str, int],
) -> ActivationStats:
    """Assemble :class:`ActivationStats` from the executor's raw counters.

    convs: the program's ``CompiledConv`` list (pattern_bits source);
    counts / windows: per layer name, as returned by the forward and as
    computed from the actual input geometry.
    """
    layers = {}
    for op in convs:
        if op.name not in counts:
            continue
        kk = op.kernel * op.kernel
        patterns, _ = skip_patterns_and_masks(op.pattern_bits, kk)
        pb = np.asarray(op.pattern_bits)  # [c_out, c_in]
        occ = np.stack(
            [(pb == p).sum(axis=0) for p in patterns], axis=1
        ).astype(np.int64)  # [c_in, P]
        layers[op.name] = LayerSkipStats(
            name=op.name,
            kernel_size=kk,
            patterns=patterns,
            windows=int(windows[op.name]),
            counts=np.asarray(counts[op.name], np.int64),
            occurrences=occ,
        )
    return ActivationStats(layers=layers)
