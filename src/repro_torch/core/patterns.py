"""Pattern extraction, selection and projection (paper §III-A).

A *pattern* is the boolean nonzero-mask of a convolution kernel (e.g. a 3x3
kernel has 2**9 = 512 possible patterns, including the all-zero pattern).
Pattern pruning constrains every kernel in a layer to a small per-layer
dictionary of patterns:

  1. start from an irregularly pruned network,
  2. compute the PDF of the observed patterns per layer,
  3. keep the top-K most probable patterns as the candidate dictionary,
  4. project every kernel onto its nearest candidate pattern
     (projection = elementwise multiply with the candidate mask),
  5. retrain, repeat.

Masks are represented as integer bitmasks over the flattened kernel
positions (bit i set <=> position i nonzero), which makes PDF computation,
hamming distance and dictionary handling cheap and hashable.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence

import numpy as np

__all__ = [
    "PatternDict",
    "kernel_masks",
    "masks_to_bits",
    "bits_to_mask",
    "pattern_pdf",
    "select_candidates",
    "project_to_patterns",
    "pattern_sizes",
    "ALL_ZERO",
]

ALL_ZERO = 0  # bitmask of the all-zero pattern


def kernel_masks(weights: np.ndarray, atol: float = 0.0) -> np.ndarray:
    """Boolean nonzero masks for a conv weight tensor.

    Args:
      weights: [C_out, C_in, Kh, Kw] (or already flattened [C_out, C_in, K]).
      atol: magnitude at or below which a weight counts as zero.

    Returns:
      bool array [C_out, C_in, K] with K = Kh*Kw.
    """
    w = np.asarray(weights)
    if w.ndim == 4:
        w = w.reshape(w.shape[0], w.shape[1], -1)
    if w.ndim != 3:
        raise ValueError(f"expected 3D/4D weights, got shape {w.shape}")
    return np.abs(w) > atol


def masks_to_bits(masks: np.ndarray) -> np.ndarray:
    """Pack boolean masks [..., K] into integer bitmasks [...]."""
    masks = np.asarray(masks, dtype=np.int64)
    k = masks.shape[-1]
    if k > 62:
        raise ValueError(f"kernel size {k} too large for bitmask packing")
    weights = (1 << np.arange(k, dtype=np.int64))
    return (masks * weights).sum(axis=-1)


def bits_to_mask(bits: int, k: int) -> np.ndarray:
    """Unpack an integer bitmask into a boolean mask of length k."""
    return ((int(bits) >> np.arange(k)) & 1).astype(bool)


def pattern_pdf(bits: np.ndarray) -> dict[int, float]:
    """Probability density over patterns, from packed kernel bitmasks."""
    bits = np.asarray(bits).reshape(-1)
    counts = Counter(int(b) for b in bits)
    total = float(bits.size)
    return {b: c / total for b, c in counts.items()}


@dataclasses.dataclass(frozen=True)
class PatternDict:
    """A per-layer pattern dictionary.

    Attributes:
      k: flattened kernel size (e.g. 9 for 3x3).
      patterns: sorted tuple of integer bitmasks. Always contains ALL_ZERO —
        the paper never stores all-zero kernels, so projection must be able
        to produce them.
    """

    k: int
    patterns: tuple[int, ...]

    def __post_init__(self):
        pats = tuple(sorted(set(int(p) for p in self.patterns) | {ALL_ZERO}))
        object.__setattr__(self, "patterns", pats)

    @property
    def num_patterns(self) -> int:
        return len(self.patterns)

    @property
    def num_nonzero_patterns(self) -> int:
        return len(self.patterns) - 1

    def masks(self) -> np.ndarray:
        """[P, k] boolean masks."""
        return np.stack([bits_to_mask(p, self.k) for p in self.patterns])

    def sizes(self) -> np.ndarray:
        """[P] nonzero count of each pattern."""
        return self.masks().sum(axis=-1).astype(np.int64)


def pattern_sizes(bits: np.ndarray) -> np.ndarray:
    """Popcount of packed bitmasks (vectorised)."""
    bits = np.asarray(bits, dtype=np.uint64)
    out = np.zeros(bits.shape, dtype=np.int64)
    b = bits.copy()
    while b.any():
        out += (b & np.uint64(1)).astype(np.int64)
        b >>= np.uint64(1)
    return out


def select_candidates(
    pdf: dict[int, float], num_patterns: int, k: int
) -> PatternDict:
    """Top-K most probable patterns (paper: 'largest probability' candidates).

    The all-zero pattern is always included *in addition* (it costs no
    crossbar area and no index storage, and lets the projection drop whole
    kernels — the paper's all-zero-pattern ratio is 27–41%).
    """
    ranked = sorted(pdf.items(), key=lambda kv: (-kv[1], kv[0]))
    chosen = [b for b, _ in ranked if b != ALL_ZERO][:num_patterns]
    return PatternDict(k=k, patterns=tuple(chosen) + (ALL_ZERO,))


def _distance_matrix(
    weights_flat: np.ndarray,
    kbits: np.ndarray,
    pdict: PatternDict,
    metric: str,
) -> np.ndarray:
    """Distance from every kernel to every candidate pattern.

    metrics:
      'hamming'   — bit distance between the kernel's own mask and the pattern
                    (the paper's 'common vector distance' on masks).
      'magnitude' — L2 norm of the weights *discarded* by projecting onto the
                    pattern (energy-preserving; what retraining actually
                    cares about).  Used as the default.
    """
    pmasks = pdict.masks().astype(np.float64)  # [P, k]
    if metric == "hamming":
        kmask = np.stack([bits_to_mask(b, pdict.k) for b in kbits]).astype(
            np.float64
        )  # [n, k]
        # xor distance = |a| + |b| - 2 a.b
        return (
            kmask.sum(-1, keepdims=True)
            + pmasks.sum(-1)[None, :]
            - 2.0 * kmask @ pmasks.T
        )
    if metric == "magnitude":
        w2 = weights_flat.astype(np.float64) ** 2  # [n, k]
        kept = w2 @ pmasks.T  # [n, P] energy kept by each pattern
        total = w2.sum(-1, keepdims=True)
        return total - kept  # energy discarded
    raise ValueError(f"unknown metric {metric!r}")


def project_to_patterns(
    weights: np.ndarray,
    pdict: PatternDict,
    metric: str = "magnitude",
    zero_threshold: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Project every kernel onto its nearest dictionary pattern (paper §III-A).

    Projection of a kernel onto a pattern = elementwise multiplication of the
    kernel with the pattern mask.

    Args:
      weights: [C_out, C_in, Kh, Kw] or [C_out, C_in, K].
      pdict: candidate patterns.
      metric: see _distance_matrix.
      zero_threshold: kernels whose total L2 is at or below this are projected
        straight to the all-zero pattern.

    Returns:
      (projected_weights, pattern_bits) where projected_weights has the input
      shape and pattern_bits is [C_out, C_in] packed bitmasks of the chosen
      patterns.
    """
    w = np.asarray(weights, dtype=np.float64)
    orig_shape = w.shape
    if w.ndim == 4:
        w = w.reshape(w.shape[0], w.shape[1], -1)
    co, ci, k = w.shape
    if k != pdict.k:
        raise ValueError(f"kernel size {k} != dictionary size {pdict.k}")

    flat = w.reshape(-1, k)
    kbits = masks_to_bits(np.abs(flat) > 0)
    dist = _distance_matrix(flat, kbits, pdict, metric)

    # Tie-break: prefer the *smaller* pattern on equal distance (less area).
    sizes = pdict.sizes()
    order = np.lexsort((sizes, ))  # stable by size
    dist_ordered = dist[:, order]
    choice_ordered = np.argmin(dist_ordered, axis=1)
    choice = order[choice_ordered]

    # Dead kernels -> all-zero pattern.
    zero_idx = pdict.patterns.index(ALL_ZERO)
    l2 = np.sqrt((flat**2).sum(-1))
    choice = np.where(l2 <= zero_threshold, zero_idx, choice)

    pmasks = pdict.masks()  # [P, k]
    projected = flat * pmasks[choice]
    bits = np.array([pdict.patterns[c] for c in choice], dtype=np.int64)
    return (
        projected.reshape(orig_shape).astype(np.asarray(weights).dtype),
        bits.reshape(co, ci),
    )
