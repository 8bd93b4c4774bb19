"""Synthetic pattern-pruned VGG16 networks matching the paper's Table II.

The paper evaluates its *mapping* on pattern-pruned VGG16 checkpoints
(CIFAR-10/100/ImageNet).  Training those checkpoints needs GPU-weeks and the
original datasets; the mapping evaluation, however, only depends on the
pruning *statistics*: per-layer pattern counts, overall sparsity, and the
all-zero-pattern ratio — all of which Table II / §V-D report exactly.  This
module synthesises weight tensors whose statistics match those numbers, so
Figs 7-8 and the speedup/index-overhead analyses can be reproduced at full
scale.  (The pruning *algorithm* itself is validated end-to-end in miniature
by ``repro.core.pruning`` + ``tests/test_pruning.py``.)

Layer geometry is VGG16 config-D: 13 conv layers, 3x3 kernels, maxpool after
layers 2, 4, 7, 10, 13.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.patterns import ALL_ZERO, PatternDict

__all__ = [
    "VGG16_CONV_CHANNELS",
    "TABLE_II",
    "LayerSpec",
    "SyntheticLayer",
    "vgg16_layer_specs",
    "synthesize_network",
]

# (c_in, c_out) per conv layer, VGG16-D
VGG16_CONV_CHANNELS = [
    (3, 64), (64, 64),
    (64, 128), (128, 128),
    (128, 256), (256, 256), (256, 256),
    (256, 512), (512, 512), (512, 512),
    (512, 512), (512, 512), (512, 512),
]

# spatial output size per conv layer (stride-1 'same' convs, pool /2)
_POOL_AFTER = {2, 4, 7, 10, 13}


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    """Paper Table II + §V-D statistics."""

    name: str
    input_hw: int
    sparsity: float  # post-pattern-pruning conv weight sparsity
    zero_pattern_ratio: float  # fraction of kernels with the all-zero pattern
    patterns_per_layer: tuple[int, ...]  # Table II (incl. the all-zero pattern)


TABLE_II: dict[str, DatasetStats] = {
    "cifar10": DatasetStats(
        "cifar10", 32, 0.8603, 0.409,
        (2, 2, 2, 6, 8, 8, 8, 6, 5, 4, 6, 6, 8),
    ),
    "cifar100": DatasetStats(
        "cifar100", 32, 0.8523, 0.274,
        (2, 2, 2, 2, 2, 8, 8, 8, 5, 6, 7, 6, 8),
    ),
    "imagenet": DatasetStats(
        "imagenet", 224, 0.8248, 0.285,
        (2, 2, 2, 2, 2, 9, 12, 12, 9, 10, 6, 4, 4),
    ),
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    c_in: int
    c_out: int
    out_hw: int  # output feature-map side -> windows = out_hw**2
    kernel_size: int = 9


@dataclasses.dataclass
class SyntheticLayer:
    spec: LayerSpec
    pdict: PatternDict
    pattern_bits: np.ndarray  # [C_out, C_in]
    weights: np.ndarray  # [C_out, C_in, 9]


def vgg16_layer_specs(input_hw: int) -> list[LayerSpec]:
    specs = []
    hw = input_hw
    for i, (ci, co) in enumerate(VGG16_CONV_CHANNELS, start=1):
        specs.append(LayerSpec(f"conv{i}", ci, co, hw))
        if i in _POOL_AFTER:
            hw //= 2
    return specs


def _sample_distinct_patterns(
    rng: np.random.Generator, sizes: list[int], k: int
) -> list[int]:
    """Distinct nonzero bitmasks with the requested popcounts."""
    chosen: set[int] = set()
    out = []
    for s in sizes:
        for _ in range(1000):
            pos = rng.choice(k, size=s, replace=False)
            bits = int(np.sum(1 << pos.astype(np.int64)))
            if bits not in chosen:
                chosen.add(bits)
                out.append(bits)
                break
        else:  # pragma: no cover - 9 choose s always has room
            raise RuntimeError("could not sample distinct pattern")
    return out


def _allocate_fractions(
    sizes: np.ndarray, nonzero_frac: float, target_mean_size: float
) -> np.ndarray:
    """Find f_i >= 0 with sum f = nonzero_frac and sum f_i s_i / nonzero_frac
    = target_mean_size, via exponential tilting f_i ~ exp(-lam * s_i)."""
    sizes = sizes.astype(np.float64)
    lo, hi = -50.0, 50.0
    for _ in range(200):
        lam = 0.5 * (lo + hi)
        w = np.exp(-lam * (sizes - sizes.mean()))
        mean = float((w * sizes).sum() / w.sum())
        if mean > target_mean_size:
            lo = lam
        else:
            hi = lam
    w = np.exp(-lam * (sizes - sizes.mean()))
    return nonzero_frac * w / w.sum()


def synthesize_layer(
    spec: LayerSpec,
    n_patterns: int,
    zero_ratio: float,
    target_sparsity: float,
    rng: np.random.Generator,
    weight_scale: float = 1.0,
) -> SyntheticLayer:
    k = spec.kernel_size
    n_nonzero = max(1, n_patterns - 1)  # Table II counts include the all-zero
    # mean nonzeros per *stored* kernel needed to hit the layer sparsity
    mean_size = k * (1.0 - target_sparsity) / max(1.0 - zero_ratio, 1e-9)
    mean_size = float(np.clip(mean_size, 1.0, k))
    lo = max(1, int(np.floor(mean_size)) - 1)
    hi = min(k, int(np.ceil(mean_size)) + 2)
    size_pool = list(range(lo, hi + 1))
    sizes = [size_pool[i % len(size_pool)] for i in range(n_nonzero)]
    if int(np.floor(mean_size)) not in sizes:
        sizes[0] = int(np.floor(mean_size))
    pats = _sample_distinct_patterns(rng, sizes, k)
    sizes_arr = np.array(sizes, dtype=np.float64)

    fracs = _allocate_fractions(sizes_arr, 1.0 - zero_ratio, mean_size)
    probs = np.concatenate([[zero_ratio], fracs])
    probs = probs / probs.sum()
    all_pats = np.array([ALL_ZERO] + pats, dtype=np.int64)

    n_kernels = spec.c_out * spec.c_in
    choice = rng.choice(len(all_pats), size=n_kernels, p=probs)
    bits = all_pats[choice].reshape(spec.c_out, spec.c_in)

    masks = ((bits[..., None] >> np.arange(k)) & 1).astype(np.float64)
    fan_in = max(spec.c_in * k, 1)
    w = rng.normal(0.0, weight_scale / np.sqrt(fan_in), size=(spec.c_out, spec.c_in, k))
    weights = (w * masks).astype(np.float32)

    pdict = PatternDict(k=k, patterns=tuple(int(p) for p in all_pats))
    return SyntheticLayer(spec=spec, pdict=pdict, pattern_bits=bits, weights=weights)


def synthesize_network(
    dataset: str, seed: int = 0
) -> tuple[DatasetStats, list[SyntheticLayer]]:
    """Synthesize all 13 conv layers matching Table II for ``dataset``."""
    stats = TABLE_II[dataset]
    rng = np.random.default_rng(seed)
    specs = vgg16_layer_specs(stats.input_hw)
    layers = [
        synthesize_layer(
            spec,
            n_patterns=stats.patterns_per_layer[i],
            zero_ratio=stats.zero_pattern_ratio,
            target_sparsity=stats.sparsity,
            rng=rng,
        )
        for i, spec in enumerate(specs)
    ]
    return stats, layers


def network_sparsity(layers: list[SyntheticLayer]) -> float:
    nnz = sum(int((np.abs(l.weights) > 0).sum()) for l in layers)
    tot = sum(l.weights.size for l in layers)
    return 1.0 - nnz / tot


def network_zero_pattern_ratio(layers: list[SyntheticLayer]) -> float:
    zero = sum(int((l.pattern_bits == ALL_ZERO).sum()) for l in layers)
    tot = sum(l.pattern_bits.size for l in layers)
    return zero / tot
