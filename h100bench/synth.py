"""The benchmark's own copy of the Table II network synthesizer.

A frozen copy of ``repro_torch.core.synthetic`` (``synthesize_layer``
and ``synthesize_network`` draw the same numbers from the same seed, bit
for bit; ``tests/test_bench_counts.py`` holds them to it), so a later
change to the program cannot move the networks the benchmark serves.

A run draws its network in two parts:

  * the pattern bits with :func:`network_patterns`: the synthesizer's
    per-layer pattern dictionaries and kernel choices (Table II's
    patterns per layer, sparsity and all-zero ratio) from the
    configuration's fixed ``pattern_seed``, so every run serves the same
    structure and does the same work;
  * the weight values with :func:`device_weights`: one normal draw on
    the device from the run's seed, scaled by ``1/sqrt(fan_in)`` as the
    synthesizer scales them and masked by the bits; zero conv biases and
    a seeded normal FC, as ``chip_smoke.build_model`` makes them (a zero
    FC would tie every logit).
"""

from __future__ import annotations

import dataclasses

import numpy as np

ALL_ZERO = 0  # bitmask of the all-zero pattern

__all__ = [
    "LayerSpec",
    "layer_specs",
    "layer_patterns",
    "synthesize_layer",
    "synthesize_network",
    "network_patterns",
    "device_weights",
]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    c_in: int
    c_out: int
    out_hw: int  # output feature-map side -> windows = out_hw**2
    kernel_size: int = 9


def layer_specs(conv_channels, pool_after, input_hw: int) -> list[LayerSpec]:
    """One spec a conv: stride-1 'same' convs, a 2x2 pool after the
    1-based layers in ``pool_after``."""
    specs, hw = [], input_hw
    for i, (ci, co) in enumerate(conv_channels, start=1):
        specs.append(LayerSpec(f"conv{i}", int(ci), int(co), hw))
        if i in pool_after:
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
    """f_i >= 0 with sum f = nonzero_frac and sum f_i s_i / nonzero_frac
    = target_mean_size, by exponential tilting f_i ~ exp(-lam * s_i)."""
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


def layer_patterns(
    spec: LayerSpec,
    n_patterns: int,
    zero_ratio: float,
    target_sparsity: float,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """(the layer's patterns with the all-zero one first, pattern bits
    ``[C_out, C_in]``): the synthesizer's draws up to the weights."""
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
    return all_pats, bits


def synthesize_layer(
    spec: LayerSpec,
    n_patterns: int,
    zero_ratio: float,
    target_sparsity: float,
    rng: np.random.Generator,
    weight_scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(patterns, bits ``[C_out, C_in]``, weights ``[C_out, C_in, 9]``)
    as the program's synthesizer draws them."""
    k = spec.kernel_size
    all_pats, bits = layer_patterns(spec, n_patterns, zero_ratio,
                                    target_sparsity, rng)
    masks = ((bits[..., None] >> np.arange(k)) & 1).astype(np.float64)
    fan_in = max(spec.c_in * k, 1)
    w = rng.normal(0.0, weight_scale / np.sqrt(fan_in),
                   size=(spec.c_out, spec.c_in, k))
    return all_pats, bits, (w * masks).astype(np.float32)


def synthesize_network(config: dict, seed: int):
    """Every conv layer of ``config`` as the program's
    ``synthesize_network`` makes it from ``seed``: a list of
    ``(spec, patterns, bits, weights)``."""
    t2 = config["table_ii"]
    rng = np.random.default_rng(seed)
    specs = layer_specs(config["conv_channels"], config["pool_after"],
                        config["input_hw"])
    return [
        (spec, *synthesize_layer(
            spec, n_patterns=t2["patterns_per_layer"][i],
            zero_ratio=t2["zero_pattern_ratio"],
            target_sparsity=t2["sparsity"], rng=rng))
        for i, spec in enumerate(specs)
    ]


def network_patterns(config: dict) -> dict[str, np.ndarray]:
    """``{convN: bits [C_out, C_in]}`` drawn from the configuration's
    ``pattern_seed`` with the synthesizer's pattern statistics."""
    t2 = config["table_ii"]
    rng = np.random.default_rng(int(config["pattern_seed"]))
    specs = layer_specs(config["conv_channels"], config["pool_after"],
                        config["input_hw"])
    return {
        spec.name: layer_patterns(
            spec, t2["patterns_per_layer"][i], t2["zero_pattern_ratio"],
            t2["sparsity"], rng)[1]
        for i, spec in enumerate(specs)
    }


def device_weights(config: dict, bits: dict[str, np.ndarray], seed: int,
                   device) -> dict:
    """``{convN: {w, b}, fc: {w, b}}`` float32 tensors on ``device``,
    drawn from ``seed`` by one ``torch.randn`` there: conv weights
    ``[C_out, C_in, 3, 3]`` normal with std ``1/sqrt(9 C_in)`` inside
    their patterns, zero conv biases, FC ``[d_in, classes]`` normal with
    std ``1/sqrt(d_in)`` and FC bias normal with std 0.1."""
    import torch

    k = int(config.get("kernel", 3))
    chans = config["conv_channels"]
    d_in, classes = int(chans[-1][1]), int(config["num_classes"])
    sizes = [int(co) * int(ci) * k * k for ci, co in chans]
    total = sum(sizes) + d_in * classes + classes
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    params, off = {}, 0
    for i, ((ci, co), n) in enumerate(zip(chans, sizes), start=1):
        name = f"conv{i}"
        b = torch.as_tensor(bits[name], dtype=torch.int64, device=device)
        shifts = torch.arange(k * k, device=device)
        mask = ((b[..., None] >> shifts) & 1).to(torch.float32)
        w = z[off:off + n].view(int(co), int(ci), k * k)
        w = w * (1.0 / float(np.sqrt(int(ci) * k * k))) * mask
        params[name] = {
            "w": w.reshape(int(co), int(ci), k, k).contiguous(),
            "b": torch.zeros(int(co), device=device),
        }
        off += n
    fc_w = z[off:off + d_in * classes].view(d_in, classes)
    off += d_in * classes
    params["fc"] = {
        "w": (fc_w * (1.0 / float(np.sqrt(d_in)))).contiguous(),
        "b": (0.1 * z[off:off + classes]).contiguous(),
    }
    return params
