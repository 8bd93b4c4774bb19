"""End-to-end accelerator simulation: area / energy / cycles (paper §V).

Copied from ``repro/core/simulator.py``: host numpy, so every number it
produces is bit-equal to the reference's.

Compares, per layer and aggregated:

  naive   — Fig-1 mapping (filters as columns, zeros stored), OU mechanism,
            no input preprocessing -> no activation-sparsity skipping.
  pattern — kernel-reordering mapping (this paper): compressed pattern
            blocks, OU limited to a block, input preprocessing selects only
            the pattern's activations and skips all-zero selections.

Metrics:
  area   — crossbar count (Fig 7: 'crossbar array numbers').
  energy — sum over OU activations of Table-I component energies, weighted
           by windows and by the expected non-skip probability (Fig 8).
  cycles — layers execute sequentially, crossbars within a layer in
           parallel, one OU activation per crossbar per cycle: cycles =
           windows * max over crossbars of expected OU activations (§V-C).

Activation zero statistics come from an actual forward pass of the network
(im2col convs + ReLU, unit-variance renormalisation standing in for BN),
sampled at ``n_windows`` output positions per layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.crossbar import EnergyModel
from repro_torch.core.indexing import build_index_stream, index_overhead_bits
from repro_torch.core.mapping import (
    CrossbarConfig,
    MappingCandidate,
    map_layer,
    map_layer_naive,
)
from repro_torch.core.ou import OUSchedule, naive_ou_schedule, pattern_ou_schedule
from repro_torch.core.patterns import bits_to_mask
from repro_torch.core.synthetic import (
    SyntheticLayer,
    TABLE_II,
    synthesize_network,
)

__all__ = [
    "LayerResult",
    "MappingCost",
    "SimulationReport",
    "SkipDistribution",
    "drift_table",
    "mapping_cost",
    "simulate_layer",
    "simulate_layer_multi",
    "simulate_network",
    "simulate_dataset",
    "forward_zero_stats",
]


# ---------------------------------------------------------------------------
# activation statistics
# ---------------------------------------------------------------------------


def _im2col(x: np.ndarray, k: int = 3, pad: int = 1) -> np.ndarray:
    """x: [B, C, H, W] -> patches [B, H, W, C, k*k] (stride 1, 'same')."""
    b, c, h, w = x.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    out = np.empty((b, h, w, c, k * k), dtype=x.dtype)
    idx = 0
    for dy in range(k):
        for dx in range(k):
            out[..., idx] = xp[:, :, dy : dy + h, dx : dx + w].transpose(0, 2, 3, 1)
            idx += 1
    return out


def forward_zero_stats(
    layers: list[SyntheticLayer],
    input_hw: int,
    batch: int = 2,
    n_windows: int = 256,
    seed: int = 0,
) -> list[np.ndarray]:
    """Forward random inputs through the synthetic net; return, per layer,
    a boolean zero-indicator array [n_windows, C_in, 9] over sampled output
    positions of that layer's input patches."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, layers[0].spec.c_in, input_hw, input_hw)).astype(
        np.float32
    )
    # first layer input is an image: no ReLU zeros, but keep the real stats
    stats: list[np.ndarray] = []
    hw = input_hw
    for i, layer in enumerate(layers):
        spec = layer.spec
        patches = _im2col(x)  # [B, H, W, C, 9]
        b, h, w_, c, kk = patches.shape
        flat = patches.reshape(b * h * w_, c, kk)
        take = min(n_windows, flat.shape[0])
        sel = rng.choice(flat.shape[0], size=take, replace=False)
        stats.append(flat[sel] == 0.0)

        wmat = layer.weights.reshape(spec.c_out, spec.c_in * kk).T  # [C*9, C_out]
        y = flat.reshape(b * h * w_, c * kk) @ wmat
        y = y.reshape(b, h, w_, spec.c_out).transpose(0, 3, 1, 2)
        std = y.std()
        y = y / (std if std > 0 else 1.0)  # BN stand-in
        y = np.maximum(y, 0.0)  # ReLU
        # pool when the *next* layer's spatial size shrinks
        if i + 1 < len(layers) and layers[i + 1].spec.out_hw < spec.out_hw:
            b2, c2, h2, w2 = y.shape
            y = y[:, :, : h2 // 2 * 2, : w2 // 2 * 2]
            y = y.reshape(b2, c2, h2 // 2, 2, w2 // 2, 2).max(axis=(3, 5))
        x = y.astype(np.float32)
        hw = x.shape[-1]
    return stats


@dataclasses.dataclass
class SkipDistribution:
    """Empirical all-zero-input-selection probabilities per OU row-group.

    ``probs[(channel, pattern)]`` is the measured probability that the
    input selection feeding an OU of that (channel, pattern bitmask) pair
    is entirely zero — e.g. counted by the inference engine on real served
    activations (``engine/stats.py``).  ``windows`` records the sample
    size; pairs not measured fall back to ``default`` (an *assumed*
    probability; 0.0 keeps the no-skip upper bound).
    """

    probs: dict[tuple[int, int], float] = dataclasses.field(
        default_factory=dict
    )
    windows: int = 0
    default: float = 0.0

    def fraction(self, channel: int, pattern: int) -> float:
        return float(
            self.probs.get((int(channel), int(pattern)), self.default)
        )


def _skip_fractions(
    sched: OUSchedule, zero_ind: "np.ndarray | SkipDistribution | float | None"
) -> np.ndarray:
    """Expected all-zero-input fraction per OU (0 if no stats / channel=-1).

    ``zero_ind`` selects the skip-probability source:
      * None            — no skipping (upper-bound energy);
      * float p         — *assumed* uniform probability p for every
                          channel-attributed OU;
      * SkipDistribution — *measured* per-(channel, pattern) probabilities;
      * ndarray [W,C,k] — boolean zero indicators from a sampled forward
                          pass (``forward_zero_stats``).
    """
    n = len(sched)
    if zero_ind is None or n == 0:
        return np.zeros(n)
    if isinstance(zero_ind, (int, float, np.integer, np.floating)):
        return np.where(sched.channel >= 0, float(zero_ind), 0.0)
    if isinstance(zero_ind, SkipDistribution):
        skip = np.zeros(n)
        for i in range(n):
            ch = int(sched.channel[i])
            if ch < 0:
                continue
            skip[i] = zero_ind.fraction(ch, int(sched.pattern[i]))
        return skip
    skip = np.zeros(n)
    # group by (channel, pattern) — few unique pairs per layer
    pairs = {}
    for i in range(n):
        ch, pat = int(sched.channel[i]), int(sched.pattern[i])
        if ch < 0:
            continue
        pairs.setdefault((ch, pat), []).append(i)
    k = zero_ind.shape[-1]
    for (ch, pat), idxs in pairs.items():
        if ch >= zero_ind.shape[1]:
            continue
        pos = np.nonzero(bits_to_mask(pat, k))[0]
        if pos.size == 0:
            frac = 1.0
        else:
            frac = float(np.all(zero_ind[:, ch, pos], axis=1).mean())
        skip[idxs] = frac
    return skip


# ---------------------------------------------------------------------------
# per-layer simulation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerResult:
    name: str
    windows: int
    naive_crossbars: int
    ours_crossbars: int
    naive_energy_pj: float
    ours_energy_pj: float
    naive_cycles: float
    ours_cycles: float
    naive_breakdown: dict[str, float]
    ours_breakdown: dict[str, float]
    index_bits: int
    stored_kernels: int
    total_kernels: int
    utilization: float
    # crossbar area in *cells* — the comparable unit once per-layer
    # crossbar dims differ (a searched 128x128 crossbar is not a 512x512)
    naive_area_cells: int = 0
    ours_area_cells: int = 0


def _sched_energy_cycles(
    sched: OUSchedule,
    skip: np.ndarray,
    windows: int,
    energy: EnergyModel,
) -> tuple[float, float, dict[str, float]]:
    live = 1.0 - skip
    e_per = energy.ou_energy(sched.wordlines, sched.bitlines)
    total_e = float((e_per * live).sum()) * windows
    breakdown = energy.breakdown(sched.wordlines, sched.bitlines, live)
    breakdown = {k: v * windows for k, v in breakdown.items()}
    if len(sched) == 0:
        return 0.0, 0.0, breakdown
    per_xbar = np.bincount(
        sched.crossbar, weights=live, minlength=sched.num_crossbars
    )
    cycles = float(per_xbar.max()) * windows
    return total_e, cycles, breakdown


def simulate_layer_multi(
    layer: SyntheticLayer,
    skip_sources: dict,
    config: CrossbarConfig = CrossbarConfig(),
    energy: EnergyModel = EnergyModel(),
    naive_skips: bool = False,
    block_order: str = "pattern",
    naive_config: CrossbarConfig | None = None,
) -> dict[str, LayerResult]:
    """Price one layer under several skip-probability sources at once.

    Mapping, OU schedules and the index stream depend only on the pattern
    bits, so they are computed once and re-priced per entry of
    ``skip_sources`` (name -> any ``_skip_fractions`` source) — pricing a
    layer no-skip/assumed/measured costs one ``map_layer``, not three.

    ``block_order`` is forwarded to ``map_layer`` (the pattern-pruned
    side only).  ``naive_config`` prices the Fig-1 baseline at a
    different geometry than ``config`` — when a searched per-layer
    mapping shrinks the crossbar, the naive comparison must stay at the
    *reference* geometry or the area-efficiency ratio silently inflates;
    ``None`` keeps both sides on ``config`` (the historical behaviour).
    """
    spec = layer.spec
    windows = spec.out_hw * spec.out_hw

    mapping = map_layer(layer.pattern_bits, config, spec.kernel_size,
                        block_order)
    sched_ours = pattern_ou_schedule(mapping)
    naive = map_layer_naive(spec.c_out, spec.c_in, spec.kernel_size,
                            naive_config if naive_config is not None
                            else config)
    sched_nv = naive_ou_schedule(naive)
    stream = build_index_stream(mapping)
    idx = index_overhead_bits(stream)

    out = {}
    for key, zero_ind in skip_sources.items():
        skip_ours = _skip_fractions(sched_ours, zero_ind)
        e_ours, cyc_ours, bd_ours = _sched_energy_cycles(
            sched_ours, skip_ours, windows, energy
        )
        skip_nv = (
            _skip_fractions(sched_nv, zero_ind)
            if naive_skips
            else np.zeros(len(sched_nv))
        )
        e_nv, cyc_nv, bd_nv = _sched_energy_cycles(
            sched_nv, skip_nv, windows, energy
        )
        out[key] = LayerResult(
            name=spec.name,
            windows=windows,
            naive_crossbars=naive.num_crossbars,
            ours_crossbars=mapping.num_crossbars,
            naive_energy_pj=e_nv,
            ours_energy_pj=e_ours,
            naive_cycles=cyc_nv,
            ours_cycles=cyc_ours,
            naive_breakdown=bd_nv,
            ours_breakdown=bd_ours,
            index_bits=idx["total_bits"],
            stored_kernels=mapping.stored_kernels,
            total_kernels=mapping.total_kernels,
            utilization=mapping.utilization,
            naive_area_cells=naive.cells_total,
            ours_area_cells=mapping.cells_total,
        )
    return out


# ---------------------------------------------------------------------------
# mapping cost model (design-space search)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MappingCost:
    """Predicted hardware cost of one :class:`MappingCandidate`.

    Produced by :func:`mapping_cost` through the *same* pricing chain as
    :func:`simulate_layer_multi` (``map_layer`` → ``pattern_ou_schedule``
    → ``_sched_energy_cycles``), so every number here equals the
    simulator's no-skip pricing of the realized mapping bit-for-bit —
    the property suite asserts zero drift, not a tolerance.
    """

    crossbars: int
    area_cells: int
    energy_pj: float
    cycles: float
    utilization: float


def mapping_cost(
    pattern_bits: np.ndarray,
    candidate: MappingCandidate,
    windows: int,
    kernel_size: int = 9,
    energy: EnergyModel = EnergyModel(),
) -> MappingCost:
    """Price ``candidate`` on a layer's pattern bits without skipping.

    This is the pure cost model the mapping search minimizes.  It is the
    no-skip (upper bound) pricing: search must not depend on activation
    statistics, which vary per served batch, or the chosen mapping would
    not be a compile-time constant.
    """
    cfg = candidate.crossbar_config()
    mapping = map_layer(pattern_bits, cfg, kernel_size,
                        candidate.block_order)
    sched = pattern_ou_schedule(mapping)
    e, cyc, _ = _sched_energy_cycles(
        sched, np.zeros(len(sched)), windows, energy
    )
    return MappingCost(
        crossbars=mapping.num_crossbars,
        area_cells=mapping.cells_total,
        energy_pj=e,
        cycles=cyc,
        utilization=mapping.utilization,
    )


def drift_table(
    predicted_cycles: dict[str, float],
    measured_s: dict[str, float],
) -> dict:
    """Predicted-vs-measured cost drift across layers.

    The simulator predicts per-layer *cycles*; the instrumented executor
    measures per-layer *seconds* — incommensurable units, so the honest
    comparison is each layer's **share** of the network total: a perfect
    cost model assigns every layer the same fraction of predicted cycles
    as of measured wall time.  Per layer the table reports both shares,
    their difference (``share_drift``, positive = the layer is more
    expensive in reality than predicted), and the implied seconds/cycle
    rate; the summary's ``rate_spread`` (max/min implied rate over
    layers) is 1.0 exactly when prediction and measurement are
    proportional, and grows with model error.  This is the trust signal
    a mapping optimizer needs before it searches over simulator pricing.

    Layers present on only one side are listed (``unmeasured`` /
    ``unpredicted``) rather than silently dropped.
    """
    common = [n for n in predicted_cycles if n in measured_s]
    tot_p = sum(float(predicted_cycles[n]) for n in common)
    tot_m = sum(float(measured_s[n]) for n in common)
    rows = []
    for name in common:
        pred = float(predicted_cycles[name])
        meas = float(measured_s[name])
        p_share = pred / tot_p if tot_p > 0 else 0.0
        m_share = meas / tot_m if tot_m > 0 else 0.0
        rows.append(
            {
                "name": name,
                "predicted_cycles": pred,
                "measured_s": meas,
                "predicted_share": p_share,
                "measured_share": m_share,
                "share_drift": m_share - p_share,
                "s_per_cycle": meas / pred if pred > 0 else None,
            }
        )
    rates = [r["s_per_cycle"] for r in rows if r["s_per_cycle"]]
    drifts = [abs(r["share_drift"]) for r in rows]
    return {
        "layers": rows,
        "max_abs_share_drift": max(drifts, default=0.0),
        "mean_abs_share_drift": (
            sum(drifts) / len(drifts) if drifts else 0.0
        ),
        "rate_spread": (max(rates) / min(rates)) if rates else None,
        "unmeasured": sorted(set(predicted_cycles) - set(measured_s)),
        "unpredicted": sorted(set(measured_s) - set(predicted_cycles)),
    }


def simulate_layer(
    layer: SyntheticLayer,
    zero_ind: "np.ndarray | SkipDistribution | float | None",
    config: CrossbarConfig = CrossbarConfig(),
    energy: EnergyModel = EnergyModel(),
    naive_skips: bool = False,
) -> LayerResult:
    return simulate_layer_multi(
        layer, {"_": zero_ind}, config, energy, naive_skips
    )["_"]


@dataclasses.dataclass
class SimulationReport:
    dataset: str
    layers: list[LayerResult]

    def _sum(self, attr: str) -> float:
        return float(sum(getattr(l, attr) for l in self.layers))

    @property
    def area_efficiency(self) -> float:
        return self._sum("naive_crossbars") / max(self._sum("ours_crossbars"), 1)

    @property
    def crossbar_savings(self) -> float:
        return 1.0 - self._sum("ours_crossbars") / max(
            self._sum("naive_crossbars"), 1
        )

    @property
    def energy_efficiency(self) -> float:
        return self._sum("naive_energy_pj") / max(self._sum("ours_energy_pj"), 1e-9)

    @property
    def speedup(self) -> float:
        return self._sum("naive_cycles") / max(self._sum("ours_cycles"), 1e-9)

    @property
    def index_overhead_kb(self) -> float:
        return self._sum("index_bits") / 8.0 / 1024.0

    def breakdown(self, which: str) -> dict[str, float]:
        out: dict[str, float] = {}
        for l in self.layers:
            for k, v in getattr(l, f"{which}_breakdown").items():
                out[k] = out.get(k, 0.0) + v
        return out

    def summary(self) -> dict[str, float]:
        return {
            "area_efficiency": self.area_efficiency,
            "crossbar_savings": self.crossbar_savings,
            "energy_efficiency": self.energy_efficiency,
            "speedup": self.speedup,
            "index_overhead_kb": self.index_overhead_kb,
            "naive_crossbars": self._sum("naive_crossbars"),
            "ours_crossbars": self._sum("ours_crossbars"),
        }


def simulate_network(
    dataset: str,
    layers: list[SyntheticLayer],
    input_hw: int,
    config: CrossbarConfig = CrossbarConfig(),
    energy: EnergyModel = EnergyModel(),
    naive_skips: bool = False,
    n_windows: int = 256,
    stats_hw: int | None = None,
    batch: int = 2,
    seed: int = 0,
) -> SimulationReport:
    """Simulate all layers; ``stats_hw`` can downscale the forward pass used
    for activation statistics (window *counts* always use the true size)."""
    stats = forward_zero_stats(
        layers, stats_hw or input_hw, batch=batch, n_windows=n_windows, seed=seed
    )
    results = [
        simulate_layer(layer, zi, config, energy, naive_skips)
        for layer, zi in zip(layers, stats)
    ]
    return SimulationReport(dataset=dataset, layers=results)


def simulate_dataset(
    dataset: str,
    seed: int = 0,
    naive_skips: bool = False,
    config: CrossbarConfig = CrossbarConfig(),
    stats_hw: int | None = None,
) -> SimulationReport:
    """Synthesize the Table-II-matched network for ``dataset`` and simulate."""
    stats, layers = synthesize_network(dataset, seed=seed)
    if stats_hw is None and dataset == "imagenet":
        stats_hw = 112  # forward-pass downscale for CPU time; counts use 224
    return simulate_network(
        dataset,
        layers,
        stats.input_hw,
        config=config,
        naive_skips=naive_skips,
        stats_hw=stats_hw,
        batch=1 if dataset == "imagenet" else 2,
        seed=seed,
    )
