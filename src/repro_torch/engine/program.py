"""The ``CompiledNetwork`` artifact: what the engine compiler emits.

Port of ``repro/engine/program.py``.  A compiled program is an ordered op
list — one ``CompiledConv`` per conv layer (im2col conv-as-spmm +
norm/ReLU + optional 2x2 maxpool), a global average pool, and a
``CompiledFC`` head — each carrying real kernel operands (a
:class:`~repro_torch.core.sparse.BlockPatternWeight`).  ``executor.py``
runs it, ``serialize.py`` persists it, and
:meth:`CompiledNetwork.hardware_report` prices it on the paper's RRAM
crossbar model through ``core/mapping.map_layer`` +
``core/simulator.simulate_layer_multi``.  The pricing is host numpy
copied from the reference, so every number in a report is bit-equal to
the reference's for the same program.  :meth:`CompiledNetwork.verify`
runs the static verifier (``analysis/verify.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis.ranges import RangeCertificate
from repro_torch.core.crossbar import EnergyModel
from repro_torch.core.mapping import CrossbarConfig, MappingCandidate
from repro_torch.core.patterns import PatternDict
from repro_torch.core.quantize import WEIGHT_BITS, n_cell_slices
from repro_torch.core.simulator import (
    drift_table,
    mapping_cost,
    simulate_layer_multi,
)
from repro_torch.core.sparse import BlockPatternWeight, block_density
from repro_torch.core.synthetic import LayerSpec, SyntheticLayer
from repro_torch.engine.partition import NetworkPartition, tile_assignment
from repro_torch.models.cnn import CNNConfig

__all__ = ["CompiledConv", "CompiledFC", "CompiledNetwork"]


@dataclasses.dataclass
class CompiledConv:
    """One conv layer lowered to an im2col spmm.

    ``bp`` operates on the *padded* matmul view: patches padded from
    ``c_in * kernel**2`` to ``bp.k_in`` rows, outputs padded from ``c_out``
    to ``bp.n_out`` columns (the executor slices the first ``c_out`` back
    out after the inverse permutation).

    ``mapping`` (optional) is the searched per-layer crossbar mapping
    (``compile_network(options=CompileOptions(optimize=...))``,
    ``core/mapsearch.py``): ``hardware_report`` prices the layer at that
    candidate's geometry and packing order.  ``None`` (the fixed scheme,
    and every v1/v2-loaded program) keeps the report-wide defaults.
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
    mapping: MappingCandidate | None = None

    @property
    def k_unpadded(self) -> int:
        return self.c_in * self.kernel * self.kernel


@dataclasses.dataclass
class CompiledFC:
    """The FC head lowered onto the same compressed-spmm path.

    ``reorder`` records the column-reorder strategy the head was lowered
    with (``core/sparse.REORDERS``) — the FC has no crossbar mapping, so
    its searchable space is the reorder alone.
    """

    d_in: int
    d_out: int
    bp: BlockPatternWeight
    bias: np.ndarray  # [d_out]
    reorder: str = "pattern"


@dataclasses.dataclass
class CompiledNetwork:
    """Executable artifact: ordered ops + geometry + hardware pricing.

    ``partition`` (optional) declares how the program is meant to spread
    over several devices (``engine/partition.py``); ``hardware_report``
    derives its per-chip view from it and ``serialize.py`` persists it.

    ``precision`` records the stored weight representation ('fp32', or
    'int8' for per-brick quantized weights + scales) and ``cell_bits``
    the RRAM cell width those weights are sliced over; ``hardware_report``
    prices crossbar area from the *stored* cell-slice count whenever the
    program is quantized.

    ``certificate`` (optional) is the
    :class:`~repro_torch.analysis.ranges.RangeCertificate` the
    certification pass attaches (``compile_network`` with
    ``CompileOptions(verify=...)``, in either package);
    ``hardware_report`` prices it as the ``certified_potential`` section
    and ``serialize.py`` persists it (manifest v4).
    """

    config: CNNConfig
    convs: list[CompiledConv]
    fc: CompiledFC
    block: int
    tile: int
    partition: NetworkPartition | None = None
    precision: str = "fp32"
    cell_bits: int = 4
    certificate: RangeCertificate | None = None

    @property
    def cells_per_weight(self) -> int | None:
        """Cell slices each stored weight occupies: ``ceil(8 / cell_bits)``
        for int8 programs, None for fp32 (no cell slices stored; pricing
        keeps the crossbar model's assumed width)."""
        if self.precision == "int8":
            return n_cell_slices(self.cell_bits)
        return None

    @property
    def num_ops(self) -> int:
        # convs + global-avg-pool + fc
        return len(self.convs) + 2

    def verify(self, strict: bool = False):
        """Run the static program verifier (``analysis/verify.py``).

        Returns the diagnostic
        :class:`~repro_torch.analysis.diagnostics.Report`; with
        ``strict=True`` raises
        :class:`~repro_torch.analysis.diagnostics.VerificationError` when
        any error diagnostic is present.
        """
        from repro_torch.analysis.verify import verify_network

        report = verify_network(self)
        if strict:
            report.raise_if_errors("CompiledNetwork.verify")
        return report

    def op_list(self) -> list[tuple[str, str]]:
        """Human-readable (op, detail) schedule, in execution order."""
        ops = []
        for c in self.convs:
            d = (f"spmm[{c.bp.k_in}x{c.bp.n_out}] "
                 f"density={block_density(c.bp):.2f} + norm/relu")
            if c.pool_after:
                d += " + maxpool2x2"
            ops.append((c.name, d))
        ops.append(("gap", "global average pool"))
        ops.append(("fc", f"spmm[{self.fc.bp.k_in}x{self.fc.bp.n_out}]"))
        return ops

    def weight_bytes(self) -> tuple[int, int]:
        """(compressed, dense-fp32) weight bytes across all spmm ops.

        Compressed bytes use the *stored* element width (1 byte per int8
        weight plus its fp32 row-group scales; 4 bytes per fp32 weight),
        so the quantized storage win is visible next to the dense size.
        """
        comp = dense = 0
        for c in self.convs:
            comp += self._bp_bytes(c.bp)
            dense += c.k_unpadded * c.c_out * 4
        comp += self._bp_bytes(self.fc.bp)
        dense += self.fc.d_in * self.fc.d_out * 4
        return comp, dense

    @staticmethod
    def _bp_bytes(bp) -> int:
        itemsize = bp.w_comp.element_size()
        n = int(np.sum(bp.nnz)) * bp.block * bp.tile * itemsize
        if bp.w_scales is not None:
            n += int(np.sum(bp.nnz)) * 4  # one fp32 scale per stored brick
        return n

    def _synthetic_layers(self) -> list[SyntheticLayer]:
        """The convs as ``SyntheticLayer``s for crossbar-model pricing."""
        layers = []
        for c in self.convs:
            spec = LayerSpec(
                name=c.name,
                c_in=c.c_in,
                c_out=c.c_out,
                out_hw=c.out_hw,
                kernel_size=c.kernel * c.kernel,
            )
            pdict = PatternDict(
                k=spec.kernel_size,
                patterns=tuple(int(b) for b in np.unique(c.pattern_bits)),
            )
            weights = np.zeros(
                (c.c_out, c.c_in, spec.kernel_size), np.float32
            )
            layers.append(SyntheticLayer(
                spec=spec, pdict=pdict,
                pattern_bits=np.asarray(c.pattern_bits, np.int64),
                weights=weights,
            ))
        return layers

    def _chips_view(self, layer_results, model: int, data: int) -> dict:
        """Split per-layer crossbar area/energy/cycles over ``model``
        tile-parallel chips (x ``data`` batch-parallel replicas).

        Each chip's share of a layer is the fraction of that layer's real
        (unpadded) spmm tiles the contiguous assignment hands it
        (``engine/partition.tile_assignment``) — a proportional split of
        the crossbar-model totals, so uneven tile counts show up as chip
        imbalance rather than being averaged away.  ``cycles_parallel``
        is the bottleneck chip; data replicas multiply area, not latency.
        """
        shares = np.zeros((model, len(self.convs)))
        for li, c in enumerate(self.convs):
            t = c.bp.n_tiles
            asg = tile_assignment(t, model)
            shares[:, li] = (asg < t).sum(axis=1) / t

        def split(attr):
            vals = np.array([getattr(r, attr) for r in layer_results])
            return shares @ vals  # [model]

        cb, en, cy = split("ours_crossbars"), split("ours_energy_pj"), \
            split("ours_cycles")
        total_cycles = float(sum(r.ours_cycles for r in layer_results))
        cycles_parallel = float(cy.max()) if model else 0.0
        return {
            "n_chips": model * data,
            "model_shards": model,
            "data_replicas": data,
            "per_chip": [
                {
                    "chip": m,
                    "tile_share": float(shares[m].mean()),
                    "crossbars": float(cb[m]),
                    "energy_pj": float(en[m]),
                    "cycles": float(cy[m]),
                }
                for m in range(model)
            ],
            "crossbars_per_chip_max": float(cb.max()),
            "total_crossbars_all_chips": float(cb.sum()) * data,
            "cycles_parallel": cycles_parallel,
            "parallel_speedup": total_cycles / max(cycles_parallel, 1e-9),
        }

    def _certified_potential(
        self, config: CrossbarConfig, energy: EnergyModel
    ) -> dict:
        """Price what the certificate's min-cell table would unlock.

        Each conv is re-priced via ``core/simulator.mapping_cost`` — the
        exact chain ``hardware_report``'s own rows come from — twice: at
        its effective candidate (the searched mapping, or the reference
        ``config`` as a candidate) and at the same candidate with
        ``cells_per_weight`` replaced by the layer's *certified* cell
        count.  The "current" numbers therefore match the report's layer
        rows bit for bit (zero drift, property-tested), and the deltas
        are the area/energy a variable-cell (MSR-style) lowering of the
        ROADMAP's sub-4-bit item would provably unlock.
        """
        cert = self.certificate
        if self.precision != "int8":
            return {
                "available": False,
                "reason": "range certificates price cell storage; this "
                          "program stores fp32 weights",
            }
        rows = []
        for c in self.convs:
            entry = cert.layer(c.name)
            if entry is None or entry.certified_cells is None:
                continue
            cand = c.mapping if c.mapping is not None else MappingCandidate(
                rows=config.rows,
                cols=config.cols,
                cells_per_weight=config.cells_per_weight,
                ou_rows=config.ou_rows,
                ou_cols=config.ou_cols,
            )
            # an all-zero layer certifies 0 cells; it still occupies one
            # cell per weight in any real lowering
            certified = max(int(entry.certified_cells), 1)
            bits = np.asarray(c.pattern_bits, np.int64)
            windows = c.out_hw * c.out_hw
            ksize = c.kernel * c.kernel
            cur = mapping_cost(bits, cand, windows, ksize, energy)
            new = mapping_cost(
                bits,
                dataclasses.replace(cand, cells_per_weight=certified),
                windows, ksize, energy,
            )
            rows.append({
                "name": c.name,
                "stored_cells": cand.cells_per_weight,
                "certified_cells": certified,
                "area_cells": cur.area_cells,
                "certified_area_cells": new.area_cells,
                "energy_pj": cur.energy_pj,
                "certified_energy_pj": new.energy_pj,
                "cycles": cur.cycles,
                "certified_cycles": new.cycles,
            })
        area = float(sum(r["area_cells"] for r in rows))
        c_area = float(sum(r["certified_area_cells"] for r in rows))
        e_cur = float(sum(r["energy_pj"] for r in rows))
        c_e = float(sum(r["certified_energy_pj"] for r in rows))
        return {
            "available": True,
            "fp32_safe": bool(getattr(cert, "fp32_safe", True)),
            "input_range": [
                float(getattr(cert, "input_lo", 0.0)),
                float(getattr(cert, "input_hi", 0.0)),
            ],
            "layers": rows,
            "area_cells": int(area),
            "certified_area_cells": int(c_area),
            "energy_pj": e_cur,
            "certified_energy_pj": c_e,
            "area_win": area / max(c_area, 1e-9),
            "energy_win": e_cur / max(c_e, 1e-9),
        }

    def hardware_report(
        self,
        config: CrossbarConfig = CrossbarConfig(),
        energy: EnergyModel = EnergyModel(),
        skip_stats=None,
        assumed_skip: float | None = None,
        n_chips: int | None = None,
        observed: dict[str, float] | None = None,
    ) -> dict:
        """Price the compiled convs on the paper's crossbar model.

        Reuses ``core/mapping.map_layer`` (via ``simulate_layer``) on each
        layer's 3x3 pattern bits, so crossbar counts agree exactly with
        ``core/simulator.simulate_dataset`` for the same bits.

        Energy/cycle pricing comes in up to three flavours:

          * the no-skip upper bound (always; the historical ``energy_pj`` /
            ``cycles`` keys are unchanged);
          * *assumed*: a uniform scalar skip probability ``assumed_skip``
            applied to every OU row-group — the fallback when no
            activations have been observed;
          * *measured*: per-(channel, pattern) probabilities counted on
            real activations — pass an
            :class:`~repro_torch.engine.stats.ActivationStats` (from
            ``make_forward(..., collect_stats=True)`` or
            ``InferenceService``) or a mapping of layer name to
            :class:`~repro_torch.core.simulator.SkipDistribution`.

        When both are given, the ``skip`` section reports the
        measured-vs-assumed delta explicitly, so the gap between the
        statistical assumption and the realized zero pattern is a
        first-class output.  Layers without measured statistics fall back
        to the no-skip bound inside the measured totals; the ``skip``
        section's ``measured_layers`` lists which layers were actually
        observed, and per-layer rows only carry ``energy_pj_measured``
        when that layer was.

        ``observed`` maps layer names to *measured* per-layer seconds —
        the ``fn.observed_times()`` of a tracer-instrumented
        ``make_forward`` — and adds a ``drift`` section
        (``core/simulator.drift_table``): each layer's share of total
        predicted cycles vs its share of measured wall time, the
        per-layer drift between the two, and the implied
        seconds-per-cycle spread.  Predicted cycles use the
        measured-skip pricing when ``skip_stats`` is also given (so both
        sides of the comparison describe the same served traffic), else
        the no-skip bound.

        ``n_chips`` adds a ``chips`` section splitting crossbar area /
        energy / cycles over that many tile-parallel devices; with
        ``n_chips=None`` the view is derived from ``self.partition`` when
        the program carries one (model shards x data replicas).

        Mapping: a searched program (``compile_network(optimize=...)``)
        carries a per-layer :class:`~repro_torch.core.mapping.MappingCandidate`
        — those layers are priced at their candidate's crossbar geometry
        and packing order (exactly the ``core/simulator.mapping_cost``
        numbers the search minimized) while the naive baseline stays at
        the reference ``config``.  The ``mapping`` section lists the
        per-layer candidates and the FC reorder; ``area_cells`` /
        ``naive_area_cells`` total crossbar area in *cells*, the unit
        that stays comparable when layers sit on different crossbar dims.

        Cell precision: for an int8 program the crossbar model's
        ``cells_per_weight`` is overridden with the cell-slice count the
        stored weights actually occupy (``ceil(8 / cell_bits)``) — the
        area/energy numbers price what the executor runs, not an assumed
        16-bit width; the ``precision`` section reports which happened.

        Certification: a program carrying a
        :class:`~repro_torch.analysis.ranges.RangeCertificate` additionally
        gets a ``certified_potential`` section — each int8 conv re-priced
        at the *certified* minimum cells-per-weight its row-groups
        provably fit (``core/simulator.mapping_cost``, the same chain as
        the layer rows, so "current" numbers match them exactly) — the
        area/energy win an MSR-style variable-cell lowering would unlock.
        """
        stored_cells = self.cells_per_weight
        if stored_cells is not None and stored_cells != config.cells_per_weight:
            config = dataclasses.replace(
                config, cells_per_weight=stored_cells
            )
        syn = self._synthetic_layers()

        dists = {}
        if skip_stats is not None:
            # ActivationStats (engine/stats.py) or {name: SkipDistribution}
            per_layer = getattr(skip_stats, "layers", skip_stats)
            for c in self.convs:
                entry = per_layer.get(c.name)
                if entry is None:
                    continue
                to_dist = getattr(entry, "to_distribution", None)
                dists[c.name] = to_dist() if to_dist is not None else entry
        measured_windows = max(
            (int(getattr(d, "windows", 0)) for d in dists.values()),
            default=0,
        )

        # one mapping pass per layer, priced under every requested source;
        # a searched layer is priced at its own candidate geometry and
        # packing order, while the naive baseline stays at the reference
        # ``config`` so area ratios compare against the same yardstick
        layers, assumed, measured = [], [], []
        for c, layer in zip(self.convs, syn):
            sources = {"noskip": None}
            if assumed_skip is not None:
                sources["assumed"] = float(assumed_skip)
            if c.name in dists:
                sources["measured"] = dists[c.name]
            if c.mapping is not None:
                priced = simulate_layer_multi(
                    layer, sources, c.mapping.crossbar_config(), energy,
                    block_order=c.mapping.block_order, naive_config=config,
                )
            else:
                priced = simulate_layer_multi(layer, sources, config, energy)
            layers.append(priced["noskip"])
            assumed.append(priced.get("assumed"))
            measured.append(priced.get("measured", priced["noskip"])
                            if skip_stats is not None else None)
        has_assumed = assumed_skip is not None
        has_measured = skip_stats is not None

        def tot(results, attr):
            return float(sum(getattr(r, attr) for r in results))

        layer_rows = []
        for i, r in enumerate(layers):
            row = {
                "name": r.name,
                "crossbars": r.ours_crossbars,
                "naive_crossbars": r.naive_crossbars,
                "area_cells": r.ours_area_cells,
                "naive_area_cells": r.naive_area_cells,
                "energy_pj": r.ours_energy_pj,
                "cycles": r.ours_cycles,
                "utilization": r.utilization,
                "index_bits": r.index_bits,
                "stored_kernels": r.stored_kernels,
                "total_kernels": r.total_kernels,
            }
            if has_assumed:
                row["energy_pj_assumed"] = assumed[i].ours_energy_pj
                row["cycles_assumed"] = assumed[i].ours_cycles
            if self.convs[i].name in dists:
                row["energy_pj_measured"] = measured[i].ours_energy_pj
                row["cycles_measured"] = measured[i].ours_cycles
            layer_rows.append(row)

        rep = {
            "layers": layer_rows,
            "crossbars": int(tot(layers, "ours_crossbars")),
            "naive_crossbars": int(tot(layers, "naive_crossbars")),
            # area in *cells*: the comparable total once searched layers
            # sit on per-layer crossbar dims (a 128x128 crossbar is not a
            # 512x512, so raw crossbar counts stop being commensurable)
            "area_cells": int(tot(layers, "ours_area_cells")),
            "naive_area_cells": int(tot(layers, "naive_area_cells")),
            "area_efficiency": tot(layers, "naive_crossbars")
            / max(tot(layers, "ours_crossbars"), 1.0),
            "energy_pj": tot(layers, "ours_energy_pj"),
            "naive_energy_pj": tot(layers, "naive_energy_pj"),
            "cycles": tot(layers, "ours_cycles"),
            "index_kb": tot(layers, "index_bits") / 8.0 / 1024.0,
        }
        rep["mapping"] = {
            "optimized": any(c.mapping is not None for c in self.convs),
            "per_layer": {
                c.name: (None if c.mapping is None
                         else c.mapping.to_manifest())
                for c in self.convs
            },
            "fc_reorder": self.fc.reorder,
        }
        rep["precision"] = {
            "weights": self.precision,
            "weight_bits": WEIGHT_BITS if self.precision == "int8" else 32,
            "cell_bits": self.cell_bits,
            "cells_per_weight": config.cells_per_weight,
            "derived_from_storage": stored_cells is not None,
        }
        if self.certificate is not None:
            rep["certified_potential"] = self._certified_potential(
                config, energy
            )

        e_noskip = rep["energy_pj"]
        e_assumed = tot(assumed, "ours_energy_pj") if has_assumed else None
        e_measured = tot(measured, "ours_energy_pj") if has_measured else None
        if has_assumed:
            rep["energy_pj_assumed"] = e_assumed
            rep["cycles_assumed"] = tot(assumed, "ours_cycles")
        if has_measured:
            rep["energy_pj_measured"] = e_measured
            rep["cycles_measured"] = tot(measured, "ours_cycles")
        rep["skip"] = {
            "assumed_probability": assumed_skip,
            "measured_windows": measured_windows,
            "measured_layers": sorted(dists),
            "energy_pj_noskip": e_noskip,
            "energy_pj_assumed": e_assumed,
            "energy_pj_measured": e_measured,
            "measured_discount": (
                None if e_measured is None
                else 1.0 - e_measured / max(e_noskip, 1e-9)
            ),
            "measured_vs_assumed_delta_pj": (
                None if e_measured is None or e_assumed is None
                else e_measured - e_assumed
            ),
            "measured_vs_assumed_delta_frac": (
                None if e_measured is None or e_assumed is None
                else (e_measured - e_assumed) / max(e_assumed, 1e-9)
            ),
        }
        if observed:
            # predicted cycles per layer: measured-skip priced when skip
            # statistics exist for the layer, else the no-skip bound
            predicted = {}
            for i, r in enumerate(layers):
                src = measured[i] if self.convs[i].name in dists else r
                predicted[r.name] = src.ours_cycles
            rep["drift"] = drift_table(
                predicted, {k: float(v) for k, v in observed.items()}
            )
        if n_chips is not None:
            rep["chips"] = self._chips_view(layers, int(n_chips), 1)
        elif self.partition is not None:
            rep["chips"] = self._chips_view(
                layers, self.partition.model, self.partition.data
            )
        return rep
