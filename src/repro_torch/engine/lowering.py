"""Lowering: pattern-pruned CNN params -> executable ``CompiledNetwork``.

Port of ``repro/engine/lowering.py``.  Per conv layer the dense weights
``[C_out, C_in, K, K]`` are viewed as the im2col matmul
``[C_in*K*K, C_out]``, zero-padded up to (block, tile)
multiples, and compressed losslessly from their nonzero structure
(``core/sparse.build_block_pattern`` with ``nonzero_block_masks``).  The
FC head is lowered onto the same path.  All of it is host numpy, so the
arrays are bit-equal to the reference compile; the kernel operands then
move to the program's device.

``CompileOptions(optimize=...)`` runs the per-layer crossbar mapping
search (``core/mapsearch.py``, host numpy, seeded) before each conv is
lowered: the chosen candidate's column reorder shapes the operands and
the candidate rides on ``CompiledConv.mapping`` into ``hardware_report``
and the saved manifest.  ``CompileOptions(verify=...)`` runs the static
verifier and, on a structurally sound program, the range certification
pass after lowering (``analysis/verify.py``, ``analysis/ranges.py``,
host numpy): the certificate rides on ``program.certificate``.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.mapping import CrossbarConfig, MappingCandidate
from repro_torch.core.mapsearch import (
    MappingSearchConfig,
    MappingSearchResult,
    choose_fc_reorder,
    search_layer_mapping,
)
from repro_torch.core.patterns import kernel_masks, masks_to_bits
from repro_torch.core.quantize import n_cell_slices, quantize_bp
from repro_torch.core.sparse import (
    BlockPatternWeight,
    build_block_pattern,
    nonzero_block_masks,
)
from repro_torch.device import host_array, resolve_device
from repro_torch.engine.program import CompiledConv, CompiledFC, CompiledNetwork
from repro_torch.models.cnn import CNNConfig
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["EngineConfig", "CompileOptions", "PRECISIONS", "conv_matrix",
           "lower_matrix", "lower_conv", "lower_fc", "conv_mapping_search",
           "compile_network"]

PRECISIONS = ("fp32", "int8")


def _check_geometry(precision: str, cell_bits: int) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    if cell_bits < 1:
        raise ValueError(f"cell_bits must be >= 1, got {cell_bits}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Compile-time geometry of the spmm lowering.

    ``precision`` selects the stored weight representation: 'fp32' or
    'int8' (per-brick symmetric int8 + float32 scales).  ``cell_bits`` is
    the RRAM cell width the int payload is sliced over for pricing; it
    does not change the stored numbers.
    """

    block: int = 128
    tile: int = 128
    precision: str = "fp32"
    cell_bits: int = 4

    def __post_init__(self):
        _check_geometry(self.precision, self.cell_bits)


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Everything :func:`compile_network` accepts beyond the network itself.

    The geometry fields mirror :class:`EngineConfig`.  ``tracer`` records
    compile spans.  ``optimize`` is ``None`` (the paper's fixed scheme),
    ``'auto'`` (the default :class:`MappingSearchConfig`) or a
    :class:`MappingSearchConfig`.  ``verify`` is ``None`` (skip the
    static passes), ``'warn'`` or ``'strict'`` (see
    :func:`compile_network`).
    """

    block: int = 128
    tile: int = 128
    precision: str = "fp32"
    cell_bits: int = 4
    verify: str | None = None
    optimize: "str | MappingSearchConfig | None" = None
    tracer: Tracer | None = None

    def __post_init__(self):
        _check_geometry(self.precision, self.cell_bits)
        if self.verify not in (None, "warn", "strict"):
            raise ValueError(
                f"verify must be None, 'warn' or 'strict', got "
                f"{self.verify!r}"
            )
        if self.optimize is not None and self.optimize != "auto" and not (
            isinstance(self.optimize, MappingSearchConfig)
        ):
            raise ValueError(
                f"optimize must be None, 'auto' or a MappingSearchConfig, "
                f"got {self.optimize!r}"
            )

    @classmethod
    def from_engine_config(cls, ecfg: EngineConfig, **kw) -> "CompileOptions":
        """Lift a lowering geometry into full compile options."""
        return cls(block=ecfg.block, tile=ecfg.tile,
                   precision=ecfg.precision, cell_bits=ecfg.cell_bits, **kw)

    def engine_config(self) -> EngineConfig:
        """The :class:`EngineConfig` these options imply."""
        return EngineConfig(block=self.block, tile=self.tile,
                            precision=self.precision,
                            cell_bits=self.cell_bits)


def _pad_axis(a: np.ndarray, axis: int, mult: int) -> np.ndarray:
    pad = (-a.shape[axis]) % mult
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


def conv_matrix(w: np.ndarray) -> np.ndarray:
    """[C_out, C_in, Kh, Kw] -> im2col matmul view [C_in*Kh*Kw, C_out].

    Row index is ``c * Kh*Kw + (dy*Kw + dx)`` — the patch layout the
    executor extracts.
    """
    w = np.asarray(w)
    co = w.shape[0]
    return w.reshape(co, -1).T


def lower_matrix(
    wm: np.ndarray, block: int, tile: int, precision: str = "fp32",
    tracer: Tracer | None = None, reorder: str = "pattern",
    device: str | torch.device = "cpu",
) -> BlockPatternWeight:
    """Pad a dense [K, N] matrix to (block, tile) multiples and compress it
    losslessly from its nonzero structure; ``precision='int8'`` then
    quantizes the bricks.  ``reorder`` picks the column-permutation
    strategy (``core/sparse.REORDERS``)."""
    _check_geometry(precision, 1)
    tracer = tracer or NULL_TRACER
    wp = _pad_axis(_pad_axis(np.asarray(wm, np.float32), 0, block), 1, tile)
    with tracer.span("prune", cat="compile", shape=list(wp.shape)):
        masks = nonzero_block_masks(wp, block)
    bp = build_block_pattern(wp, block=block, tile=tile, masks=masks,
                             tracer=tracer, reorder=reorder, device=device)
    if precision == "int8":
        with tracer.span("quantize", cat="compile", shape=list(wp.shape)):
            bp = quantize_bp(bp)
    return bp


def lower_conv(
    name: str,
    w,
    b,
    pattern_bits: np.ndarray | None,
    out_hw: int,
    pool_after: bool,
    ecfg: EngineConfig,
    tracer: Tracer | None = None,
    device: str | torch.device = "cpu",
    mapping: MappingCandidate | None = None,
) -> CompiledConv:
    w = host_array(w).astype(np.float32)
    c_out, c_in, kh, kw = w.shape
    if kh != kw:
        raise ValueError(f"{name}: non-square kernel {kh}x{kw}")
    if pattern_bits is None:
        pattern_bits = masks_to_bits(kernel_masks(w))
    reorder = mapping.reorder if mapping is not None else "pattern"
    return CompiledConv(
        name=name,
        c_in=c_in,
        c_out=c_out,
        kernel=kh,
        out_hw=out_hw,
        pool_after=pool_after,
        bp=lower_matrix(conv_matrix(w), ecfg.block, ecfg.tile,
                        ecfg.precision, tracer=tracer, reorder=reorder,
                        device=device),
        bias=host_array(b).astype(np.float32).copy(),
        pattern_bits=np.asarray(host_array(pattern_bits), np.int64).copy(),
        mapping=mapping,
    )


def lower_fc(
    w, b, ecfg: EngineConfig, tracer: Tracer | None = None,
    reorder: str = "pattern", device: str | torch.device = "cpu",
) -> CompiledFC:
    w = host_array(w).astype(np.float32)
    d_in, d_out = w.shape
    return CompiledFC(
        d_in=d_in,
        d_out=d_out,
        bp=lower_matrix(w, ecfg.block, ecfg.tile, ecfg.precision,
                        tracer=tracer, reorder=reorder, device=device),
        bias=host_array(b).astype(np.float32).copy(),
        reorder=reorder,
    )


def _fixed_candidate(ecfg: EngineConfig) -> MappingCandidate:
    """The fixed scheme a search must match-or-beat: the paper's default
    geometry, with cells/weight derived from the program's precision the
    same way ``hardware_report`` derives it."""
    base = CrossbarConfig()
    cells = (
        n_cell_slices(ecfg.cell_bits)
        if ecfg.precision == "int8"
        else base.cells_per_weight
    )
    return MappingCandidate(
        rows=base.rows,
        cols=base.cols,
        cells_per_weight=cells,
        ou_rows=base.ou_rows,
        ou_cols=base.ou_cols,
    )


def conv_mapping_search(
    w,
    pattern_bits: np.ndarray | None,
    out_hw: int,
    ecfg: EngineConfig = EngineConfig(),
    search: MappingSearchConfig | None = None,
) -> MappingSearchResult:
    """Run the mapping design-space search for one conv layer.

    Builds exactly the search inputs ``compile_network(optimize=...)``
    uses — the layer's pattern bits, the padded matmul view's block
    masks, the precision-derived fixed scheme — and returns the full
    :class:`~repro_torch.core.mapsearch.MappingSearchResult`.
    """
    w = host_array(w).astype(np.float32)
    if pattern_bits is None:
        pattern_bits = masks_to_bits(kernel_masks(w))
    kernel_size = w.shape[2] * w.shape[3]
    wp = _pad_axis(
        _pad_axis(conv_matrix(w), 0, ecfg.block), 1, ecfg.tile
    )
    masks = nonzero_block_masks(wp, ecfg.block)
    return search_layer_mapping(
        np.asarray(host_array(pattern_bits), np.int64),
        kernel_size=kernel_size,
        windows=out_hw * out_hw,
        fixed=_fixed_candidate(ecfg),
        search=search,
        masks=masks,
        tile=ecfg.tile,
    )


def compile_network(
    cfg: CNNConfig,
    params: dict,
    pattern_bits: dict[str, np.ndarray] | None = None,
    *,
    options: CompileOptions | None = None,
    device: str | torch.device | None = None,
) -> CompiledNetwork:
    """Lower a (pruned) CNN end-to-end into a :class:`CompiledNetwork`.

    Args:
      cfg: network geometry (``models.cnn.CNNConfig``).
      params: ``{conv1: {w, b}, ..., fc: {w, b}}`` of tensors or arrays.
      pattern_bits: per-conv packed 3x3 pattern bitmasks; recovered from
        the weights' nonzero structure for layers not listed.
      options: a :class:`CompileOptions` (geometry, precision, tracer,
        mapping search, verification).  With a tracer the compile is a
        ``compile_network`` span holding one ``lower:<name>`` span per
        layer, and with ``optimize`` one ``search:<name>`` span before
        each (``args``: evaluations, improved, the chosen candidate, its
        area and the fixed scheme's) and a ``search:fc`` span (the chosen
        reorder and the bricks of every strategy).  With ``verify`` the
        static verifier runs as a ``verify`` span and, when it finds no
        error, the range certification pass as a ``ranges`` span
        (``args``: ``fp32_safe``, ``certified_cells``); V5xx diagnostics
        join the same report and the certificate is attached as
        ``program.certificate``.  ``'strict'`` raises
        :class:`~repro_torch.analysis.diagnostics.VerificationError` on
        any error diagnostic, ``'warn'`` emits a Python warning instead.
      device: where the kernel operands live; ``None`` means ``cuda``
        and raises when there is none.
    """
    device = resolve_device(device)
    options = options or CompileOptions()
    ecfg = options.engine_config()
    if isinstance(options.optimize, MappingSearchConfig):
        search_cfg = options.optimize
    elif options.optimize == "auto":
        search_cfg = MappingSearchConfig()
    else:
        search_cfg = None
    tracer = options.tracer or NULL_TRACER
    pattern_bits = pattern_bits or {}
    convs = []
    hw = cfg.input_hw
    with tracer.span(
        "compile_network", cat="compile",
        layers=cfg.num_convs + 1, precision=ecfg.precision,
        optimize=search_cfg is not None,
    ):
        for i in range(1, cfg.num_convs + 1):
            name = f"conv{i}"
            pool = i in cfg.pool_after
            mapping = None
            if search_cfg is not None:
                with tracer.span(f"search:{name}", cat="compile") as sp:
                    res = conv_mapping_search(
                        params[name]["w"], pattern_bits.get(name), hw,
                        ecfg, search_cfg,
                    )
                    mapping = res.chosen
                    sp.args.update(
                        evaluations=res.evaluations,
                        improved=res.improved,
                        chosen=mapping.to_manifest(),
                        area_cells=res.cost.area_cells,
                        fixed_area_cells=res.fixed_cost.area_cells,
                    )
            with tracer.span(f"lower:{name}", cat="compile"):
                convs.append(
                    lower_conv(
                        name,
                        params[name]["w"],
                        params[name]["b"],
                        pattern_bits.get(name),
                        out_hw=hw,
                        pool_after=pool,
                        ecfg=ecfg,
                        tracer=tracer,
                        device=device,
                        mapping=mapping,
                    )
                )
            if pool:
                hw //= 2
        fc_reorder = "pattern"
        if search_cfg is not None:
            with tracer.span("search:fc", cat="compile") as sp:
                wfc = _pad_axis(
                    _pad_axis(host_array(params["fc"]["w"]).astype(np.float32),
                              0, ecfg.block),
                    1, ecfg.tile,
                )
                fc_reorder, counts = choose_fc_reorder(
                    nonzero_block_masks(wfc, ecfg.block),
                    ecfg.tile, search_cfg.reorders,
                )
                sp.args.update(chosen=fc_reorder, bricks=counts)
        with tracer.span("lower:fc", cat="compile"):
            fc = lower_fc(params["fc"]["w"], params["fc"]["b"], ecfg,
                          tracer=tracer, reorder=fc_reorder, device=device)
    program = CompiledNetwork(
        config=cfg, convs=convs, fc=fc, block=ecfg.block, tile=ecfg.tile,
        precision=ecfg.precision, cell_bits=ecfg.cell_bits,
    )
    if options.verify is not None:
        from repro_torch.analysis.ranges import analyze_network
        from repro_torch.analysis.verify import verify_network

        with tracer.span("verify", cat="compile"):
            report = verify_network(program)
        # the range certification pass only runs over structurally sound
        # programs (its interval math assumes the verifier's contracts)
        if report.ok:
            with tracer.span("ranges", cat="compile") as sp:
                report, cert = analyze_network(program, report=report)
                program.certificate = cert
                sp.args.update(
                    fp32_safe=cert.fp32_safe,
                    certified_cells=cert.certified_cells(),
                )
        if options.verify == "strict":
            report.raise_if_errors("compile_network")
        elif not report.ok:
            warnings.warn(
                "compile_network produced a program that fails "
                "verification:\n" + report.format(),
                stacklevel=2,
            )
    return program
