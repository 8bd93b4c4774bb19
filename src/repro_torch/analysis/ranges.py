"""Static value-range & bit-width certification for compiled programs.

Port of ``repro/analysis/ranges.py``: the data types, their manifest
round trip (format v4's ``certificate`` entry) and the interval pass,
all float64 numpy over the stored payloads, so a certificate equals the
reference's bit for bit.  The port's operands hold ``w_comp`` and
``w_scales`` as tensors; the pass reads each to the host once.

An execution-free abstract interpreter over
:class:`~repro_torch.engine.program.CompiledNetwork`: starting from a declared
input interval it pushes interval bounds through every op of the
compiled schedule — conv-as-spmm + bias, ``channel_norm``, ReLU, 2x2
maxpool, global average pool, the FC head — and, for quantized
programs, derives activation-independent worst-case extrema of the int8
spmm's accumulators straight from the stored bricks and scales.  Where
``analysis/verify.py`` proves the program is *structurally* sound (the
arrays mean what the executor assumes), this pass proves *semantic*
facts about the values the program can produce.

Interval semantics (all arithmetic in float64 over the stored payloads;
quantized operands are interpreted through their dequantized effective
weights ``w_comp * w_scales``, and activation quantization widens the
interval by the half-step round-off ``amax / (2 * QMAX)``):

* spmm + bias: per output column ``j``,
  ``hi_j = b_j + hi * sum(pos w_j) + lo * sum(neg w_j)`` (and dually for
  ``lo_j``) — exact for a matmul over a scalar input interval.
* ``channel_norm``: the divisor ``std + eps`` lies in ``[eps, inf)``, so
  the sound image of ``[lo, hi]`` is ``[min(lo, 0)/eps, max(hi, 0)/eps]``
  (the ``hi/eps`` endpoint is *attained* by a constant feature map, so no
  tighter activation-independent bound exists).  This grows bounds by up
  to ``1/eps`` per layer: deep stacks certifiably exceed the fp32 range
  under adversarial inputs, which the certificate records as
  ``fp32_safe`` and a V504 warning rather than an error — only
  non-finite (genuinely divergent) bounds are an error.
* ReLU / maxpool / global average pool map ``[lo, hi]`` to
  ``[max(lo, 0), max(hi, 0)]`` / identity / identity.

Accumulator model (int8 path, mirrors
``core/sparse.pattern_spmm_torch_quant``): each scan step contracts one
brick's ``block`` rows in int32 (``|qx| <= QMAX``), so the int32 partial
is bounded by ``QMAX * max column abs-sum per brick``; the fp32
accumulator folds per-brick scales, so its pre-epilogue bound is
``max_j sum_k s_k * QMAX * colsum_k(j)`` — both are activation
independent and V501 proves them inside their types.

Rules (same :class:`~repro_torch.analysis.diagnostics.Report` currency as the
verifier; V5xx extends its V1xx-V4xx families):

=====  =================================================================
rule   semantic guarantee
=====  =================================================================
V501   accumulator-overflow proof: the worst-case int32 spmm partial
       stays below 2**31 and the scale-folded fp32 accumulator stays
       finite (error when not provable)
V502   scale saturation (``s * QMAX`` overflows fp32) or denormal
       (``0 < s <`` the smallest normal fp32) — silent precision loss
V503   dead-scale group: an active brick with scale 0 over nonzero
       stored weights dequantizes a whole OU row-group to zero (warning;
       the structural twin of verify's V112 error)
V504   activation-range divergence: non-finite certified bounds are an
       error; bounds that certifiably exceed the fp32 range under
       worst-case normalisation are a warning (``fp32_safe=False``)
V505   unreachable cell slices: the certified per-layer cell count is
       below the stored ``n_cell_slices`` — the top slice(s) are
       provably zero operand-wide (warning)
V506   a stored certificate disagrees with recomputation from the
       payloads (stale or corrupted manifest entry)
=====  =================================================================

The :class:`RangeCertificate` payload carries, per layer, the certified
activation interval, the accumulator extrema, and a per-OU-row-group
**certified minimum cells-per-weight** table: each brick's magnitude is
re-expressed on the layer's operand-uniform reference grid (the step of
the largest per-brick scale) and mapped through
:func:`~repro_torch.core.quantize.cells_for_magnitude` — exactly the input the
MSR-style variable-cell lowering (ROADMAP "Sub-4-bit cells") needs, and
what ``hardware_report()`` prices as its ``certified_potential``
section.  The certificate is pure numpy over the stored arrays, hence
bit-deterministic across processes, and rides in manifest v4
(``engine/serialize.py``).

Entry points mirror the verifier's: :func:`analyze_network` (in-memory,
wired into ``compile_network`` with ``CompileOptions(verify=...)`` as
the ``ranges`` compile span) and :func:`analyze_saved` (serialized
directories; the ``python -m repro_torch.analysis ranges <dir>`` CLI
wraps it).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.analysis.diagnostics import (
    ERROR,
    WARNING,
    ProgramFormatError,
    Report,
)
from repro_torch.core.quantize import QMAX, cells_for_magnitude, n_cell_slices
from repro_torch.device import host_array

__all__ = [
    "DEFAULT_INPUT_RANGE",
    "NORM_EPS",
    "LayerRanges",
    "RangeCertificate",
    "analyze_network",
    "analyze_saved",
]

# declared activation range of the network input when the caller does not
# say otherwise: normalized image data (zero mean, unit-ish scale) stays
# well inside +-3 sigma
DEFAULT_INPUT_RANGE = (-3.0, 3.0)

# must match repro_torch.models.cnn.channel_norm's eps default (pinned by
# a test so a drift there breaks loudly instead of silently decertifying
# programs)
NORM_EPS = 1e-5

_F32_MAX = float(np.finfo(np.float32).max)
_F32_TINY = float(np.finfo(np.float32).tiny)
_INT32_LIMIT = 2**31


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


def _effective_columns(bp) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-column positive/negative sums of the effective weights.

    Returns ``(pos, neg)`` of length ``n_out`` in *original* column
    order: ``pos_j = sum(max(w_kj, 0))`` over all stored rows feeding
    column ``j`` (padded bricks are all-zero and contribute nothing;
    duplicate block ids sum exactly as the executor's scan does).
    """
    wc = np.asarray(host_array(bp.w_comp), np.float64)
    s = None
    if bp.w_scales is not None:
        s = np.asarray(host_array(bp.w_scales), np.float64)
        if s.size and s.min() < 0.0:
            # negative scales flip brick signs: clip after scaling.  The
            # factored fast path below is only sound for s >= 0, where
            # clip and the per-brick scale multiply commute.
            wc = wc * s[:, :, None, None]
            s = None
    pos = np.clip(wc, 0.0, None).sum(axis=2)  # [T, k_max, tile]
    neg = np.clip(wc, None, 0.0).sum(axis=2)
    if s is not None:
        pos *= s[:, :, None]
        neg *= s[:, :, None]
    pos = pos.sum(axis=1).reshape(-1)[: bp.n_out]
    neg = neg.sum(axis=1).reshape(-1)[: bp.n_out]
    new_order = host_array(bp.new_order)
    pos_orig = np.empty(bp.n_out)
    neg_orig = np.empty(bp.n_out)
    pos_orig[new_order] = pos
    neg_orig[new_order] = neg
    return pos_orig, neg_orig


def _spmm_bounds(
    bp, bias, n_valid: int, lo: float, hi: float
) -> tuple[float, float]:
    """Exact interval image of ``x @ W + b`` for ``x`` entries in
    ``[lo, hi]``, over the first ``n_valid`` (unpadded) columns."""
    pos, neg = _effective_columns(bp)
    pos, neg = pos[:n_valid], neg[:n_valid]
    b = np.asarray(host_array(bias), np.float64)
    out_hi = b + hi * pos + lo * neg
    out_lo = b + lo * pos + hi * neg
    if out_hi.size == 0:
        return 0.0, 0.0
    return float(out_lo.min()), float(out_hi.max())


def _quantized_interval(lo: float, hi: float) -> tuple[float, float]:
    """Widen an activation interval by the per-row int8 round-off: the
    executor's dynamic quantization introduces at most half a step,
    ``amax / (2 * QMAX)``, of error per element."""
    amax = max(abs(lo), abs(hi))
    pad = amax / (2.0 * QMAX)
    return lo - pad, hi + pad


def _analyze_operand(
    bp,
    name: str,
    cell_bits: int,
    r: Report,
) -> dict:
    """Quantized-operand facts: accumulator extrema, scale health
    (V501/V502/V503), the certified min-cells table, V505."""
    if bp.w_scales is None:
        return {}
    q = np.asarray(host_array(bp.w_comp), np.int64)
    s = np.asarray(host_array(bp.w_scales), np.float64)
    n_tiles, k_max = q.shape[0], q.shape[1]
    slot = np.arange(k_max)[None, :]
    active = slot < np.clip(host_array(bp.nnz), 0, k_max)[:, None]

    # V502 first: scale pathologies poison everything derived below
    s_act = s[active]
    finite = bool(np.isfinite(s).all())
    n_sat = int(np.count_nonzero(s_act * QMAX > _F32_MAX)) if finite else 0
    if not finite or n_sat:
        detail = (
            "non-finite scales" if not finite
            else f"{n_sat} scale(s) saturate fp32 (s * {QMAX} overflows)"
        )
        r.add(
            "V502",
            f"scale saturation: {detail} — dequantized weights are not "
            "representable",
            layer=name, location="w_scales",
        )
    n_den = int(np.count_nonzero((s_act > 0) & (s_act < _F32_TINY)))
    if n_den:
        r.add(
            "V502",
            f"{n_den} denormal scale(s) below the smallest normal fp32 "
            f"({_F32_TINY:.3e}): dequantization silently flushes the "
            "whole row-group toward zero",
            layer=name, location="w_scales",
        )

    # V503: a zero scale over a nonzero brick kills the row-group
    dead = active & (s == 0) & np.any(q != 0, axis=(2, 3))
    if np.any(dead):
        t, k = np.argwhere(dead)[0]
        r.add(
            "V503",
            f"{int(np.count_nonzero(dead))} dead-scale group(s): active "
            f"brick(s) with scale 0 over nonzero weights dequantize to "
            f"zero (first at tile {t}, slot {k})",
            severity=WARNING, layer=name, location=f"w_scales[{t},{k}]",
        )

    # accumulator extrema, activation independent (|qx| <= QMAX always):
    # int32 partial contracts one brick's block rows; the fp32
    # accumulator folds per-brick scales across a tile's slots
    aq = np.abs(q)
    colsum = aq.sum(axis=2)  # [T, k_max, tile]
    acc32 = int(QMAX * colsum.max()) if colsum.size else 0
    if acc32 >= _INT32_LIMIT:
        r.add(
            "V501",
            f"int32 accumulator overflow not provably absent: worst-case "
            f"partial magnitude {acc32} >= 2**31",
            layer=name, location="w_comp",
        )
    if finite:
        accf = (s[:, :, None] * (QMAX * colsum.astype(np.float64)))
        accf = float(accf.sum(axis=1).max()) if accf.size else 0.0
    else:
        accf = float("nan")
    if not np.isfinite(accf) or accf > _F32_MAX:
        r.add(
            "V501",
            f"fp32 accumulator overflow not provably absent: worst-case "
            f"scale-folded magnitude {accf!r} exceeds the fp32 range",
            layer=name, location="w_scales",
        )

    # certified min-cells table on the operand-uniform reference grid
    stored = n_cell_slices(cell_bits)
    qmax_brick = aq.max(axis=(2, 3)) if q.size else np.zeros(
        (n_tiles, k_max), np.int64
    )
    s_ref = float(s_act.max()) if s_act.size and finite else 0.0
    if s_ref > 0:
        m = np.clip(
            np.rint(qmax_brick * (s / s_ref)).astype(np.int64), 0, QMAX
        )
        cells = cells_for_magnitude(m, cell_bits)
    else:
        cells = np.zeros((n_tiles, k_max), np.int64)
    certified = int(cells.max()) if cells.size else 0
    if 0 < certified < stored:
        r.add(
            "V505",
            f"top {stored - certified} of {stored} cell slice(s) are "
            f"provably zero operand-wide: every row-group fits "
            f"{certified} cell(s) on the layer's reference grid",
            severity=WARNING, layer=name, location="w_comp",
        )
    return {
        "acc_int32_max": acc32,
        "acc_fp32_max": accf,
        "min_cells": tuple(tuple(int(c) for c in row) for row in cells),
        "certified_cells": certified,
        "stored_cells": stored,
    }


def analyze_network(
    program,
    input_range: tuple[float, float] = DEFAULT_INPUT_RANGE,
    report: Report | None = None,
) -> tuple[Report, RangeCertificate]:
    """Run the range certification pass over a compiled program.

    Returns ``(report, certificate)``: V5xx diagnostics accumulated into
    ``report`` (created when ``None``) and the
    :class:`RangeCertificate`.  Pure and execution free — only numpy
    reductions over the stored payloads, so the certificate is
    bit-deterministic across processes.
    """
    r = report if report is not None else Report()
    lo, hi = float(input_range[0]), float(input_range[1])
    if not (np.isfinite(lo) and np.isfinite(hi)) or lo > hi:
        raise ValueError(f"input_range must be a finite [lo, hi], got "
                         f"{input_range!r}")

    quantized = program.precision == "int8"
    layers: list[LayerRanges] = []
    fp32_safe = True
    diverged = False
    fp32_edge: str | None = None

    for conv in program.convs:
        # 'same' conv padding inserts zeros into the patches, so the
        # spmm input interval always contains 0
        in_lo, in_hi = min(lo, 0.0), max(hi, 0.0)
        if conv.bp.w_scales is not None:
            in_lo, in_hi = _quantized_interval(in_lo, in_hi)
        pre_lo, pre_hi = _spmm_bounds(
            conv.bp, conv.bias, conv.c_out, in_lo, in_hi
        )
        # channel_norm (divisor in [eps, inf)) then ReLU; maxpool is the
        # identity on intervals
        act_lo = max(min(pre_lo, 0.0) / NORM_EPS, 0.0)
        act_hi = max(max(pre_hi, 0.0) / NORM_EPS, 0.0)
        facts = _analyze_operand(conv.bp, conv.name, program.cell_bits, r) \
            if quantized else {}
        layers.append(LayerRanges(
            name=conv.name, pre_lo=pre_lo, pre_hi=pre_hi,
            act_lo=act_lo, act_hi=act_hi, **facts,
        ))
        bounds = (pre_lo, pre_hi, act_lo, act_hi)
        if not all(np.isfinite(b) for b in bounds):
            if not diverged:
                r.add(
                    "V504",
                    "activation-range divergence: certified bounds are "
                    "non-finite from this layer on",
                    layer=conv.name, location="bounds",
                )
            diverged = True
            fp32_safe = False
        elif fp32_safe and max(abs(b) for b in bounds) > _F32_MAX:
            fp32_safe = False
            fp32_edge = conv.name
        lo, hi = act_lo, act_hi

    # global average pool preserves the interval; the FC head is a plain
    # spmm + bias (its pre and act bounds coincide — the logits)
    fc_lo, fc_hi = (lo, hi)
    if program.fc.bp.w_scales is not None:
        fc_lo, fc_hi = _quantized_interval(fc_lo, fc_hi)
    pre_lo, pre_hi = _spmm_bounds(
        program.fc.bp, program.fc.bias, program.fc.d_out, fc_lo, fc_hi
    )
    facts = _analyze_operand(program.fc.bp, "fc", program.cell_bits, r) \
        if quantized else {}
    layers.append(LayerRanges(
        name="fc", pre_lo=pre_lo, pre_hi=pre_hi,
        act_lo=pre_lo, act_hi=pre_hi, **facts,
    ))
    if not (np.isfinite(pre_lo) and np.isfinite(pre_hi)):
        if not diverged:
            r.add(
                "V504",
                "activation-range divergence: certified logit bounds are "
                "non-finite",
                layer="fc", location="bounds",
            )
        diverged = True
        fp32_safe = False
    elif fp32_safe and max(abs(pre_lo), abs(pre_hi)) > _F32_MAX:
        fp32_safe = False
        fp32_edge = "fc"

    if fp32_edge is not None and not diverged:
        r.add(
            "V504",
            f"certified activation bounds exceed the fp32 range from "
            f"layer {fp32_edge} on under worst-case normalisation "
            f"(fp32_safe=False); bounds stay finite in the certificate's "
            "float64 domain",
            severity=WARNING, layer=fp32_edge, location="bounds",
        )

    cert = RangeCertificate(
        input_lo=float(input_range[0]),
        input_hi=float(input_range[1]),
        precision=program.precision,
        cell_bits=program.cell_bits,
        fp32_safe=fp32_safe,
        layers=tuple(layers),
    )
    return r, cert


def analyze_saved(
    directory: str,
    input_range: tuple[float, float] | None = None,
) -> tuple[Report, RangeCertificate | None]:
    """Certify a serialized program directory.

    Manifest statics (M0xx) and the full structural verifier run first —
    range analysis of a structurally broken program proves nothing — and
    the interpreter only runs when they pass.  With ``input_range=None``
    the stored certificate's declared range (manifest v4) is reused, so
    re-certification answers "does the artifact still support its own
    claim"; a stored certificate that disagrees with recomputation is
    V506.  Returns ``(report, certificate)`` (``None`` certificate when
    analysis could not run).
    """
    from repro_torch.analysis.verify import verify_manifest, verify_network
    from repro_torch.engine import serialize

    r = verify_manifest(directory)
    if not r.ok:
        return r, None
    try:
        program = serialize.load_program(directory, verify=False,
                                         device="cpu")
    except ProgramFormatError as e:
        r.add(getattr(e, "rule", "M005"), str(e), location=directory)
        return r, None
    verify_network(program, report=r)
    if not r.ok:
        return r, None

    stored = getattr(program, "certificate", None)
    rng = input_range
    if rng is None:
        rng = (
            (stored.input_lo, stored.input_hi)
            if stored is not None else DEFAULT_INPUT_RANGE
        )
    r, cert = analyze_network(program, input_range=rng, report=r)

    if stored is not None:
        stored_range = (stored.input_lo, stored.input_hi)
        if stored_range == (cert.input_lo, cert.input_hi):
            recomputed = cert
        else:
            _, recomputed = analyze_network(
                program, input_range=stored_range, report=Report()
            )
        if stored.to_manifest() != recomputed.to_manifest():
            r.add(
                "V506",
                "stored range certificate disagrees with recomputation "
                "from the payloads (stale or corrupted manifest entry)",
                location="certificate", severity=ERROR,
            )
    return r, cert
