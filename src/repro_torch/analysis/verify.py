"""Static program verifier for compiled crossbar programs.

Port of ``repro/analysis/verify.py``: the same rules, the same numpy
logic, the same diagnostics.  A pure, execution-free pass over
:class:`~repro_torch.core.sparse.BlockPatternWeight` operands,
:class:`~repro_torch.engine.program.CompiledNetwork` artifacts,
:class:`~repro_torch.engine.partition.NetworkPartition` declarations,
and serialized program directories.  It enforces the structural invariants the
engine otherwise only establishes dynamically (by executing and comparing
against dense):

=====  =================================================================
rule   invariant
=====  =================================================================
V101   ``new_order``/``inv_order`` are bijections over ``[0, n_out)``
V102   the two permutations are mutual inverses
V103   geometry divisibility: ``k_in % block == 0``, ``n_out % tile == 0``,
       enough tiles to cover ``n_out``
V104   operand shapes: ``w_comp [T, k_max, block, tile]``,
       ``block_ids [T, k_max]``, ``nnz [T]``, integer index dtypes
V105   ``block_ids`` within ``[0, k_in // block)``
V106   pack density: ``0 <= nnz <= min(k_max, n_blocks)``; over-allocated
       brick slots (``k_max > max(nnz)``) are a warning
V107   padded brick slots and padded tiles are inert: zero bricks,
       ``block_ids == 0``, zero scales
V108   active ``block_ids`` strictly increasing per tile (canonical pack
       order; violations warn — execution is order-insensitive)
V109   ``dict_masks`` is ``[P, k_in // block]`` boolean
V110   ``w_scales`` shaped ``[T, k_max]`` float (quantized programs)
V111   scales finite and non-negative
V112   a zero scale must not silently drop a nonzero brick
V113   quantized payloads are int8 within ``[-QMAX, QMAX]``
V114   ``cell_slices`` recompose bit-exactly to the stored ``w_comp``
V115   fp32 payloads are finite
V201   ``pattern_bits`` shaped ``[c_out, c_in]``, integer
V202   pattern bitmasks lie within the ``kernel x kernel`` window
V203   layer-vs-operand geometry: ``bp.k_in``/``bp.n_out`` are exactly the
       padded matmul dims of the layer
V204   bias shape/finiteness
V205   mapping strategy tags are known (``block_order`` in
       ``BLOCK_ORDERS``, conv/fc ``reorder`` in ``REORDERS``) and the
       candidate's geometry fields are positive
V206   mapping geometry is consistent with the packed operands: the OU
       fits the crossbar, a weight's cell slices fit one row, the OU can
       hold the layer's tallest pattern block, and an int8 program's
       mapping stores the cell-slice count its payload actually occupies
V301   inter-layer shape chaining (channels, spatial dims, fc head)
V302   precision contract: ``precision``/``cell_bits`` agree with the
       stored payloads
V303   program block/tile geometry agrees with every operand
V401   partition shards are positive
V402   partition tiles disjointly cover the padded tile axis of every layer
V403   partition axes are distinct, non-empty names
M001   manifest present and parseable
M002   format version supported
M003   manifest keys/types complete
M004   referenced payload files exist
M005   payload arrays load and match the declared geometry
=====  =================================================================

Entry points:

* :func:`verify_bp` / :func:`verify_conv` / :func:`verify_network` — pure
  in-memory checks returning a
  :class:`~repro_torch.analysis.diagnostics.Report`.
* :func:`verify_partition` — partition-vs-program tile cover.
* :func:`verify_manifest` / :func:`verify_saved` — serialized directories
  (static manifest checks first, payload checks only if those pass).

The port's operands hold ``w_comp``, ``block_ids`` and ``w_scales`` as
tensors, on the card or the CPU.  :func:`verify_bp` reads each of them
to the host once (``.detach().cpu().numpy()``, which maps
``torch.int8``/``torch.float32`` to ``np.int8``/``np.float32``) and runs
the reference's numpy logic unchanged on those arrays, so a program
verifies the same wherever its tensors live.

Trust-boundary wiring: ``compile_network(options=CompileOptions(
verify='strict'))`` runs :func:`verify_network` as a post-condition and
``load_program(verify=True)`` (the default) verifies untrusted files
after loading.  The ``python -m repro_torch.analysis verify <dir>`` CLI
wraps :func:`verify_saved`, which loads the payloads to the CPU: the
pass reads arrays and runs no kernel.
"""

from __future__ import annotations

import numpy as np

from repro_torch.analysis.diagnostics import (
    WARNING,
    ProgramFormatError,
    Report,
)
from repro_torch.core.mapping import BLOCK_ORDERS
from repro_torch.core.patterns import ALL_ZERO, pattern_sizes
from repro_torch.core.quantize import QMAX, cell_slices, compose_cell_slices
from repro_torch.core.sparse import REORDERS, BlockPatternWeight
from repro_torch.device import host_array

__all__ = [
    "verify_bp",
    "verify_conv",
    "verify_fc",
    "verify_network",
    "verify_partition",
    "verify_manifest",
    "verify_saved",
]


def _pad_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _is_permutation(order: np.ndarray, n: int) -> bool:
    return (
        order.ndim == 1
        and order.shape[0] == n
        and np.array_equal(np.sort(order), np.arange(n))
    )


def verify_bp(
    bp: BlockPatternWeight,
    layer: str | None = None,
    cell_bits: int = 4,
    report: Report | None = None,
) -> Report:
    """Verify one compressed operand's structural invariants (V1xx)."""
    r = report if report is not None else Report()
    w = host_array(bp.w_comp)
    ids = host_array(bp.block_ids)
    nnz = host_array(bp.nnz)
    new_order = host_array(bp.new_order)
    inv_order = host_array(bp.inv_order)

    # V104 first: the shape contract everything else indexes through
    shape_ok = True
    if w.ndim != 4:
        r.add("V104", f"w_comp must be rank 4, got shape {w.shape}",
              layer=layer, location="w_comp")
        return r  # nothing downstream is well-defined
    n_tiles, k_max, blk, tl = w.shape
    if (blk, tl) != (bp.block, bp.tile):
        shape_ok = False
        r.add(
            "V104",
            f"w_comp bricks are {blk}x{tl}, declared block/tile is "
            f"{bp.block}x{bp.tile}",
            layer=layer, location="w_comp",
        )
    if ids.shape != (n_tiles, k_max):
        shape_ok = False
        r.add(
            "V104",
            f"block_ids shape {ids.shape} != (n_tiles, k_max) = "
            f"{(n_tiles, k_max)}",
            layer=layer, location="block_ids",
        )
    if nnz.shape != (n_tiles,):
        shape_ok = False
        r.add(
            "V104",
            f"nnz shape {nnz.shape} != (n_tiles,) = {(n_tiles,)}",
            layer=layer, location="nnz",
        )
    for name, arr in (("block_ids", ids), ("nnz", nnz),
                      ("new_order", new_order), ("inv_order", inv_order)):
        if not np.issubdtype(arr.dtype, np.integer):
            r.add("V104", f"{name} must be an integer array, got {arr.dtype}",
                  layer=layer, location=name)
            shape_ok = False

    # V103 geometry divisibility
    if bp.block < 1 or bp.tile < 1 or bp.k_in < 1 or bp.n_out < 1:
        r.add("V103", f"non-positive geometry: k_in={bp.k_in} "
              f"n_out={bp.n_out} block={bp.block} tile={bp.tile}",
              layer=layer, location="geometry")
        return r
    if bp.k_in % bp.block:
        r.add("V103", f"k_in={bp.k_in} not divisible by block={bp.block}",
              layer=layer, location="k_in")
    if bp.n_out % bp.tile:
        r.add("V103", f"n_out={bp.n_out} not divisible by tile={bp.tile}",
              layer=layer, location="n_out")
    base_tiles = bp.n_out // bp.tile
    if n_tiles < base_tiles:
        r.add(
            "V103",
            f"{n_tiles} stored tiles cover only {n_tiles * bp.tile} of "
            f"{bp.n_out} output columns",
            layer=layer, location="n_tiles",
        )

    # V101/V102 permutations
    perm_ok = True
    for name, order in (("new_order", new_order), ("inv_order", inv_order)):
        if not _is_permutation(order, bp.n_out):
            perm_ok = False
            r.add(
                "V101",
                f"{name} is not a bijection over [0, {bp.n_out})",
                layer=layer, location=name,
            )
    if perm_ok and not np.array_equal(
        inv_order[new_order], np.arange(bp.n_out)
    ):
        r.add(
            "V102",
            "inv_order is not the inverse of new_order "
            "(inv_order[new_order] != identity)",
            layer=layer, location="inv_order",
        )

    if not shape_ok or bp.k_in % bp.block:
        return r  # index checks below assume the shape contract

    n_blocks = bp.k_in // bp.block

    # V105 block-id bounds
    if ids.size and (ids.min() < 0 or ids.max() >= n_blocks):
        r.add(
            "V105",
            f"block_ids outside [0, {n_blocks}): "
            f"min={int(ids.min())} max={int(ids.max())}",
            layer=layer, location="block_ids",
        )

    # V106 pack density (mirrors the _Packer/_build invariants)
    if nnz.size and (nnz.min() < 0 or nnz.max() > min(k_max, n_blocks)):
        r.add(
            "V106",
            f"nnz outside [0, min(k_max={k_max}, n_blocks={n_blocks})]: "
            f"min={int(nnz.min())} max={int(nnz.max())}",
            layer=layer, location="nnz",
        )
    elif k_max > max(int(nnz.max()) if nnz.size else 0, 1):
        r.add(
            "V106",
            f"k_max={k_max} over-allocates brick slots "
            f"(max nnz is {int(nnz.max()) if nnz.size else 0})",
            severity=WARNING, layer=layer, location="k_max",
        )

    # V107 padded slots (and padded tiles) are inert; V108 pack order.
    # Pristine programs have few padded slots (k_max == max nnz), so
    # gathering just those bricks beats a full payload scan.
    nnz_c = np.clip(nnz, 0, k_max)
    slot = np.arange(k_max)[None, :]
    padded = slot >= nnz_c[:, None]  # [T, k_max]
    if np.any(ids[padded] != 0):
        r.add(
            "V107",
            "padded brick slots must point at block 0",
            layer=layer, location="block_ids",
        )
    if np.any(w[padded] != 0):
        r.add(
            "V107",
            "padded brick slots must hold all-zero bricks",
            layer=layer, location="w_comp",
        )
    active = ~padded
    # strictly increasing active ids per tile: diff > 0 where both active
    if k_max > 1:
        both = active[:, 1:] & active[:, :-1]
        if np.any((np.diff(ids, axis=1) <= 0) & both):
            r.add(
                "V108",
                "active block_ids are not strictly increasing per tile "
                "(non-canonical pack order; duplicates split one block's "
                "weights over two bricks)",
                severity=WARNING, layer=layer, location="block_ids",
            )

    # V109 dictionary shape
    dm = host_array(bp.dict_masks)
    if dm.ndim != 2 or dm.shape[1] != n_blocks:
        r.add(
            "V109",
            f"dict_masks shape {dm.shape} != (P, n_blocks={n_blocks})",
            layer=layer, location="dict_masks",
        )

    # quantized-path contracts
    if bp.w_scales is not None:
        s = host_array(bp.w_scales)
        if s.shape != (n_tiles, k_max):
            r.add(
                "V110",
                f"w_scales shape {s.shape} != (n_tiles, k_max) = "
                f"{(n_tiles, k_max)}",
                layer=layer, location="w_scales",
            )
            return r
        if not np.issubdtype(s.dtype, np.floating):
            r.add("V110", f"w_scales must be float, got {s.dtype}",
                  layer=layer, location="w_scales")
        if not np.all(np.isfinite(s)) or (s.size and s.min() < 0):
            r.add(
                "V111",
                "w_scales must be finite and non-negative",
                layer=layer, location="w_scales",
            )
        # active slots with a zero scale (padded slots are V107's job);
        # pristine programs have none, so the brick gather is empty
        zero_active = (s == 0) & ~padded
        if np.any(zero_active):
            nonzero = np.any(w[zero_active] != 0, axis=(1, 2))
            if np.any(nonzero):
                t, k = np.argwhere(zero_active)[int(np.argmax(nonzero))]
                r.add(
                    "V112",
                    f"zero scale silently drops a nonzero brick "
                    f"(first at tile {t}, slot {k})",
                    layer=layer, location=f"w_scales[{t},{k}]",
                )
        if w.dtype != np.int8:
            r.add(
                "V113",
                f"quantized w_comp must be int8, got {w.dtype}",
                layer=layer, location="w_comp",
            )
        wmin = int(w.min()) if w.size else 0
        wmax = int(w.max()) if w.size else 0
        if w.dtype == np.int8 and (wmin < -QMAX or wmax > QMAX):
            r.add(
                "V113",
                f"quantized weights outside [-{QMAX}, {QMAX}]: "
                f"min={wmin} max={wmax}",
                layer=layer, location="w_comp",
            )
        if w.dtype == np.int8:
            # cell slicing is elementwise, so the bit-exact round trip
            # w == compose(slices(w)) holds for the whole payload iff it
            # holds for every distinct int8 value present — slice the 256
            # possible values once, then count offenders with one bincount
            # pass instead of re-slicing every brick
            domain = np.arange(-128, 128, dtype=np.int8)
            recomposed = compose_cell_slices(
                cell_slices(domain, cell_bits), cell_bits
            )
            bad = domain[np.asarray(recomposed, np.int64) != domain]
            # a bad value can only occur inside the payload's [min, max],
            # so pristine programs skip the counting pass entirely
            bad = bad[(bad >= wmin) & (bad <= wmax)]
            if bad.size:
                counts = np.bincount(
                    w.reshape(-1).view(np.uint8), minlength=256
                )
                n_bad = int(counts[bad.astype(np.int16) % 256].sum())
                if n_bad:
                    present = [
                        int(v) for v in bad
                        if counts[int(v) % 256]
                    ][:8]
                    r.add(
                        "V114",
                        f"{n_bad} stored weights (values {present}) do not "
                        f"survive the {cell_bits}-bit cell-slice round trip",
                        layer=layer, location="w_comp",
                    )
        if np.any(s[padded] != 0):
            r.add(
                "V107",
                "padded brick slots must carry zero scales",
                layer=layer, location="w_scales",
            )
    else:
        if not np.issubdtype(w.dtype, np.floating):
            r.add(
                "V113",
                f"unquantized w_comp must be float, got {w.dtype} "
                "(int payload without w_scales)",
                layer=layer, location="w_comp",
            )
        # NaN/Inf propagate through the sum, so this is a single
        # allocation-free reduce; the exact count is only computed on the
        # (already broken) error path
        elif not np.isfinite(w.sum()):
            r.add(
                "V115",
                f"{int((~np.isfinite(w)).sum())} non-finite stored weights",
                layer=layer, location="w_comp",
            )
    return r


def _verify_bias(r: Report, bias, n: int, layer: str) -> None:
    b = host_array(bias)
    if b.shape != (n,):
        r.add("V204", f"bias shape {b.shape} != ({n},)",
              layer=layer, location="bias")
    elif not np.all(np.isfinite(b)):
        r.add("V204", "bias has non-finite entries",
              layer=layer, location="bias")


def _verify_mapping(r: Report, conv) -> None:
    """V205/V206: a searched per-layer mapping candidate, if present.

    ``MappingCandidate`` is deliberately unvalidated at construction so a
    corrupted save surfaces here as a diagnostic rather than a load-time
    construction error."""
    m = getattr(conv, "mapping", None)
    if m is None:
        return
    name = conv.name
    if m.block_order not in BLOCK_ORDERS:
        r.add(
            "V205",
            f"unknown mapping block_order {m.block_order!r} "
            f"(known: {BLOCK_ORDERS})",
            layer=name, location="mapping.block_order",
        )
    if m.reorder not in REORDERS:
        r.add(
            "V205",
            f"unknown mapping reorder {m.reorder!r} (known: {REORDERS})",
            layer=name, location="mapping.reorder",
        )
    dims = {
        "rows": m.rows,
        "cols": m.cols,
        "cells_per_weight": m.cells_per_weight,
        "ou_rows": m.ou_rows,
        "ou_cols": m.ou_cols,
    }
    bad = {k: v for k, v in dims.items() if v < 1}
    if bad:
        r.add(
            "V205",
            f"non-positive mapping geometry: {bad}",
            layer=name, location="mapping",
        )
        return  # consistency checks below assume positive dims
    if m.ou_rows > m.rows:
        r.add(
            "V206",
            f"mapping ou_rows={m.ou_rows} exceeds crossbar rows={m.rows}",
            layer=name, location="mapping.ou_rows",
        )
    if m.ou_cols > m.cols:
        r.add(
            "V206",
            f"mapping ou_cols={m.ou_cols} exceeds crossbar cols={m.cols}",
            layer=name, location="mapping.ou_cols",
        )
    if m.cells_per_weight > m.cols:
        r.add(
            "V206",
            f"mapping cells_per_weight={m.cells_per_weight} exceeds "
            f"crossbar cols={m.cols} (one weight must fit one row)",
            layer=name, location="mapping.cells_per_weight",
        )
    bits = host_array(conv.pattern_bits)
    if (
        bits.ndim == 2
        and bits.size
        and np.issubdtype(bits.dtype, np.integer)
        and bits.min() >= 0
    ):
        nz = bits != ALL_ZERO
        if np.any(nz):
            max_h = int(pattern_sizes(bits)[nz].max())
            if m.ou_rows < max_h:
                r.add(
                    "V206",
                    f"mapping ou_rows={m.ou_rows} cannot hold the layer's "
                    f"tallest pattern block (height {max_h}): "
                    "pattern_ou_schedule never splits a block across OU "
                    "row groups",
                    layer=name, location="mapping.ou_rows",
                )


def verify_conv(conv, cell_bits: int = 4, report: Report | None = None) -> Report:
    """Verify one compiled conv layer (V2xx + its operand's V1xx)."""
    r = report if report is not None else Report()
    name = conv.name
    verify_bp(conv.bp, layer=name, cell_bits=cell_bits, report=r)

    k = conv.kernel
    if k < 1:
        r.add("V203", f"kernel size {k} < 1", layer=name, location="kernel")
        return r
    if k % 2 == 0:
        r.add(
            "V203",
            f"even kernel {k}x{k}: the executor's 'same' padding assumes "
            "an odd kernel",
            severity=WARNING, layer=name, location="kernel",
        )
    if conv.out_hw < 1 or conv.c_in < 1 or conv.c_out < 1:
        r.add(
            "V203",
            f"non-positive layer dims: c_in={conv.c_in} c_out={conv.c_out} "
            f"out_hw={conv.out_hw}",
            layer=name, location="dims",
        )
        return r

    bits = host_array(conv.pattern_bits)
    if bits.shape != (conv.c_out, conv.c_in) or not np.issubdtype(
        bits.dtype, np.integer
    ):
        r.add(
            "V201",
            f"pattern_bits shape {bits.shape} (dtype {bits.dtype}) != "
            f"integer [c_out={conv.c_out}, c_in={conv.c_in}]",
            layer=name, location="pattern_bits",
        )
    elif bits.size and (
        bits.min() < 0 or bits.max() >= (1 << (k * k))
    ):
        r.add(
            "V202",
            f"pattern bitmask outside the {k}x{k} kernel window "
            f"[0, 2^{k * k}): min={int(bits.min())} max={int(bits.max())}",
            layer=name, location="pattern_bits",
        )

    bp = conv.bp
    want_k = _pad_up(conv.c_in * k * k, bp.block)
    want_n = _pad_up(conv.c_out, bp.tile)
    if bp.k_in != want_k:
        r.add(
            "V203",
            f"bp.k_in={bp.k_in} != padded c_in*k*k = {want_k}",
            layer=name, location="bp.k_in",
        )
    if bp.n_out != want_n:
        r.add(
            "V203",
            f"bp.n_out={bp.n_out} != padded c_out = {want_n}",
            layer=name, location="bp.n_out",
        )
    _verify_bias(r, conv.bias, conv.c_out, name)
    _verify_mapping(r, conv)
    return r


def verify_fc(fc, cell_bits: int = 4, report: Report | None = None) -> Report:
    """Verify the compiled FC head (V2xx + operand V1xx)."""
    r = report if report is not None else Report()
    verify_bp(fc.bp, layer="fc", cell_bits=cell_bits, report=r)
    reorder = getattr(fc, "reorder", "pattern")
    if reorder not in REORDERS:
        r.add(
            "V205",
            f"unknown fc reorder {reorder!r} (known: {REORDERS})",
            layer="fc", location="reorder",
        )
    bp = fc.bp
    if fc.d_in < 1 or fc.d_out < 1:
        r.add("V203", f"non-positive fc dims: d_in={fc.d_in} d_out={fc.d_out}",
              layer="fc", location="dims")
        return r
    want_k = _pad_up(fc.d_in, bp.block)
    want_n = _pad_up(fc.d_out, bp.tile)
    if bp.k_in != want_k:
        r.add("V203", f"bp.k_in={bp.k_in} != padded d_in = {want_k}",
              layer="fc", location="bp.k_in")
    if bp.n_out != want_n:
        r.add("V203", f"bp.n_out={bp.n_out} != padded d_out = {want_n}",
              layer="fc", location="bp.n_out")
    _verify_bias(r, fc.bias, fc.d_out, "fc")
    return r


def verify_partition(program, partition=None, report: Report | None = None) -> Report:
    """Verify a partition's tile disjoint-cover over a program (V4xx)."""
    from repro_torch.engine.partition import padded_tiles, tile_assignment

    r = report if report is not None else Report()
    part = partition if partition is not None else program.partition
    if part is None:
        return r
    if part.data < 1 or part.model < 1:
        r.add("V401", f"non-positive partition {part.data}x{part.model}",
              location="partition")
        return r
    if not part.data_axis or not part.model_axis:
        r.add("V403", "partition axis names must be non-empty",
              location="partition")
    elif part.data_axis == part.model_axis:
        r.add(
            "V403",
            f"data_axis and model_axis are both {part.data_axis!r}",
            location="partition",
        )
    bps = [(c.name, c.bp) for c in program.convs] + [("fc", program.fc.bp)]
    for name, bp in bps:
        padded = padded_tiles(bp.n_tiles, part.model)
        asg = tile_assignment(bp.n_tiles, part.model)
        per = padded // part.model
        cover = (
            asg.shape == (part.model, per)
            and np.array_equal(np.sort(asg.ravel()), np.arange(padded))
        )
        if padded % part.model or not cover:
            r.add(
                "V402",
                f"tile assignment does not disjointly cover the "
                f"{padded}-tile padded axis over {part.model} shard(s)",
                layer=name, location="partition",
            )
    return r


def verify_network(program, report: Report | None = None) -> Report:
    """Verify a full compiled program: every operand, every layer, the
    inter-layer chain, the precision contract, and any partition."""
    r = report if report is not None else Report()
    cfg = program.config

    # V303 / V302 program-level contracts
    quantized = []
    for name, bp in [(c.name, c.bp) for c in program.convs] + [
        ("fc", program.fc.bp)
    ]:
        if (bp.block, bp.tile) != (program.block, program.tile):
            r.add(
                "V303",
                f"operand block/tile {bp.block}x{bp.tile} != program "
                f"{program.block}x{program.tile}",
                layer=name, location="bp",
            )
        quantized.append(bp.w_scales is not None)
    if program.precision not in ("fp32", "int8"):
        r.add("V302", f"unknown precision {program.precision!r}",
              location="precision")
    elif program.precision == "int8" and not all(quantized):
        r.add(
            "V302",
            "precision='int8' but some operands carry no w_scales",
            location="precision",
        )
    elif program.precision == "fp32" and any(quantized):
        r.add(
            "V302",
            "precision='fp32' but some operands carry w_scales",
            location="precision",
        )
    if program.cell_bits < 1:
        r.add("V302", f"cell_bits={program.cell_bits} < 1",
              location="cell_bits")
        return r

    # per-layer checks
    for conv in program.convs:
        verify_conv(conv, cell_bits=program.cell_bits, report=r)
    verify_fc(program.fc, cell_bits=program.cell_bits, report=r)

    # V206 storage consistency: an int8 program's searched mappings must
    # price the cell-slice count its payload actually occupies (the same
    # derivation hardware_report uses)
    stored = program.cells_per_weight
    if stored is not None:
        for conv in program.convs:
            m = getattr(conv, "mapping", None)
            if m is not None and m.cells_per_weight != stored:
                r.add(
                    "V206",
                    f"mapping cells_per_weight={m.cells_per_weight} != "
                    f"the stored cell-slice count {stored} "
                    f"(int8 over {program.cell_bits}-bit cells)",
                    layer=conv.name, location="mapping.cells_per_weight",
                )

    # V301 inter-layer chain
    if len(program.convs) != cfg.num_convs:
        r.add(
            "V301",
            f"{len(program.convs)} compiled convs != config's "
            f"{cfg.num_convs}",
            location="convs",
        )
    hw = cfg.input_hw
    prev_out = cfg.conv_channels[0][0] if cfg.conv_channels else None
    for i, conv in enumerate(program.convs, start=1):
        if conv.c_in != prev_out:
            r.add(
                "V301",
                f"c_in={conv.c_in} does not chain from previous layer's "
                f"c_out={prev_out}",
                layer=conv.name, location="c_in",
            )
        if i <= cfg.num_convs and (conv.c_in, conv.c_out) != tuple(
            cfg.conv_channels[i - 1]
        ):
            r.add(
                "V301",
                f"(c_in, c_out)=({conv.c_in}, {conv.c_out}) != config "
                f"channels {tuple(cfg.conv_channels[i - 1])}",
                layer=conv.name, location="channels",
            )
        if conv.out_hw != hw:
            r.add(
                "V301",
                f"out_hw={conv.out_hw} != chained spatial size {hw}",
                layer=conv.name, location="out_hw",
            )
        if conv.pool_after != (i in cfg.pool_after):
            r.add(
                "V301",
                f"pool_after={conv.pool_after} disagrees with config "
                f"pool_after={sorted(cfg.pool_after)}",
                layer=conv.name, location="pool_after",
            )
        if conv.pool_after:
            hw //= 2
        prev_out = conv.c_out
    if program.convs and program.fc.d_in != program.convs[-1].c_out:
        r.add(
            "V301",
            f"fc.d_in={program.fc.d_in} != last conv c_out="
            f"{program.convs[-1].c_out} (global average pool preserves "
            "channels)",
            layer="fc", location="d_in",
        )
    if program.fc.d_out != cfg.num_classes:
        r.add(
            "V301",
            f"fc.d_out={program.fc.d_out} != num_classes={cfg.num_classes}",
            layer="fc", location="d_out",
        )

    verify_partition(program, report=r)
    return r


def verify_manifest(directory: str, report: Report | None = None) -> Report:
    """Static checks of a serialized program directory (M0xx).

    Validates the manifest's version, keys, and referenced payload files
    *without* constructing any array — the same pre-load validation
    ``load_program`` performs, expressed as diagnostics instead of a
    raised :class:`ProgramFormatError`.
    """
    from repro_torch.engine import serialize

    r = report if report is not None else Report()
    try:
        manifest = serialize.read_manifest(directory)
    except ProgramFormatError as e:
        r.add(getattr(e, "rule", "M001"), str(e), location=directory)
        return r
    try:
        serialize.validate_manifest(manifest, directory)
    except ProgramFormatError as e:
        r.add(getattr(e, "rule", "M003"), str(e), location=directory)
    return r


def verify_saved(directory: str) -> Report:
    """Full verification of a saved program: manifest statics, payload
    load, then the in-memory network verifier."""
    from repro_torch.engine import serialize

    r = verify_manifest(directory)
    if not r.ok:
        return r
    try:
        program = serialize.load_program(directory, verify=False,
                                         device="cpu")
    except ProgramFormatError as e:
        r.add(getattr(e, "rule", "M005"), str(e), location=directory)
        return r
    return verify_network(program, report=r)
