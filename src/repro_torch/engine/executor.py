"""Executor: run a ``CompiledNetwork`` through the block-pattern spmm.

Port of ``repro/engine/executor.py``.  ``make_forward``
returns a batched forward: per conv layer it writes the im2col patch
rows, already zero-padded to the spmm's K (``kernels/patches.
conv_patches_cuda``, one launch a layer, reading the activations through
their strides), walks them through the block-pattern spmm
(``kernels/pattern_spmm``), applies the stored inverse output
permutation (the Output Indexing Unit), then bias +
``channel_norm``/ReLU and the 2x2 maxpool where the schedule says so.
On a CUDA device the patch rows and the spmm are the path's hand-written
kernels; on the CPU both run their plain PyTorch versions.  The
permutation gather, bias, norm, pooling and the FC's quantization of
activations are plain PyTorch ops, as they were XLA ops in the
reference.

With ``collect_stats=True`` the forward also counts, per layer and per
OU row-group (= (input channel, pattern) pair), how many input
selections were entirely zero — what the paper's Input Preprocessing
Unit skips on.

``channel_norm`` is strictly per-sample, so every batch row is computed
independently of its neighbours: the same image gives bit-identical
logits alone, co-batched, or next to zero-padded dead slots.  The
serving scheduler relies on that by always running one fixed
``batch_slots`` shape with a row-validity mask that keeps dead slots out
of the skip counters and window totals.

Quantized programs run through the same loop, quantizing activations
per im2col row on the fly (one scale a row).  An int8 conv's rows are
quantized inside the patch kernel, on one device and on a mesh alike:
``kernels/patches.conv_patches_q8_cuda`` writes the int8 rows and their
row scales in one launch, and the int8 spmm reads them
(``kernels/ops.pattern_spmm_quant_rows``).  The FC quantizes its float
rows with ``core/quantize.quantize_rows``.  ``collect_stats`` adds one
float patch launch per int8 conv, read by the counters alone.  An ulp of
fp32 noise in one layer can flip one int8 rounding in the next layer's
activation quantization, so int8 logits agree with another execution of
the same program to one quantization step, not to fp32 noise.

With ``mesh=`` (a ``torch.distributed`` ``DeviceMesh`` with dims
``("data", "model")``, ``launch/mesh.py``) the same program executes
sharded (``engine/partition.py``), in SPMD style: every rank calls the
forward with the same global batch and gets the whole result back.  Each
spmm runs tile-parallel: every ``model`` rank runs the kernel on its
contiguous slab of (zero-padded) tiles, scatters its columns into full
width, and an all-reduce over the model group combines the partials
before the global inverse permutation.  Batch rows and the skip counters
split over the ``data`` dim when the rows divide (an all-gather rebuilds
the rows, an all-reduce sums the counters).  Padding tiles multiply
zeros, so sharded and unsharded execution agree to fp32 reassociation
noise (a slab has another kernel plan than the whole layer), a 1x1 mesh
bit for bit, and the measured statistics exactly.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.quantize import quantize_rows
from repro_torch.core.sparse import BlockPatternWeight
from repro_torch.device import resolve_device
from repro_torch.engine.partition import (
    NetworkPartition,
    pad_bp_tiles,
    partition_from_mesh,
)
from repro_torch.engine.program import CompiledConv, CompiledFC, CompiledNetwork
from repro_torch.engine.stats import skip_patterns_and_masks, stats_from_counts
from repro_torch.kernels.ops import _pad_to, pattern_spmm_quant_rows
from repro_torch.kernels.patches import (
    conv_patches_cuda,
    conv_patches_q8_cuda,
    extract_patches,
)
from repro_torch.kernels.pattern_spmm import kmajor_bricks, pattern_spmm_cuda
from repro_torch.launch.mesh import mesh_device
from repro_torch.models.cnn import channel_norm, max_pool_2x2
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.parallel.sharding import shard_block_pattern

__all__ = ["extract_patches", "make_forward", "warmup_forward", "execute"]


def _pad_features(x: torch.Tensor, to: int) -> torch.Tensor:
    """Zero-pad the feature axis up to ``to`` (the bp's padded K)."""
    if x.shape[-1] > to:
        raise ValueError(f"{x.shape[-1]} features exceed the padded K={to}")
    return _pad_to(x, x.dim() - 1, to)


def zero_selection_counts(
    patches: torch.Tensor,
    c_in: int,
    kk: int,
    masks: torch.Tensor,
    row_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Count all-zero input selections per OU row-group.

    patches: [M, c_in*kk] unpadded im2col windows; masks: [P, kk] bool,
    the layer's pattern position masks (``skip_patterns_and_masks``).
    Returns int32 [c_in, P]: entry (c, i) is the number of windows whose
    channel-c activations at ``masks[i]``'s positions are all zero.  The
    all-zero pattern selects nothing and counts every window.
    ``row_valid`` (bool [M]) excludes ``False`` rows from every count.
    """
    m = patches.shape[0]
    z = patches.reshape(m, c_in, 1, kk) == 0.0
    keep = masks[None, None]  # [1, 1, P, kk]
    all_zero = torch.all(z | ~keep, dim=-1)  # [M, C, P]
    if row_valid is not None:
        all_zero = all_zero & row_valid[:, None, None]
    return all_zero.sum(dim=0, dtype=torch.int32)


class _Prepared(NamedTuple):
    """One layer's operands on the executing device."""

    bp: BlockPatternWeight
    nnz: torch.Tensor  # int32 [T]
    inv_order: torch.Tensor  # int64 [N]
    bias: torch.Tensor  # float32 [c_out]
    w_kmajor: torch.Tensor | None  # int8 [T, k_max, tile, block]; int8 only


class _Dispatch:
    """Single-device walk + stat-counter dispatch."""

    def __init__(self, device: torch.device):
        self.device = device

    def prepare(self, bp: BlockPatternWeight, bias: np.ndarray) -> _Prepared:
        """Move the layer's operands to the device, once per program: the
        bricks and index table, device copies of ``nnz`` (which the
        kernels read) and ``inv_order``, and for int8 bricks their K-major
        copy (the layout the int8 kernel's MMAs read; never saved)."""
        dev = self.device
        bp = bp.to(dev)
        return _Prepared(
            bp=bp,
            nnz=torch.as_tensor(bp.nnz, dtype=torch.int32, device=dev),
            inv_order=torch.as_tensor(bp.inv_order, dtype=torch.int64,
                                      device=dev),
            bias=torch.as_tensor(np.asarray(bias, np.float32), device=dev),
            w_kmajor=(None if bp.w_scales is None
                      else kmajor_bricks(bp.w_comp)),
        )

    def walk(self, operand: tuple, prepared: _Prepared) -> torch.Tensor:
        """The layer's spmm over ``operand`` -> float32 [M, T*tile] in
        reordered column order (the executor's Output Indexing Unit
        follows).  ``operand`` is ``(rows,)`` for fp32 bricks, and for
        int8 bricks ``(xq, x_scale)``: int8 rows and their float32 row
        scales, which multiply the int8 product."""
        bp = prepared.bp
        if bp.w_scales is None:
            (rows,) = operand
            return pattern_spmm_cuda(rows, bp.w_comp, bp.block_ids,
                                     prepared.nnz, bp.block)
        xq, x_scale = operand
        return pattern_spmm_quant_rows(
            xq, x_scale, bp.w_comp, bp.block_ids, bp.w_scales, prepared.nnz,
            bp.block, w_kmajor=prepared.w_kmajor)

    def counts(self, patches, c_in, kk, masks, row_valid=None):
        return zero_selection_counts(patches, c_in, kk, masks, row_valid)


class _ShardedDispatch(_Dispatch):
    """Mesh execution: tile-parallel walk (scatter + all-reduce over the
    model group), batch rows and skip counters split over the data group.
    Every rank runs this with the same global input and returns the
    whole result."""

    def __init__(self, device: torch.device, mesh, part: NetworkPartition):
        super().__init__(device)
        self.part = part
        self.model_group = (mesh.get_group(part.model_axis)
                            if part.model > 1 else None)
        self.model_rank = (mesh.get_local_rank(part.model_axis)
                           if part.model > 1 else 0)
        self.data_group = (mesh.get_group(part.data_axis)
                           if part.data > 1 else None)
        self.data_rank = (mesh.get_local_rank(part.data_axis)
                          if part.data > 1 else 0)
        self.mesh = mesh

    def prepare(self, bp: BlockPatternWeight, bias: np.ndarray) -> _Prepared:
        """Pad the tile axis for the model ranks and keep this rank's slab
        (its bricks, ids, ``nnz``, scales and the slab's K-major copy);
        ``inv_order`` stays the whole layer's."""
        padded = pad_bp_tiles(bp, self.part.model)
        return super().prepare(
            shard_block_pattern(padded, self.mesh, self.part.model_axis),
            bias)

    def _rows(self, m: int) -> slice | None:
        """This rank's rows when the data dim divides ``m``, else None
        (every rank computes all rows).  Decided per call on its own row
        count, as the reference decides per spmm on static shapes, so the
        fc rows of an odd batch are replicated."""
        data = self.part.data
        if data == 1 or m % data:
            return None
        per = m // data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def _gather_rows(self, y: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(y) for _ in range(self.part.data)]
        dist.all_gather(parts, y.contiguous(), group=self.data_group)
        return torch.cat(parts)

    def walk(self, operand: tuple, prepared: _Prepared) -> torch.Tensor:
        """This rank's rows of ``operand`` (an int8 operand's rows and row
        scales alike) through its slab of tiles, combined into the whole
        layer's columns and rows; padded tiles' columns sit past every
        ``inv_order`` entry."""
        rows = self._rows(operand[0].shape[0])
        if rows is not None:
            operand = tuple(t[rows] for t in operand)
        y = super().walk(operand, prepared)
        if self.part.model > 1:
            # The slabs are disjoint, so an all-gather would also
            # reassemble them with less traffic; the scatter + all-reduce
            # form is kept because it stays correct for any tile->device
            # assignment, not just the contiguous one.
            width = y.shape[1]
            full = torch.zeros((y.shape[0], width * self.part.model),
                               dtype=y.dtype, device=y.device)
            off = self.model_rank * width
            full[:, off:off + width] = y
            dist.all_reduce(full, group=self.model_group)
            y = full
        if rows is not None:
            y = self._gather_rows(y)
        return y

    def counts(self, patches, c_in, kk, masks, row_valid=None):
        rows = self._rows(patches.shape[0])
        if rows is None:
            return zero_selection_counts(patches, c_in, kk, masks, row_valid)
        # the per-sample validity rows split with their patch rows
        local = zero_selection_counts(
            patches[rows], c_in, kk, masks,
            None if row_valid is None else row_valid[rows])
        dist.all_reduce(local, group=self.data_group)
        return local


def _quant_args(totals: dict | None, rows: int, k: int,
                bytes_in: int) -> dict:
    """The args of an int8 layer's ``layer:<name>.quantize`` and
    ``layer:<name>.spmm_i8`` spans on a traced call: its ``rows`` and
    ``k`` and the quantization's traffic, counted on the host from the
    shapes: ``bytes_in`` (what it reads: a conv's input map, the FC's
    float rows) and ``bytes_out`` (the int8 rows and float32 row scales
    written), each added to the step's ``totals``.  Untraced (``totals``
    is None) there are none."""
    if totals is None:
        return {}
    args = {"rows": rows, "k": k, "bytes_in": bytes_in,
            "bytes_out": rows * k + 4 * rows}
    for key in ("rows", "bytes_in", "bytes_out"):
        totals[key] += args[key]
    return args


def _spmm(name: str, operand: tuple, disp: _Dispatch, prepared: _Prepared,
          dtype: torch.dtype, tracer: Tracer, args: dict) -> torch.Tensor:
    """A layer's walk (an int8 one in its ``layer:<name>.spmm_i8`` span),
    then the Output Indexing Unit: the stored inverse permutation."""
    if prepared.bp.w_scales is None:
        y = disp.walk(operand, prepared)
    else:
        with tracer.span(f"layer:{name}.spmm_i8", cat="execute", **args):
            y = disp.walk(operand, prepared)
    return y.index_select(1, prepared.inv_order).to(dtype)


def _run_conv(
    op: CompiledConv,
    x: torch.Tensor,
    disp: _Dispatch,
    prepared: _Prepared,
    stat_masks: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
    tracer: Tracer = NULL_TRACER,
    totals: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    b, c, h, w = x.shape
    kk = op.kernel * op.kernel
    k_in = op.bp.k_in
    args = {}
    if op.bp.w_scales is None:
        operand = (conv_patches_cuda(x, op.kernel, k_in),)  # [B*H*W, K]
    else:
        args = _quant_args(totals, b * h * w, k_in,
                           x.numel() * x.element_size())
        with tracer.span(f"layer:{op.name}.quantize", cat="execute",
                         **args):
            # int8 rows and their row scales, one launch
            operand = conv_patches_q8_cuda(x, op.kernel, k_in)
    counts = None
    if stat_masks is not None:
        # the counters read float rows: the fp32 operand, or an int8
        # layer's made for the counting alone
        patches = (operand[0] if op.bp.w_scales is None
                   else conv_patches_cuda(x, op.kernel, k_in))
        # every patch row belongs to one sample; dead-slot samples are
        # excluded from the skip counters
        row_valid = (None if valid is None
                     else valid.repeat_interleave(h * w))
        counts = disp.counts(
            patches[:, : op.c_in * kk], op.c_in, kk, stat_masks, row_valid)
    y = _spmm(op.name, operand, disp, prepared, x.dtype, tracer, args)
    y = y[:, : op.c_out] + prepared.bias
    y = y.reshape(b, h, w, op.c_out).permute(0, 3, 1, 2)
    y = torch.relu(channel_norm(y))
    if op.pool_after:
        y = max_pool_2x2(y)
    return y, counts


def _run_fc(
    op: CompiledFC,
    x: torch.Tensor,
    disp: _Dispatch,
    prepared: _Prepared,
    tracer: Tracer = NULL_TRACER,
    totals: dict | None = None,
) -> torch.Tensor:
    xf = _pad_features(x, op.bp.k_in)
    args = {}
    if op.bp.w_scales is None:
        operand = (xf,)
    else:
        rows, k = xf.shape
        args = _quant_args(totals, rows, k, rows * k * xf.element_size())
        with tracer.span("layer:fc.quantize", cat="execute", **args):
            operand = quantize_rows(xf)
    y = _spmm("fc", operand, disp, prepared, xf.dtype, tracer, args)
    return y[:, : op.d_out] + prepared.bias


def _layer_windows(
    program: CompiledNetwork, x_shape, live_rows: int | None = None
) -> dict[str, int]:
    """Windows (input positions) each conv layer sees for this input;
    ``live_rows`` overrides the batch size when some rows are dead."""
    b, _, h, w = x_shape
    if live_rows is not None:
        b = live_rows
    windows = {}
    for op in program.convs:
        windows[op.name] = b * h * w
        if op.pool_after:
            h, w = h // 2, w // 2
    return windows


def _mesh_rank_device(mesh, device) -> torch.device:
    """This rank's device of ``mesh``; a ``device`` given as well must be
    of the mesh's device type."""
    own = mesh_device(mesh)
    if device is None:
        return own
    device = torch.device(device)
    if device.type != own.type:
        raise ValueError(
            f"device {device} is not on the mesh's {mesh.device_type!r} "
            f"devices")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _LayerEvents:
    """Per-layer stream time of the traced forward on a CUDA device.

    A call records one ``torch.cuda.Event`` at each layer boundary;
    ``names[i]`` names the interval from boundary ``i`` to ``i + 1``
    (``None``: not kept).  A call's events are folded into seconds once
    its last event has completed, which the next call checks without
    waiting and :meth:`fold` with ``wait=True`` waits for, and are then
    reused.
    """

    def __init__(self, names: list[str | None]):
        self.names = names
        self._free: list[list] = []
        self._pending: deque = deque()

    def take(self, observe) -> list:
        self.fold(observe, wait=False)
        if self._free:
            return self._free.pop()
        return [torch.cuda.Event(enable_timing=True)
                for _ in range(len(self.names) + 1)]

    def recorded(self, events: list) -> None:
        self._pending.append(events)

    def fold(self, observe, wait: bool) -> None:
        while self._pending:
            events = self._pending[0]
            if wait:
                events[-1].synchronize()
            elif not events[-1].query():
                return
            self._pending.popleft()
            for name, a, b in zip(self.names, events, events[1:]):
                if name is not None:
                    observe(name, a.elapsed_time(b) * 1e-3)
            self._free.append(events)


def make_forward(
    program: CompiledNetwork,
    collect_stats: bool = False,
    mesh=None,
    partition=None,
    tracer: Tracer | None = None,
    device: str | torch.device | None = None,
):
    """Build the batched forward for ``program`` on ``device``.

    Args:
      collect_stats: also measure per-layer all-zero-selection counts.
      mesh: a ``DeviceMesh`` (``launch/mesh.make_mesh``) to execute on,
        every rank of its group calling with the same input.  Tiles split
        over the mesh's model dim (all-reduced partial outputs), batch
        rows and stat counters over the data dim; without a mesh the
        single-device path runs.
      partition: explicit :class:`~repro_torch.engine.partition.
        NetworkPartition` (defaults to ``program.partition``, else read
        off the mesh); validated against the mesh's dim sizes.  Without
        ``mesh`` it raises ``ValueError``.
      tracer: with an *enabled* tracer, a call records one ``forward``
        span holding ``forward.upload`` (the host->device copies of ``x``
        and ``valid``) and a ``layer:<name>`` span per conv, then
        ``layer:gap`` and ``layer:fc``.  An int8 program splits each
        conv's and the FC's spmm into ``layer:<name>.quantize`` (a conv's
        fused patch-and-quantize launch, the FC's ``quantize_rows``) and
        ``layer:<name>.spmm_i8`` (the walk), and ``forward`` carries the
        step's quantization totals (``rows``, ``bytes_in``,
        ``bytes_out``).  Traced or not, a call runs the same ops; nothing
        in it synchronises, so a span times the host's enqueue of its
        layer's ops, not their run.  ``fn.observed_times()`` gives each
        conv's and the FC's mean time a traced call: on a CUDA device,
        stream time between CUDA events recorded at the layer boundaries
        (folded in once they have completed); on the CPU, where every op
        finishes before it returns, the span's duration.
      device: where the forward runs; ``None`` means ``cuda`` and raises
        when there is none (with a mesh: this rank's device of the mesh,
        ``launch/mesh.mesh_device``).  The program's operands are copied
        there once, here.  On ``cuda`` every spmm launches a Hopper
        kernel; on the CPU it runs the kernel's plain PyTorch version.

    Returns ``fn(x: [B, C, H, W], valid=None) -> logits [B, num_classes]``
    (a tensor on ``device``), or with ``collect_stats`` ``(logits,
    ActivationStats)``.  ``x`` and ``valid`` (bool [B] row-validity mask)
    may be tensors or numpy arrays.  ``channel_norm`` is per-sample, so
    dead rows never influence live logits; their own outputs are
    meaningless.  ``fn.trace_count()`` is the number of distinct input
    signatures (shape, dtype, whether ``valid`` was given) the forward
    has run, traced or not (the reference counts jit traces, which are
    the same thing there).
    """
    if mesh is None:
        if partition is not None:
            raise ValueError("partition= requires mesh=")
        device = resolve_device(device)
        disp = _Dispatch(device)
    else:
        device = _mesh_rank_device(mesh, device)
        part = partition_from_mesh(mesh, partition or program.partition)
        disp = _ShardedDispatch(device, mesh, part)
    prepared = {op.name: disp.prepare(op.bp, op.bias) for op in program.convs}
    prepared["fc"] = disp.prepare(program.fc.bp, program.fc.bias)

    stat_masks = {}
    if collect_stats:
        for op in program.convs:
            _, masks = skip_patterns_and_masks(
                op.pattern_bits, op.kernel * op.kernel
            )
            stat_masks[op.name] = torch.as_tensor(masks, device=device)

    # input signatures run, and per-layer time of the traced calls:
    # name -> [calls, total seconds]
    signatures: set = set()
    observed: dict[str, list] = {}

    def _observe(name: str, seconds: float) -> None:
        acc = observed.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += seconds

    layer_events = (
        _LayerEvents([op.name for op in program.convs] + [None, "fc"])
        if device.type == "cuda" else None
    )

    def fn(x, valid=None):
        traced = tracer is not None and tracer.enabled
        trc = tracer if traced else NULL_TRACER
        ev = layer_events.take(_observe) if traced and layer_events else None
        stream = torch.cuda.current_stream(device) if ev else None
        totals = (dict.fromkeys(("rows", "bytes_in", "bytes_out"), 0)
                  if traced else None)
        with trc.span("forward", cat="execute", batch=len(x)) as fsp:
            with trc.span("forward.upload", cat="execute"):
                x = torch.as_tensor(x, device=device)
                if valid is not None:
                    valid = torch.as_tensor(valid, dtype=torch.bool,
                                            device=device)
            shape = tuple(x.shape)
            signatures.add((shape, x.dtype, valid is None))
            if ev:
                ev[0].record(stream)
            counts = {}
            for i, op in enumerate(program.convs, 1):
                with trc.span(
                    f"layer:{op.name}", cat="execute", op="conv"
                ) as sp:
                    x, cnt = _run_conv(
                        op, x, disp, prepared[op.name],
                        stat_masks.get(op.name), valid, trc, totals,
                    )
                    if ev:
                        ev[i].record(stream)
                if traced and not ev:
                    _observe(op.name, sp.dur)
                if cnt is not None:
                    counts[op.name] = cnt
            with trc.span("layer:gap", cat="execute", op="pool"):
                x = x.mean(dim=(2, 3))  # global average pool
                if ev:
                    ev[-2].record(stream)
            with trc.span("layer:fc", cat="execute", op="fc") as sp:
                logits = _run_fc(program.fc, x, disp, prepared["fc"], trc,
                                 totals)
                if ev:
                    ev[-1].record(stream)
            if traced:
                if not ev:
                    _observe("fc", sp.dur)
                fsp.args["layers"] = len(program.convs) + 2
                if totals["rows"]:
                    fsp.args.update(totals)
        if ev:
            layer_events.recorded(ev)
        if not collect_stats:
            return logits
        live = None if valid is None else int(valid.sum())
        stats = stats_from_counts(
            program.convs,
            {k: v.cpu().numpy() for k, v in counts.items()},
            _layer_windows(program, shape, live_rows=live),
        )
        return logits, stats

    def observed_times() -> dict[str, float]:
        if layer_events is not None:
            layer_events.fold(_observe, wait=True)
        return {name: total / calls
                for name, (calls, total) in observed.items()}

    fn.device = device
    fn.trace_count = lambda: len(signatures)
    fn.observed_times = observed_times
    return fn


def warmup_forward(fn, program: CompiledNetwork, batch_slots: int):
    """Run ``fn`` once at the fixed serving batch shape, before traffic.

    One all-dead batch — zeros with an all-``False`` validity mask, the
    signature the serving scheduler executes — then a device sync, so a
    front end pays first-call costs (the kernels' build and load, the
    allocator's first blocks) at boot.  Returns ``fn``.
    """
    cfg = program.config
    x = np.zeros(
        (batch_slots, cfg.conv_channels[0][0], cfg.input_hw, cfg.input_hw),
        np.float32,
    )
    fn(x, np.zeros(batch_slots, bool))
    _sync(fn.device)
    return fn


# `execute`'s per-program forward cache is capped so a long-lived program
# does not pin every device copy (and mesh) it was ever run with.
_FORWARD_CACHE_MAX = 8


def _dispatch_key(device: torch.device, mesh, partition):
    """Stable, value-based cache key for a dispatch configuration.

    Meshes are fingerprinted by dim names, shape, ranks and device type
    rather than object identity, so two equal meshes share one cache
    entry.  ``partition`` is a frozen dataclass and hashes by value.
    """
    mesh_key = None
    if mesh is not None:
        mesh_key = (
            tuple(mesh.mesh_dim_names),
            tuple(int(s) for s in mesh.shape),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()),
            mesh.device_type,
        )
    return (str(device), mesh_key, partition)


def execute(
    program: CompiledNetwork,
    x,
    device: str | torch.device | None = None,
    mesh=None,
    partition=None,
) -> torch.Tensor:
    """One-shot convenience wrapper around :func:`make_forward`.

    The forward is LRU-cached on the program per dispatch configuration
    (device, mesh fingerprint, partition), capped at
    ``_FORWARD_CACHE_MAX`` entries.
    """
    device = (resolve_device(device) if mesh is None
              else _mesh_rank_device(mesh, device))
    cache = program.__dict__.get("_forward_cache")
    if not isinstance(cache, OrderedDict):
        cache = program.__dict__["_forward_cache"] = OrderedDict()
    key = _dispatch_key(device, mesh, partition)
    fwd = cache.get(key)
    if fwd is None:
        fwd = make_forward(program, mesh=mesh, partition=partition,
                           device=device)
        cache[key] = fwd
        while len(cache) > _FORWARD_CACHE_MAX:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return fwd(x)
