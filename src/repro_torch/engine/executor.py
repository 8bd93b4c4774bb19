"""Executor: run a ``CompiledNetwork`` through the block-pattern spmm.

Port of ``repro/engine/executor.py`` on one device.  ``make_forward``
returns a batched forward: per conv layer it extracts im2col patches
(conv-as-spmm), dispatches through ``kernels/ops.pattern_spmm`` (the
Hopper kernels on a CUDA device, the plain PyTorch path on the CPU),
which applies the stored inverse output permutation (the Output Indexing
Unit), then bias + ``channel_norm``/ReLU and the 2x2 maxpool where the
schedule says so.  The spmm is the only kernel of the path; im2col, the
permutation gather, norm, pooling and the quantization of activations
are plain PyTorch ops, as they were XLA ops in the reference.

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

Quantized programs run through the same dispatch: ``pattern_spmm`` sees
the int8 bricks + scales and switches to the int8 kernel, quantizing
activations per im2col row on the fly.  An ulp of fp32 noise in one
layer can flip one int8 rounding in the next layer's activation
quantization, so int8 logits agree with another execution of the same
program to one quantization step, not to fp32 noise.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sparse import BlockPatternWeight
from repro_torch.device import resolve_device
from repro_torch.engine.program import CompiledConv, CompiledFC, CompiledNetwork
from repro_torch.engine.stats import skip_patterns_and_masks, stats_from_counts
from repro_torch.kernels.ops import _pad_to, pattern_spmm
from repro_torch.kernels.pattern_spmm import kmajor_bricks
from repro_torch.models.cnn import channel_norm, max_pool_2x2
from repro_torch.obs.trace import Tracer

__all__ = ["extract_patches", "make_forward", "warmup_forward", "execute"]


def extract_patches(x: torch.Tensor, k: int) -> torch.Tensor:
    """im2col for stride-1 'same' convs: [B, C, H, W] -> [B, H, W, C*k*k].

    Feature index is ``c * k*k + (dy*k + dx)``, the layout of
    ``lowering.conv_matrix``; ``F.unfold`` orders its features exactly so
    (channel-major, then kernel row, then kernel column).
    """
    b, c, h, w = x.shape
    cols = F.unfold(x, kernel_size=k, padding=k // 2)  # [B, C*k*k, H*W]
    return cols.transpose(1, 2).reshape(b, h, w, c * k * k)


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
    """Single-device spmm + stat-counter dispatch."""

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

    def spmm(self, x2d: torch.Tensor, prepared: _Prepared) -> torch.Tensor:
        return pattern_spmm(
            x2d, prepared.bp, nnz=prepared.nnz, inv_order=prepared.inv_order,
            w_kmajor=prepared.w_kmajor,
        )

    def counts(self, patches, c_in, kk, masks, row_valid=None):
        return zero_selection_counts(patches, c_in, kk, masks, row_valid)


def _run_conv(
    op: CompiledConv,
    x: torch.Tensor,
    disp: _Dispatch,
    prepared: _Prepared,
    stat_masks: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    b, c, h, w = x.shape
    patches = extract_patches(x, op.kernel).reshape(b * h * w, -1)
    counts = None
    if stat_masks is not None:
        # every patch row belongs to one sample; dead-slot samples are
        # excluded from the skip counters
        row_valid = None if valid is None else valid.repeat_interleave(h * w)
        counts = disp.counts(
            patches, op.c_in, op.kernel * op.kernel, stat_masks, row_valid
        )
    patches = _pad_features(patches, op.bp.k_in)
    y = disp.spmm(patches, prepared)
    y = y[:, : op.c_out] + prepared.bias
    y = y.reshape(b, h, w, op.c_out).permute(0, 3, 1, 2)
    y = torch.relu(channel_norm(y))
    if op.pool_after:
        y = max_pool_2x2(y)
    return y, counts


def _run_fc(
    op: CompiledFC, x: torch.Tensor, disp: _Dispatch, prepared: _Prepared
) -> torch.Tensor:
    xf = _pad_features(x, op.bp.k_in)
    y = disp.spmm(xf, prepared)
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
      mesh, partition: multi-device execution is not ported yet; any
        value raises ``NotImplementedError`` (ROADMAP Queue 1 item 10).
      tracer: with an *enabled* tracer, calls run an instrumented path
        that wraps each layer in a ``layer:<name>`` span and synchronises
        the device after it, so span durations are per-layer wall times,
        accumulated and exposed as ``fn.observed_times()``.
      device: where the forward runs; ``None`` means ``cuda`` and raises
        when there is none.  The program's operands are copied there
        once, here.  On ``cuda`` every spmm launches a Hopper kernel; on
        the CPU it runs the kernel's plain PyTorch version.

    Returns ``fn(x: [B, C, H, W], valid=None) -> logits [B, num_classes]``
    (a tensor on ``device``), or with ``collect_stats`` ``(logits,
    ActivationStats)``.  ``x`` and ``valid`` (bool [B] row-validity mask)
    may be tensors or numpy arrays.  ``channel_norm`` is per-sample, so
    dead rows never influence live logits; their own outputs are
    meaningless.  ``fn.trace_count()`` is the number of distinct input
    shape/dtype signatures the uninstrumented path has run (the
    reference counts jit traces, which are the same thing there).
    """
    if mesh is not None or partition is not None:
        raise NotImplementedError(
            "make_forward(mesh=..., partition=...): multi-device execution "
            "is not ported yet (ROADMAP Queue 1 item 10)"
        )
    device = resolve_device(device)
    disp = _Dispatch(device)
    prepared = {op.name: disp.prepare(op.bp, op.bias) for op in program.convs}
    prepared["fc"] = disp.prepare(program.fc.bp, program.fc.bias)

    stat_masks = {}
    if collect_stats:
        for op in program.convs:
            _, masks = skip_patterns_and_masks(
                op.pattern_bits, op.kernel * op.kernel
            )
            stat_masks[op.name] = torch.as_tensor(masks, device=device)

    signatures: set = set()

    def forward(x: torch.Tensor, valid: torch.Tensor | None):
        counts = {}
        for op in program.convs:
            x, cnt = _run_conv(
                op, x, disp, prepared[op.name], stat_masks.get(op.name),
                valid,
            )
            if cnt is not None:
                counts[op.name] = cnt
        x = x.mean(dim=(2, 3))  # global average pool
        logits = _run_fc(program.fc, x, disp, prepared["fc"])
        return logits, counts

    # per-layer wall time accumulated by the instrumented path:
    # name -> [calls, total seconds on the tracer's clock]
    observed: dict[str, list] = {}

    def _observe(name: str, seconds: float) -> None:
        acc = observed.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += seconds

    def instrumented(x: torch.Tensor, valid: torch.Tensor | None):
        """Layer-by-layer forward: same math, a span and a device sync per
        layer so each span's duration is that layer's wall time."""
        with tracer.span(
            "forward", cat="execute", batch=int(x.shape[0])
        ) as fsp:
            counts = {}
            for op in program.convs:
                with tracer.span(
                    f"layer:{op.name}", cat="execute", op="conv"
                ) as sp:
                    x, cnt = _run_conv(
                        op, x, disp, prepared[op.name],
                        stat_masks.get(op.name), valid,
                    )
                    _sync(device)
                _observe(op.name, sp.dur)
                if cnt is not None:
                    counts[op.name] = cnt
            with tracer.span("layer:gap", cat="execute", op="pool"):
                x = x.mean(dim=(2, 3))
                _sync(device)
            with tracer.span("layer:fc", cat="execute", op="fc") as sp:
                logits = _run_fc(program.fc, x, disp, prepared["fc"])
                _sync(device)
            _observe("fc", sp.dur)
            fsp.args["layers"] = len(program.convs) + 2
        return logits, counts

    def fn(x, valid=None):
        x = torch.as_tensor(x, device=device)
        if valid is not None:
            valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
        if tracer is not None and tracer.enabled:
            logits, counts = instrumented(x, valid)
        else:
            signatures.add((tuple(x.shape), x.dtype, valid is None))
            logits, counts = forward(x, valid)
        if not collect_stats:
            return logits
        live = None if valid is None else int(valid.sum())
        stats = stats_from_counts(
            program.convs,
            {k: v.cpu().numpy() for k, v in counts.items()},
            _layer_windows(program, x.shape, live_rows=live),
        )
        return logits, stats

    fn.device = device
    fn.trace_count = lambda: len(signatures)
    fn.observed_times = lambda: {
        name: total / calls for name, (calls, total) in observed.items()
    }
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
# does not pin every device copy it was ever run with.
_FORWARD_CACHE_MAX = 8


def execute(
    program: CompiledNetwork,
    x,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """One-shot convenience wrapper around :func:`make_forward`.

    The forward is LRU-cached on the program per device, capped at
    ``_FORWARD_CACHE_MAX`` entries.
    """
    device = resolve_device(device)
    cache = program.__dict__.get("_forward_cache")
    if not isinstance(cache, OrderedDict):
        cache = program.__dict__["_forward_cache"] = OrderedDict()
    key = str(device)
    fwd = cache.get(key)
    if fwd is None:
        fwd = make_forward(program, device=device)
        cache[key] = fwd
        while len(cache) > _FORWARD_CACHE_MAX:
            cache.popitem(last=False)
    else:
        cache.move_to_end(key)
    return fwd(x)
