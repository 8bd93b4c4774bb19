"""Gradient compression for cross-pod data parallelism.

Port of ``src/repro/optim/compression.py``.  int8 uniform quantization
with *error feedback* (Karimireddy et al., 2019): the quantization
residual is carried to the next step, so compression introduces no
asymptotic bias and SGD converges at the uncompressed rate.

Compressed gradients are a pair of trees ``(int8_tree, scale_tree)`` — 4x
fewer wire bytes than fp32.  The quantization is the reference's
arithmetic step for step (``torch.round`` and ``jnp.round`` both round
half to even), so the int8 values, the scales and the residuals equal
the reference's bit for bit.  ``error_feedback_allreduce`` bundles
compress -> mean over a ``torch.distributed`` group -> decompress, the
reference's ``lax.pmean`` over an axis.  Trees are nested dicts and lists
of tensors.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import _map, _unzip

__all__ = [
    "CompressionState",
    "init_compression_state",
    "compress_gradients",
    "decompress_gradients",
    "error_feedback_allreduce",
]

CompressionState = Any  # tree of fp32 residuals, same structure as grads


def init_compression_state(grads_like) -> CompressionState:
    return _map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with a per-tensor float32 scale."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_gradients(
    grads, state: CompressionState
) -> tuple[tuple[Any, Any], CompressionState]:
    """Quantize (grad + residual) to int8; the residual carries the error.

    Returns ((int8_tree, scale_tree), new_state)."""

    def one(g, r):
        x = g.float() + r
        q, s = _quantize(x)
        return q, s, x - q.float() * s

    qs, scales, residuals = _unzip(_map(one, grads, state), 3)
    return (qs, scales), residuals


@torch.no_grad()
def decompress_gradients(comp: tuple[Any, Any]):
    q_tree, s_tree = comp
    return _map(lambda q, s: q.float() * s, q_tree, s_tree)


@torch.no_grad()
def error_feedback_allreduce(
    grads, state: CompressionState, group=None
) -> tuple[Any, CompressionState]:
    """int8 all-reduce with error feedback over ``group`` (default: the
    world): each rank compresses its gradients, and the dequantized trees
    are summed over the group and divided by its size."""
    comp, new_state = compress_gradients(grads, state)
    n = dist.get_world_size(group)

    def reduce_one(d):
        dist.all_reduce(d, group=group)
        return d / n

    return _map(reduce_one, decompress_gradients(comp)), new_state
