"""Functional optimizers (AdamW / Lion / SGD), schedules and clipping.

Port of ``repro/optim/optimizers.py``.  Each optimizer is a pair of
functions ``init(params) -> state`` and ``update(grads, state, params,
lr) -> (new_params, new_state)`` over nested dicts (and lists) of
tensors.  Updates run under ``torch.no_grad()`` and return new tensors,
never writing into the ones given, in the reference's order of
operations, so a step given the same grads gives the same params to
fp32 rounding.  The optimizer state holds tensors of the params' shapes
on the params' devices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = [
    "Optimizer",
    "adamw",
    "lion",
    "sgd",
    "global_norm",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup_cosine",
]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), keeping the structure.  Only
    dicts and lists are containers, so a per-leaf tuple stays a leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _unzip(flat, n: int) -> list:
    """A tree of per-leaf ``n``-tuples as ``n`` trees."""
    return [_map(lambda t, i=i: t[i], flat) for i in range(n)]


@torch.no_grad()
def global_norm(tree, reduce: Callable | None = None) -> torch.Tensor:
    """The norm of all leaves together.  ``reduce`` (the sharded train
    step's) takes the list of per-leaf sums of squares and returns it
    with each slab leaf's summed over the ranks that hold its slabs."""
    sq = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(sum(sq))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float,
                        reduce: Callable | None = None):
    norm = global_norm(tree, reduce)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return _map(lambda x: x * scale.to(x.dtype), tree), norm


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    mu_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=mu_dtype)

        device = _leaves(params)[0].device
        return {
            "mu": _map(zeros, params),
            "nu": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.float()

        def upd(g, m, v, p):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1**c)
            vhat = v / (1 - b2**c)
            step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            return (p - lr * step.to(p.dtype)).to(p.dtype), m, v

        flat = _map(upd, grads, state["mu"], state["nu"], params)
        new_params, new_mu, new_nu = _unzip(flat, 3)
        return new_params, {"mu": new_mu, "nu": new_nu, "count": count}

    return Optimizer(init, update)


def lion(b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        device = _leaves(params)[0].device
        return {
            "mu": _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def update(grads, state, params, lr):
        def upd(g, m, p):
            g = g.float()
            direction = torch.sign(b1 * m + (1 - b1) * g)
            step = direction + weight_decay * p.float()
            return ((p - lr * step.to(p.dtype)).to(p.dtype),
                    b2 * m + (1 - b2) * g)

        flat = _map(upd, grads, state["mu"], params)
        new_params, new_mu = _unzip(flat, 2)
        return new_params, {"mu": new_mu, "count": state["count"] + 1}

    return Optimizer(init, update)


def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        def upd(g, m, p):
            m = momentum * m + g.float()
            return (p - lr * m.to(p.dtype)).to(p.dtype), m

        flat = _map(upd, grads, state["mu"], params)
        new_params, new_mu = _unzip(flat, 2)
        return new_params, {"mu": new_mu}

    return Optimizer(init, update)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        frac = min(max(float(step) / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return base_lr * (min_frac + (1 - min_frac) * cos)

    return lr


def linear_warmup_cosine(
    base_lr: float, warmup_steps: int, total_steps: int, min_frac: float = 0.1
):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), min_frac)

    def lr(step):
        if step < warmup_steps:
            return base_lr * min(1.0, float(step) / max(warmup_steps, 1))
        return cos(step - warmup_steps)

    return lr
