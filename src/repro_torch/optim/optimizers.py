"""Functional optimizers (AdamW / Lion / SGD), schedules and clipping.

Port of ``repro/optim/optimizers.py``.  Each optimizer is a pair of
functions ``init(params) -> state`` and ``update(grads, state, params,
lr) -> (new_params, new_state)`` over nested dicts (and lists) of
tensors.  Updates run under ``torch.no_grad()`` and return new tensors,
never writing into the ones given, in the reference's order of
operations, so a step given the same grads gives the same params to
fp32 rounding.  The optimizer state holds tensors of the params' shapes
on the params' devices.

AdamW writes each leaf's new params and moments into tensors it
allocates once, a piece of at most ``UPDATE_CHUNK`` elements at a time
(:func:`_pieces`), so its float32 temporaries are a piece's, not a
stacked leaf's: the same operations on the same elements, so the same
bits as the whole-leaf expression.

``update(..., donate=True)`` (a donated train step's,
``runtime.train.make_train_step``) takes the grads, the state and the
params as given up: each leaf leaves its container as the update reaches
it (:func:`donated_map`), AdamW writes its float32 moments and the params
into the given tensors, and a moment of another dtype gives way to its
float32 successor, so the update holds one leaf's old and new tensors at
once, not two trees.  The operations are the same, so are the bits.
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
    "UPDATE_CHUNK",
    "donated_map",
]

# elements of a leaf that one pass of AdamW's update covers (float32
# temporaries of 64 MiB each)
UPDATE_CHUNK = 1 << 24


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


def donated_map(fn, owned: int, tree, *rest):
    """``_map(fn, tree, *rest)`` where the first ``owned`` trees (``tree``
    first) are given up: each of their leaves leaves its container (which
    ends holding None) before ``fn`` takes it, so once ``fn`` returns,
    nothing here holds the old leaf."""
    if isinstance(tree, (dict, list)):
        trees = (tree, *rest)
        out: dict | list = {} if isinstance(tree, dict) else []
        for k in (list(tree) if isinstance(tree, dict)
                  else range(len(tree))):
            leaves = [t[k] for t in trees]
            if not isinstance(leaves[0], (dict, list)):
                for t in trees[:owned]:
                    t[k] = None
            v = donated_map(fn, owned, *leaves)
            del leaves
            if isinstance(out, dict):
                out[k] = v
            else:
                out.append(v)
        return out
    return fn(tree, *rest)


def _pieces(t: torch.Tensor, chunk: int) -> tuple:
    """``t`` as views along its first dim of at most ``chunk`` elements
    each (a row at least); a 0-d tensor whole."""
    if t.dim() == 0 or t.shape[0] == 0:
        return (t,)
    rows = max(1, chunk // max(1, t[0].numel()))
    return t.split(rows)


def _unzip(flat, n: int) -> list:
    """A tree of per-leaf ``n``-tuples as ``n`` trees."""
    return [_map(lambda t, i=i: t[i], flat) for i in range(n)]


@torch.no_grad()
def global_norm(tree, reduce: Callable | None = None) -> torch.Tensor:
    """The norm of all leaves together.  ``reduce`` (the sharded train
    step's) takes the list of per-leaf sums of squares and returns it
    with each slab leaf's summed over the ranks that hold its slabs.  A
    leaf of another dtype is squared in its float32 copy, so one copy of
    it is made, not two."""
    sq = [torch.sum(x.float().square_() if x.dtype != torch.float32
                    else torch.square(x)) for x in _leaves(tree)]
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(sum(sq))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float,
                        reduce: Callable | None = None,
                        in_place: bool = False):
    """(``tree`` scaled to ``max_norm`` where its global norm exceeds it,
    the norm); with ``in_place`` the leaves are scaled where they lie."""
    norm = global_norm(tree, reduce)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    if in_place:
        return _map(lambda x: x.mul_(scale.to(x.dtype)), tree), norm
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
    def update(grads, state, params, lr, donate: bool = False):
        count = state["count"] + 1
        c = count.float()
        s1, s2 = 1 - b1**c, 1 - b2**c

        def into(t, dtype):
            """Where a leaf's new value goes: ``t`` itself, donated, if it
            is of ``dtype``; else a new tensor of ``dtype``."""
            if donate and t.dtype == dtype:
                return t
            return torch.empty_like(t, dtype=dtype)

        def upd(g, m, v, p):
            # m' = b1 m + (1 - b1) g, v' = b2 v + (1 - b2) g g,
            # p' = p - lr (m' / s1 / (sqrt(v' / s2) + eps) + wd p),
            # each operation as the whole-leaf expression runs it
            # (bfloat16 moments come back float32, as the reference's do)
            f32 = torch.float32
            new_m = into(m, torch.promote_types(m.dtype, f32))
            new_v = into(v, torch.promote_types(v.dtype, f32))
            new_p = into(p, p.dtype)
            for gc, mc, vc, pc, nm, nv, npc in zip(*(
                    _pieces(t, UPDATE_CHUNK)
                    for t in (g, m, v, p, new_m, new_v, new_p))):
                gc = gc.float()
                torch.add(b1 * mc, (1 - b1) * gc, out=nm)
                torch.add(b2 * vc, (1 - b2) * gc * gc, out=nv)
                del gc
                den = torch.div(nv, s2).sqrt_().add_(eps)
                step = torch.div(nm, s1).div_(den)
                del den
                step.add_(pc.float() * weight_decay)
                torch.sub(pc, lr * step.to(p.dtype), out=npc)
            return new_p, new_m, new_v

        if donate:
            flat = donated_map(upd, 4, grads, state["mu"], state["nu"],
                               params)
        else:
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
    def update(grads, state, params, lr, donate: bool = False):
        def upd(g, m, p):
            g = g.float()
            direction = torch.sign(b1 * m + (1 - b1) * g)
            step = direction + weight_decay * p.float()
            return ((p - lr * step.to(p.dtype)).to(p.dtype),
                    b2 * m + (1 - b2) * g)

        flat = (donated_map(upd, 3, grads, state["mu"], params) if donate
                else _map(upd, grads, state["mu"], params))
        new_params, new_mu = _unzip(flat, 2)
        return new_params, {"mu": new_mu, "count": state["count"] + 1}

    return Optimizer(init, update)


def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": _map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)}

    @torch.no_grad()
    def update(grads, state, params, lr, donate: bool = False):
        def upd(g, m, p):
            m = momentum * m + g.float()
            return (p - lr * m.to(p.dtype)).to(p.dtype), m

        flat = (donated_map(upd, 3, grads, state["mu"], params) if donate
                else _map(upd, grads, state["mu"], params))
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
