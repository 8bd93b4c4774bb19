"""Tensor-parallel compute over a mesh's ``model`` dim, for the sharded
train step.

The reference has no such module.  Its sharded step is one function
jitted under ``param_shardings`` (``src/repro/launch/train.py``), and
XLA's GSPMD partitioner splits the matmuls over ``model`` by the params'
specs, inserting the collectives itself.  Here the collectives are
explicit, as ``torch.autograd.Function``s over the ``model`` group of a
``DeviceMesh`` (Megatron-style):

  * :func:`copy_to_model`: identity forward, all-reduce backward, where a
    tensor that every model rank holds whole enters a product with the
    rank's slab (its gradient is the sum of the ranks' parts);
  * :func:`reduce_from_model`: all-reduce forward, identity backward, the
    partial sums of a row-parallel product;
  * :func:`gather_from_model`: all-gather along the last dim forward, the
    rank's slice backward, column slabs that what follows needs whole.

Which blocks compute on their slab (:func:`layer_splits`), and so which
param leaves stay slabs (:func:`slab_leaves`), follows from the configs
and the ``model`` size alone, as the slabs ``launch.steps.
param_shardings`` gives do: ``embed`` maps to no mesh axis, so a rank's
slab of a split leaf is its tensor-parallel shard.

  * attention (``attn``, ``swa``, whisper's ``xattn``): column-parallel
    ``wq``/``wk``/``wv`` (biases with them), each rank its own heads,
    row-parallel ``wo``; only where ``model`` divides the padded query
    heads and the key heads, the key/value projections carry the
    ``kv_heads`` axis, and the heads group (``AttnConfig.grouped``);
  * the dense MLP: column-parallel ``up``/``gate``, row-parallel
    ``down``; the sparse MLP: each rank its tiles of every projection,
    the columns gathered (the pattern's tile order and ``inv_order`` span
    all of ``ff``);
  * MoE experts (``expert`` over ``model``), the router and the shared
    experts gathered.

Everything else stays gathered: MLA, the SSM's projections, the
embedding and the head (vocab-parallel cross-entropy is not written),
norms.  Only the sharded step of ``runtime.train`` enters
:func:`tensor_parallel_ctx`; model code reads it in
``models.transformer._apply_layer`` alone, so outside the context every
layer runs as it does without a mesh, serving's sharded paths included.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import _map, mesh_axis_sizes

__all__ = ["TensorParallel", "tensor_parallel_ctx", "current",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "attention_splits", "mlp_splits", "experts_split",
           "layer_splits", "slab_leaves", "data_shards", "gather_over_data"]


@dataclasses.dataclass
class TensorParallel:
    """One context's ``model`` group and what its collectives moved:
    ``reduce_bytes`` all-reduced (forward and backward) and
    ``gather_bytes`` all-gathered (the whole tensors' bytes)."""

    mesh: object
    size: int  # model ranks
    rank: int  # this rank's model coordinate
    group: object
    reduce_bytes: int = 0
    gather_bytes: int = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        out = t.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        self.reduce_bytes += out.numel() * out.element_size()
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.cat(parts, dim=-1)
        self.gather_bytes += out.numel() * out.element_size()
        return out


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "tensor_parallel", default=None)


@contextlib.contextmanager
def tensor_parallel_ctx(mesh):
    """Compute on the ``model`` slabs of ``mesh`` inside the block; yields
    the :class:`TensorParallel` whose counters the block's collectives
    grow."""
    n = mesh_axis_sizes(mesh).get("model", 1)
    tp = TensorParallel(mesh, n, mesh.get_local_rank("model") if n > 1
                        else 0, mesh.get_group("model") if n > 1 else None)
    token = _CTX.set(tp)
    try:
        yield tp
    finally:
        _CTX.reset(token)


def current() -> TensorParallel | None:
    """The innermost context's :class:`TensorParallel`, or None."""
    return _CTX.get()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return tp.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.tp.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` unchanged; its gradient all-reduced over ``tp``'s group."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of ``x`` over ``tp``'s group; the gradient passes as is."""
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last dim, in model order;
    the gradient's slice of this rank goes back."""
    return _GatherFromModel.apply(x, tp)


def attention_splits(cfg, n: int) -> bool:
    """Whether an ``AttnConfig``'s block computes on its heads' slabs over
    ``n`` model ranks: every projection split on a head boundary and the
    heads grouped, so each rank's query heads read its own key heads."""
    return (n > 1 and cfg.grouped and cfg.hq_pad % n == 0
            and cfg.n_kv_heads % n == 0
            and cfg.n_kv_heads * cfg.d_head % cfg.model_shards == 0)


def mlp_splits(static: dict, d_ff: int, n: int) -> bool:
    """Whether an MLP (its ``layers.mlp_static``) computes on its slabs:
    dense, ``ff`` divides over the ranks; sparse, every projection's
    (padded) tiles do."""
    if n <= 1:
        return False
    if static["sparse"] is None:
        return d_ff % n == 0
    return all(static[name]["block_ids"].shape[0] % n == 0
               for name in ("gate", "up", "down") if name in static)


def experts_split(cfg, n: int) -> bool:
    """Whether a ``MoEConfig``'s routed experts split over the ranks."""
    return n > 1 and cfg.n_experts % n == 0


def layer_splits(cfg, static: dict, n: int) -> frozenset:
    """The blocks of one layer (its static, ``cfg`` the model's config)
    that compute on their slabs over ``n`` model ranks: a subset of
    ``{"attn", "xattn", "mlp", "moe"}``."""
    out = set()
    if static["mixer"] in ("attn", "swa", "xattn") and attention_splits(
            static["attn_cfg"], n):
        out.add("attn")
    if static["mixer"] == "xattn" and attention_splits(static["xattn_cfg"],
                                                       n):
        out.add("xattn")
    if static["ffn"] == "mlp" and mlp_splits(static["mlp"], cfg.d_ff, n):
        out.add("mlp")
    if static["ffn"] == "moe" and experts_split(cfg.moe, n):
        out.add("moe")
    return frozenset(out)


def slab_leaves(cfg, statics: dict, tree, n: int):
    """A tree of bools shaped as ``tree`` (the params or their
    placements): True for a leaf that stays on its slab under
    :func:`layer_splits` over ``n`` model ranks."""
    out = _map(lambda _: False, tree)
    layers = [*zip(out["prefix_layers"], statics["prefix_layers"]),
              *zip(out["body"], statics["body"])]
    for key in ("encoder", "mtp_layer"):
        if key in out:
            layers.append((out[key], statics[key]))
    for layer, static in layers:
        for block in layer_splits(cfg, static, n):
            if block == "moe":
                layer["moe"]["experts"] = _map(lambda _: True,
                                               layer["moe"]["experts"])
            else:
                layer[block] = _map(lambda _: True, layer[block])
    return out


def data_shards(mesh) -> tuple[int, int]:
    """(this rank's row block, number of row blocks) over the mesh's
    ``pod`` and ``data`` dims, pod-major as ``data.shard_batch`` cuts
    the batch."""
    sizes = mesh_axis_sizes(mesh)
    r, n = 0, 1
    for a in ("pod", "data"):
        if sizes.get(a, 1) > 1:
            r, n = r * sizes[a] + mesh.get_local_rank(a), n * sizes[a]
    return r, n


def gather_over_data(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` of every row block stacked along a new leading dim, in row
    block order (an all-gather over ``data``, then ``pod``)."""
    sizes = mesh_axis_sizes(mesh)
    out = t[None]
    for a in ("data", "pod"):
        if sizes.get(a, 1) > 1:
            parts = [torch.empty_like(out) for _ in range(sizes[a])]
            dist.all_gather(parts, out.contiguous(), group=mesh.get_group(a))
            out = torch.cat(parts)
    return out

