"""Tensor-parallel compute over a mesh's ``model`` dim, for the sharded
train step and the placed serving steps.

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
    rank's slice backward, column slabs that what follows needs whole;
  * :func:`relayout_columns`: a leaf's columns re-laid out from the
    ranks' storage slabs to the columns each rank computes with (an
    all-to-all forward; backward, each column's gradient back to the
    rank that stores it, summed over the ranks that read it).

The residual stream between layers is split over ``model`` along the
sequence where ``model`` divides it (:func:`seq_splits`, the reference's
``("batch", "seq_shard", None)`` constraint): each rank holds the
positions ``[r S / n, (r + 1) S / n)`` and the norms and residual adds
run on that slab.  Three more Functions move it (dim 1 throughout):

  * :func:`gather_sequence`: all-gather forward, where a block reads
    the whole sequence; backward, the reduce-scatter of the ranks'
    gradient parts (a split block, in place of ``copy_to_model``) or,
    ``whole=True``, this rank's slice (a block every rank computes whole,
    whose gradient is whole on every rank already);
  * :func:`scatter_sequence`: reduce-scatter forward, in place of a row
    product's all-reduce; all-gather backward;
  * :func:`split_sequence`: this rank's slice forward, all-gather
    backward: a whole output (or the stream's entry) onto the slab, so
    what computed it gets its whole gradient on every rank.

A whole leaf that computes on the slab (a norm's scale, the MTP
projection, whisper's learned positions) enters by ``copy_to_model``: its
gradient, this rank's tokens' share, sums over ``model`` in float32.
:func:`count_once` passes a whole computation's gradient on one rank
only, where it meets split blocks' parts in one reduce-scatter (MoE's
router beside its experts).

One rounding rule holds for every block: each all-reduce and
reduce-scatter over ``model`` (a row product's partial sums, a whole
input's gradient parts, a norm's or the cross-entropy's statistics) runs
in float32 and rounds once to the tensor's dtype, and the column and row
products of every split block (:func:`column_product`,
:func:`row_product`) accumulate in float32 and round once, as one
product over the whole width does.  :func:`model_bytes` reckons from the
shapes what each layer moves (:func:`_layer_moves`), as the sharded
step's ``step.comm`` counts it.

Which blocks compute on their slab (:func:`layer_splits`), and so which
param leaves stay slabs (:func:`slab_leaves`), follows from the configs
and the ``model`` size alone, as the slabs ``launch.steps.
param_shardings`` gives do: ``embed`` maps to no mesh axis, so a rank's
slab of a split leaf is its tensor-parallel shard.

  * attention (``attn``, ``swa``, whisper's ``xattn``), wherever
    ``model`` divides the padded query heads: column-parallel ``wq``,
    each rank its query heads, row-parallel ``wo``.  Where ``model``
    divides the key heads too, the key/value projections carry the
    ``kv_heads`` axis and the heads group (:func:`attention_splits`),
    ``wk``/``wv`` are the rank's key heads' slabs.  Elsewhere (MQA's one
    key head, phi3's 10 under 48 padded query heads, whisper's 12 under
    16) each rank computes the key heads its query heads read
    (:func:`attention_kv_heads`, ``_expand_kv``'s map), their
    ``wk``/``wv`` columns re-laid out from the storage slabs, or taken
    from whole leaves;
  * the dense MLP: column-parallel ``up``/``gate``, row-parallel
    ``down``; the sparse MLP: each rank its tiles of every projection,
    the columns gathered (the pattern's tile order and ``inv_order`` span
    all of ``ff``);
  * MoE experts (``expert`` over ``model``), and the shared experts'
    dense MLP as the dense MLP; the router is whole;
  * MLA (``mla``): column-parallel ``wq_b``/``wkv_b`` and row-parallel
    ``wo`` on ``n_heads / n`` whole heads each, only where ``model``
    divides the heads; the latent projections and their norms (no mesh
    axis) whole;
  * the SSM (``ssm``): each rank its heads, only where ``model`` divides
    the heads and the packed widths of ``in_proj`` and the conv (and the
    groups divide the ranks or the ranks the groups): the storage slabs
    of ``in_proj``/``conv_w``/``conv_b`` mix z, x, B, C and dt, so their
    columns are re-laid out (:func:`relayout_columns`) to the rank's
    heads' z, x and dt and its groups' B and C; ``A_log``/``D``/
    ``dt_bias`` are head slabs, ``out_proj`` row-parallel;
  * the embedding and the head (:func:`vocab_splits`, where ``model``
    divides the padded vocabulary): each rank its rows of the table,
    the lookup masked and all-reduced, the logits a slab of columns that
    ``runtime.train.cross_entropy`` reduces over ``model``.

Where a single key head (MQA) or a single SSM group is read by every
rank, the re-layout hands each rank that head's ``wk``/``wv`` columns,
or all of B's and C's, whole: for those columns it moves as much as a
gather of them would.

What stays gathered is what does not divide so (attention whose padded
query heads do not divide over ``model``, an MLP whose ``ff`` or tiles
do not); norms, routers and MLA's latent projections are whole leaves.

The placed serving steps (``runtime.serve`` with ``shardings=``) compute
the same way, with a cache placed as ``launch.steps.cache_pspec`` places
it (positions over ``model``, rows over ``data``, :func:`serve_rows`):
:func:`write_positions` moves the new keys and values of each rank's key
heads to the ranks whose position slabs hold them (all-to-all),
:func:`read_positions` gives a decode its key heads at every position,
:func:`gather_cache` gathers a leaf over ``model`` (MLA's latents, a
block that computes whole), :func:`write_own` writes what a rank's slab
holds, and :func:`columns_to_slabs` lays an SSM's conv window back onto
its storage slabs.  :func:`serve_bytes` reckons what a placed step moves.

Only the sharded step of ``runtime.train`` and the placed serving steps
enter :func:`tensor_parallel_ctx`; model code reads it in
``models.transformer`` alone (``_apply_layer``, the lookup and the
head), so outside the context every layer runs as it does without a
mesh.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import _map, mesh_axis_sizes

__all__ = ["TensorParallel", "tensor_parallel_ctx", "entered", "current",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "gather_sequence", "scatter_sequence", "split_sequence",
           "count_once", "relayout_columns", "column_product", "row_product",
           "seq_splits", "attention_splits", "attention_kv_heads",
           "kv_split", "mlp_splits", "experts_split", "mla_splits",
           "ssm_splits", "vocab_splits", "layer_splits",
           "slab_leaves", "model_bytes", "data_shards", "gather_over_data",
           "reduce_scatter", "columns_to_slabs", "owned_heads",
           "write_positions", "read_positions", "gather_cache", "write_own",
           "serve_rows", "serve_bytes", "serve_comm_by_kind",
           "SERVE_COMM", "serve_comm", "check_slabs", "SEQ_LEAVES",
           "serve_row_dims", "serve_pods", "share_rows", "gather_pods",
           "moe_per_block"]


@dataclasses.dataclass
class TensorParallel:
    """One context's ``model`` group and what its collectives moved:
    ``reduce_bytes`` all-reduced (forward and backward), ``gather_bytes``
    all-gathered along the last dim (the whole tensors' bytes),
    ``relayout_bytes`` re-laid out (each rank's assembled columns forward
    and their gradients backward), ``scatter_bytes`` reduce-scattered
    along the sequence (the slabs' bytes) and ``seq_gather_bytes``
    all-gathered along the sequence (the whole tensors' bytes).

    A placed serving step (``runtime.serve``) also counts its cache's
    traffic over ``model``: ``cache_gather_bytes`` all-gathered (the
    outputs') and ``cache_exchange_bytes`` moved all-to-all (what each
    rank receives); ``data_gather_bytes``, MoE's per-expert counts
    all-gathered over the row dims where it counts capacity over the
    whole batch (not :func:`moe_per_block`); and ``pod_gather_bytes``,
    the rows each pod wrote of a cache slab that every pod holds,
    all-gathered over ``pod`` (:func:`share_rows`).  ``rows`` is then
    the rank's row block of the batch (block, blocks, the mesh dims the
    blocks span, inner first: :func:`serve_rows`, :func:`serve_row_dims`),
    MoE's blocks."""

    mesh: object
    size: int  # model ranks
    rank: int  # this rank's model coordinate
    group: object
    reduce_bytes: int = 0
    gather_bytes: int = 0
    relayout_bytes: int = 0
    scatter_bytes: int = 0
    seq_gather_bytes: int = 0
    cache_gather_bytes: int = 0
    cache_exchange_bytes: int = 0
    data_gather_bytes: int = 0
    pod_gather_bytes: int = 0
    rows: tuple | None = None

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the group in float32, rounded once to its
        dtype."""
        out = t.float().contiguous().clone()
        dist.all_reduce(out, op=op, group=self.group)
        self.reduce_bytes += out.numel() * out.element_size()
        return out.to(t.dtype)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.cat(parts, dim=-1)
        self.gather_bytes += out.numel() * out.element_size()
        return out

    def gather_seq(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along dim 1, in model order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        out = torch.cat(parts, dim=1)
        self.seq_gather_bytes += out.numel() * out.element_size()
        return out

    def scatter_seq(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slab along dim 1 of ``t`` summed over the group,
        in float32, rounded once to ``t``'s dtype."""
        out = reduce_scatter(t.float(), 1, self.group)
        self.scatter_bytes += out.numel() * out.element_size()
        return out.to(t.dtype)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's slab of it: dim
    ``dim`` cut into as many equal contiguous slabs as the group has
    ranks, in group rank order (``reduce_scatter_tensor`` cuts dim 0, so
    ``dim`` moves to the front and back).  gloo takes CPU tensors here,
    so CUDA ones go through host memory."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    staged = x.device.type == "cuda" and "gloo" in str(
        dist.get_backend(group))
    if staged:
        x, out = x.cpu(), out.cpu()
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


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
    with entered(tp):
        yield tp


@contextlib.contextmanager
def entered(tp: TensorParallel | None):
    """Compute inside ``tp``'s context again (None: outside any), its
    counters growing on: a remat's recompute in the backward
    (``models.transformer._remat``), which autograd may run on a thread
    of its own."""
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


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dtype, whole):
        ctx.tp, ctx.dtype, ctx.whole, ctx.width = tp, x.dtype, whole, \
            x.shape[1]
        return tp.gather_seq(x).to(dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.whole:
            lo = ctx.tp.rank * ctx.width
            g = g[:, lo:lo + ctx.width].contiguous()
        else:
            g = ctx.tp.scatter_seq(g.float())
        return g.to(ctx.dtype), None, None, None


class _ScatterSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dtype):
        ctx.tp, ctx.dtype = tp, x.dtype
        return tp.scatter_seq(x).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather_seq(g).to(ctx.dtype), None, None


class _SplitSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        w = x.shape[1] // tp.size
        return x[:, tp.rank * w:(tp.rank + 1) * w].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather_seq(g), None


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.tp.rank == 0 else torch.zeros_like(g)), None


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slab, cols, tp):
        ctx.tp, ctx.width = tp, slab.shape[-1]
        w = ctx.width
        mine = cols[tp.rank]
        owner = [c // w for c in mine]
        # this rank's columns, grouped by the rank that stores them
        ctx.order = sorted(range(len(mine)), key=lambda i: owner[i])
        ctx.counts = [owner.count(p) for p in range(tp.size)]
        # the columns of this rank's slab each rank reads, in its order
        ctx.sent = [[c - tp.rank * w for c in q_cols
                     if tp.rank * w <= c < (tp.rank + 1) * w]
                    for q_cols in cols]
        parts = _exchange([slab[..., idx] for idx in ctx.sent], ctx.counts,
                          tp)
        out = slab.new_empty((*slab.shape[:-1], len(mine)))
        out[..., ctx.order] = torch.cat(parts, dim=-1)
        tp.relayout_bytes += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        tp.relayout_bytes += g.numel() * g.element_size()
        g = g[..., ctx.order]
        bounds = [0]
        for c in ctx.counts:
            bounds.append(bounds[-1] + c)
        parts = _exchange([g[..., bounds[p]:bounds[p + 1]]
                           for p in range(tp.size)],
                          [len(idx) for idx in ctx.sent], tp)
        out = g.new_zeros((*g.shape[:-1], ctx.width))
        for idx, part in zip(ctx.sent, parts):  # in rank order
            out[..., idx] += part
        return out, None, None


def _exchange(pieces: list, counts: list, tp: TensorParallel) -> list:
    """All-to-all over ``tp``'s group of column blocks: ``pieces[q]``
    (``[..., k_q]``) goes to rank ``q``; returns the blocks each rank
    ``p`` sent here, ``counts[p]`` columns each.  gloo moves CUDA tensors
    through host memory here, as its all-to-all takes CPU tensors."""
    lead = pieces[0].shape[:-1]
    rows = lead.numel()
    dev = pieces[0].device
    staged = dev.type == "cuda" and "gloo" in str(dist.get_backend(tp.group))
    flat = torch.cat([p.movedim(-1, 0).reshape(-1) for p in pieces])
    out = flat.new_empty(sum(counts) * rows)
    if staged:
        flat, out = flat.cpu(), out.cpu()
    dist.all_to_all_single(out, flat, [c * rows for c in counts],
                           [p.shape[-1] * rows for p in pieces],
                           group=tp.group)
    out = out.to(dev)
    return [blk.reshape(c, *lead).movedim(0, -1)
            for blk, c in zip(out.split([c * rows for c in counts]),
                              counts)]


def columns_to_slabs(local: torch.Tensor, cols: list, width: int,
                     tp: TensorParallel) -> torch.Tensor:
    """The inverse of :func:`relayout_columns`, forward only: this rank's
    storage slab (the columns ``[r W / n, (r + 1) W / n)`` of a leaf of
    ``width`` W) from the columns ``cols[p]`` each rank ``p`` holds
    (``local``, in that order), each column taken from the first rank
    that holds it (an all-to-all; ``relayout_bytes`` its output)."""
    n, me = tp.size, tp.rank
    w = width // n
    src: dict = {}
    for p, cs in enumerate(cols):
        for c in cs:
            src.setdefault(c, p)
    at = {c: i for i, c in enumerate(cols[me])}
    sent = [[at[c] for c in range(q * w, (q + 1) * w) if src[c] == me]
            for q in range(n)]
    got = [[c - me * w for c in range(me * w, (me + 1) * w) if src[c] == p]
           for p in range(n)]
    parts = _exchange([local[..., idx] for idx in sent],
                      [len(idx) for idx in got], tp)
    out = local.new_empty((*local.shape[:-1], w))
    for idx, part in zip(got, parts):
        out[..., idx] = part
    tp.relayout_bytes += out.numel() * out.element_size()
    return out


def owned_heads(heads: list) -> list:
    """Each rank's share of the key heads that ``heads`` (per rank, the
    heads it computes) cover: a head every rank of a list reads is
    written by the first of them."""
    seen: set = set()
    out = []
    for hs in heads:
        out.append([h for h in hs if h not in seen])
        seen.update(hs)
    return out


def _spans(pl, tp: TensorParallel) -> list:
    """Each model rank's positions (dim 1) of a cache leaf placed as
    ``pl``: equal contiguous slabs where ``model`` splits them, else all
    of them on every rank."""
    t = pl.shape[1]
    if pl.blocks[1] == 1:
        return [range(0, t)] * tp.size
    if pl.pspec[1] != "model" or pl.blocks[1] != tp.size:
        raise ValueError(f"cache positions placed as {pl.pspec} over "
                         f"{pl.shape}: only model splits them")
    w = t // tp.size
    return [range(q * w, (q + 1) * w) for q in range(tp.size)]


def _all_to_all(pieces: list, shapes: list, tp: TensorParallel) -> list:
    """``pieces[q]`` to rank ``q`` over ``tp``'s group; returns the
    tensors each rank ``p`` sent here, of ``shapes[p]`` (gloo moves CUDA
    tensors through host memory); ``cache_exchange_bytes`` grows by what
    arrives."""
    dev = pieces[0].device
    flat = torch.cat([p.reshape(-1) for p in pieces])
    sizes = [math.prod(s) for s in shapes]
    out = flat.new_empty(sum(sizes))
    if dev.type == "cuda" and "gloo" in str(dist.get_backend(tp.group)):
        flat, out = flat.cpu(), out.cpu()
    dist.all_to_all_single(out, flat, sizes, [p.numel() for p in pieces],
                           group=tp.group)
    tp.cache_exchange_bytes += out.numel() * out.element_size()
    out = out.to(dev)
    return [blk.reshape(s) for blk, s in zip(out.split(sizes), shapes)]


def write_positions(slab: torch.Tensor, pl, new: torch.Tensor, pos: int,
                    heads: list, tp: TensorParallel) -> None:
    """Write ``new`` ``[B, s, H_r, ...]``, the positions ``[pos, pos + s)``
    of the key heads ``heads[rank]`` this rank computed (in that order),
    into the ranks whose slabs (``pl``: positions over ``model``, every
    key head) hold them: each rank sends the heads it owns
    (:func:`owned_heads`) of each rank's written positions, all-to-all,
    and writes what it receives, in the slab's dtype."""
    spans = _spans(pl, tp)
    owned = owned_heads(heads)
    me = tp.rank
    mine = [heads[me].index(h) for h in owned[me]]

    def cut(q):
        lo, hi = max(pos, spans[q].start), min(pos + new.shape[1],
                                                spans[q].stop)
        return lo, max(lo, hi)

    lead, tail = new.shape[0], tuple(new.shape[3:])
    src = new[:, :, mine].to(slab.dtype)
    lo, hi = cut(me)
    parts = _all_to_all(
        [src[:, cut(q)[0] - pos:cut(q)[1] - pos] for q in range(tp.size)],
        [(lead, hi - lo, len(owned[p]), *tail) for p in range(tp.size)], tp)
    if hi > lo:
        for hs, part in zip(owned, parts):
            if hs:
                slab[:, lo - spans[me].start:hi - spans[me].start, hs] = part


def read_positions(slab: torch.Tensor, pl, lo: int, hi: int, heads: list,
                   tp: TensorParallel) -> torch.Tensor:
    """This rank's key heads ``heads[rank]`` at the positions ``[lo, hi)``
    from the ranks' slabs (``pl``: positions over ``model``), ``[B, hi -
    lo, len(heads[rank]), ...]``: each rank sends each rank its heads at
    the positions it holds, all-to-all (where ``model`` does not split
    the positions, the rank's own slab holds them all)."""
    spans = _spans(pl, tp)
    me = tp.rank
    if pl.blocks[1] == 1:
        return slab[:, lo:hi, heads[me]]

    def cut(q):
        a, b = max(lo, spans[q].start), min(hi, spans[q].stop)
        return a - spans[q].start, max(a, b) - spans[q].start

    here = cut(me)
    lead, tail = slab.shape[0], tuple(slab.shape[3:])
    parts = _all_to_all(
        [slab[:, here[0]:here[1], heads[q]] for q in range(tp.size)],
        [(lead, cut(p)[1] - cut(p)[0], len(heads[me]), *tail)
         for p in range(tp.size)], tp)
    return torch.cat(parts, dim=1)


def gather_cache(slab: torch.Tensor, pl, tp: TensorParallel) -> torch.Tensor:
    """A cache leaf whole over ``model`` from the ranks' slabs (``pl``):
    all-gathered along the dim ``model`` splits (positions, an SSM's conv
    columns or its state's heads; ``cache_gather_bytes``), or the slab
    itself where ``model`` splits none.  Its rows stay the rank's."""
    for d, (entry, n) in enumerate(zip(pl.pspec, pl.blocks)):
        if n > 1 and entry == "model":
            parts = [torch.empty_like(slab) for _ in range(tp.size)]
            dist.all_gather(parts, slab.contiguous(), group=tp.group)
            out = torch.cat(parts, dim=d)
            tp.cache_gather_bytes += out.numel() * out.element_size()
            return out
    return slab


def write_own(slab: torch.Tensor, pl, whole: torch.Tensor, pos: int | None,
              s: int = 0) -> None:
    """Write into this rank's slab (``pl``) of a cache leaf its part of
    ``whole``, the rank's rows of the leaf over ``model``: the positions
    ``[pos, pos + s)`` of ``whole`` [B, s, ...] that the slab holds, or,
    with ``pos`` None, the slab's part of the whole leaf (an SSM's conv or
    state), in the slab's dtype."""
    if pos is None:
        slab.copy_(whole[(slice(None),) + pl.slices[1:]])
        return
    seq = pl.slices[1]
    lo, hi = max(pos, seq.start), min(pos + whole.shape[1], seq.stop)
    if lo < hi:
        slab[:, lo - seq.start:hi - seq.start] = whole[
            :, lo - pos:hi - pos].to(slab.dtype)


def relayout_columns(slab: torch.Tensor, cols: list,
                     tp: TensorParallel) -> torch.Tensor:
    """Columns of a leaf stored as equal contiguous slabs of its last dim
    (rank ``p`` the columns ``[p W / n, (p + 1) W / n)`` of ``W``),
    assembled on each rank in the order ``cols[rank]`` lists them
    (global column indices; ``cols`` holds every rank's list).  The
    gradient of each assembled column goes back to the rank that stores
    it, summed in rank order over the ranks that read it."""
    return _Relayout.apply(slab, cols, tp)


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


def gather_sequence(x: torch.Tensor, tp: TensorParallel, dtype=None,
                    whole: bool = False) -> torch.Tensor:
    """The ranks' slabs ``x`` ``[B, S / n, ...]`` of the sequence
    concatenated along dim 1 in model order, gathered in ``x``'s dtype
    and returned in ``dtype`` (default ``x``'s).  Backward: the ranks'
    gradient parts summed in float32 and this rank's slab rounded once
    to ``x``'s dtype (a reduce-scatter); with ``whole``, the rank's slice
    of a gradient every rank holds whole."""
    return _GatherSequence.apply(x, tp, dtype or x.dtype, whole)


def scatter_sequence(x: torch.Tensor, tp: TensorParallel,
                     dtype=None) -> torch.Tensor:
    """This rank's slab along dim 1 of the sum of ``x`` over the group,
    summed in float32 and rounded once to ``dtype`` (default ``x``'s);
    the gradient all-gathered."""
    return _ScatterSequence.apply(x, tp, dtype or x.dtype)


def split_sequence(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """This rank's slab along dim 1 of ``x``, which every rank holds
    whole; the gradient all-gathered, so it is whole on every rank."""
    return _SplitSequence.apply(x, tp)


def count_once(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x`` unchanged; its gradient, the same on every rank, passed on
    rank 0 alone (zeros on the others), so a sum over the group counts it
    once."""
    return _CountOnce.apply(x, tp)


def seq_splits(n: int, seq: int) -> bool:
    """Whether a stream of ``seq`` positions splits over ``n`` model ranks
    (``logical_to_pspec`` keeps a dim that does not divide whole)."""
    return n > 1 and seq % n == 0


def column_product(x: torch.Tensor, params, tp: TensorParallel, dtype,
                   seq: bool = False, gathered: bool = False):
    """``linear(p, x)`` for ``params`` (one linear's, or a list of them,
    each this rank's column slab) over the whole input: ``x``, whole on
    every rank, enters once by ``copy_to_model`` in float32; with
    ``seq`` it is this rank's slab of the sequence, all-gathered
    (:func:`gather_sequence`); ``gathered``: it was gathered so already.
    Each product accumulates in float32 and rounds once to ``dtype``, as
    one product over all the columns does, and the ranks' parts of
    ``x``'s gradient sum in float32 before their one rounding.  A list
    gives a list."""
    if gathered:
        x32 = x.float()
    elif seq:
        x32 = gather_sequence(x, tp, torch.float32)
    else:
        x32 = copy_to_model(x.float(), tp)
    out = []
    for p in params if isinstance(params, list) else [params]:
        y = x32 @ p["w"].float()
        out.append((y + p["b"].float() if "b" in p else y).to(dtype))
    return out if isinstance(params, list) else out[0]


def row_product(x: torch.Tensor, params: dict, tp: TensorParallel,
                dtype, seq: bool = False) -> torch.Tensor:
    """``linear`` of the whole input whose rows' slab ``x`` this rank
    holds, on its row slab ``params``: the ranks' float32 partial
    products summed over the group in float32, then rounded once to
    ``dtype`` (the bias, whole, added once).  With ``seq`` the sum is
    reduce-scattered: this rank's slab of the sequence."""
    y = x.float() @ params["w"].float()
    y = scatter_sequence(y, tp) if seq else reduce_from_model(y, tp)
    if "b" in params:
        y = y + params["b"].float()
    return y.to(dtype)


def attention_splits(cfg, n: int) -> bool:
    """Whether an ``AttnConfig``'s block computes on its heads' slabs over
    ``n`` model ranks: every projection split on a head boundary and the
    heads grouped, so each rank's query heads read its own key heads."""
    return (n > 1 and cfg.grouped and cfg.hq_pad % n == 0
            and cfg.n_kv_heads % n == 0
            and cfg.n_kv_heads * cfg.d_head % cfg.model_shards == 0)


def attention_kv_heads(cfg, n: int) -> list:
    """For each of ``n`` model ranks, the key heads (ascending) that its
    query heads ``[r Hq / n, (r + 1) Hq / n)`` read, by ``_expand_kv``'s
    map: query head ``h`` reads ``h // (Hq / Hkv)`` where the heads group,
    ``h // ceil(Hq / Hkv)`` where they do not (padded heads too)."""
    hq, hkv = cfg.hq_pad, cfg.n_kv_heads
    rep = hq // hkv if cfg.grouped else -(-hq // hkv)
    per = hq // n
    return [sorted({h // rep for h in range(r * per, (r + 1) * per)})
            for r in range(n)]


def kv_split(cfg, n: int) -> bool:
    """Whether an ``AttnConfig``'s ``wk``/``wv`` are stored as slabs of
    their columns over ``n`` model ranks (``attention_specs`` gives them
    the ``kv_heads`` axis and ``n`` divides their width)."""
    w = cfg.n_kv_heads * cfg.d_head
    return n > 1 and w % cfg.model_shards == 0 and w % n == 0


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


def mla_splits(cfg, n: int) -> bool:
    """Whether an ``MLAConfig``'s block computes on its heads' slabs over
    ``n`` model ranks: ``n_heads / n`` whole heads each."""
    return n > 1 and cfg.n_heads % n == 0


def ssm_splits(cfg, n: int) -> bool:
    """Whether an ``SSMConfig``'s block computes on its heads over ``n``
    model ranks: ``n`` divides the heads (so ``out_proj``'s ``d_inner``
    rows are whole heads a rank), the packed widths of ``in_proj``
    (``2 d_inner + 2 G N + H``) and of the conv (``d_inner + 2 G N``), as
    the storage slabs need, and the groups divide the ranks or the ranks
    the groups (each rank's heads read whole groups, or one)."""
    h, g = cfg.n_heads, cfg.n_groups
    return (n > 1 and h % n == 0
            and (2 * cfg.d_inner + 2 * g * cfg.d_state + h) % n == 0
            and cfg.conv_dim % n == 0 and (g % n == 0 or n % g == 0))


def vocab_splits(cfg, n: int) -> bool:
    """Whether the embedding and the head compute on their vocabulary
    slabs over ``n`` model ranks: ``n`` divides the padded vocabulary,
    as ``logical_to_pspec`` splits it."""
    return n > 1 and cfg.padded_vocab % n == 0


def layer_splits(cfg, static: dict, n: int) -> frozenset:
    """The blocks of one layer (its static, ``cfg`` the model's config)
    that compute on their slabs over ``n`` model ranks: a subset of
    ``{"attn", "xattn", "mla", "ssm", "mlp", "moe", "moe_shared"}``.
    Attention splits wherever ``n`` divides its padded query heads (the
    key heads by :func:`attention_splits`, or re-laid out)."""
    out = set()
    mixer = static["mixer"]

    def attends(key):
        return n > 1 and static[key].hq_pad % n == 0

    if mixer in ("attn", "swa", "xattn") and attends("attn_cfg"):
        out.add("attn")
    if mixer == "xattn" and attends("xattn_cfg"):
        out.add("xattn")
    if mixer == "mla" and mla_splits(static["mla_cfg"], n):
        out.add("mla")
    if mixer == "ssm" and ssm_splits(static["ssm_cfg"], n):
        out.add("ssm")
    if static["ffn"] == "mlp" and mlp_splits(static["mlp"], cfg.d_ff, n):
        out.add("mlp")
    if static["ffn"] == "moe":
        if experts_split(cfg.moe, n):
            out.add("moe")
        moe = cfg.moe
        d_ff_shared = moe.d_ff_shared or moe.n_shared * moe.d_ff_expert
        if "shared" in static["moe"] and mlp_splits(
                static["moe"]["shared"], d_ff_shared, n):
            out.add("moe_shared")
    return frozenset(out)


_KINDS = ("reduce", "scatter", "gather", "relayout")


def _zero() -> dict:
    return dict.fromkeys(_KINDS, 0)


def _add(into: dict, moves: dict, times: int = 1) -> None:
    for k in _KINDS:
        into[k] += times * moves[k]


def _attention_kv_moves(cfg, n: int, rank: int) -> tuple[int, int]:
    """(param elements re-laid out each way, param elements all-reduced
    backward) of an ``AttnConfig``'s split block on model rank ``rank``:
    none where the key heads split with the query heads; else the
    ``wk``/``wv`` columns (biases too) of the key heads the rank's query
    heads read, re-laid out from their storage slabs, or, where those
    leaves are whole, the whole leaves' gradients summed."""
    if attention_splits(cfg, n):
        return 0, 0
    rows = cfg.d_model + cfg.qkv_bias
    if kv_split(cfg, n):
        heads = len(attention_kv_heads(cfg, n)[rank])
        return 2 * rows * heads * cfg.d_head, 0
    return 0, 2 * rows * cfg.n_kv_heads * cfg.d_head


def _ssm_relayout(cfg, n: int) -> int:
    """Param elements an ``SSMConfig``'s split block re-lays out each way:
    the rank's columns of ``in_proj`` (its heads' z, x and dt, its groups'
    B and C) and of the conv's weight and bias."""
    g = max(1, cfg.n_groups // n)
    ch = cfg.d_inner // n + 2 * g * cfg.d_state
    cols = ch + cfg.d_inner // n + cfg.n_heads // n
    return cfg.d_model * cols + (cfg.d_conv + 1) * ch


def _layer_moves(cfg, static: dict, n: int, tokens: int, memory: int | None,
                 seq: bool, mem_seq: bool, rank: int = 0):
    """(forward, backward) bytes, by kind (``_KINDS``: all-reduced,
    reduce-scattered, all-gathered along the sequence, re-laid out), that
    one call of a layer moves over ``n`` model ranks on ``tokens`` tokens
    of its stream (``memory`` the encoder's, cross-attention), the stream
    split along the sequence where ``seq`` (the memory where
    ``mem_seq``), as ``models.transformer._apply_layer_tp`` runs it:

      * a split block's input enters its column products by
        ``copy_to_model`` (its gradient all-reduced) or, split, by
        :func:`gather_sequence` (gathered in the compute dtype, its
        gradient reduce-scattered in float32); its output leaves by an
        all-reduce or, split, a reduce-scatter (float32) whose gradient
        is all-gathered;
      * a block that stays whole, on a split stream, gathers its input
        (the gradient's slice goes back) and splits its output (its
        gradient all-gathered);
      * each block's own collectives: MLA's latents' gradients, the
        SSM's statistics and their gradients, the sparse
        MLP's hidden gradient, MoE's top-k weights', attention's key
        columns;
      * on a split stream, each norm's leaves' gradients, all-reduced."""
    d = cfg.d_model
    c = torch.empty((), dtype=cfg.cdtype()).element_size()
    p = torch.empty((), dtype=cfg.pdtype()).element_size()
    t, m = tokens, memory or 0
    split = layer_splits(cfg, static, n)
    f, b = _zero(), _zero()

    def enter():
        if seq:
            f["gather"] += t * d * c
            b["scatter"] += t // n * d * 4
        else:
            b["reduce"] += t * d * 4

    def leave():  # a row product's float32 partial sums
        if seq:
            f["scatter"] += t // n * d * 4
            b["gather"] += t * d * 4
        else:
            f["reduce"] += t * d * 4

    def whole():
        if seq:
            f["gather"] += t * d * c
            b["gather"] += t * d * c

    mixer = static["mixer"]
    blocks = {"mla": ["mla"], "ssm": ["ssm"], "xattn": ["attn", "xattn"]
              }.get(mixer, ["attn"])
    for block in blocks:
        if block not in split:
            whole()
            if block == "xattn" and mem_seq:
                f["gather"] += m * d * c
        elif block in ("attn", "xattn"):
            enter()
            leave()
            rel, red = _attention_kv_moves(
                static["attn_cfg" if block == "attn" else "xattn_cfg"], n,
                rank)
            f["relayout"] += rel * p
            b["relayout"] += rel * p
            b["reduce"] += red * 4
            if block == "xattn" and mem_seq:
                f["gather"] += m * d * c
                b["scatter"] += m // n * d * 4
            elif block == "xattn":
                b["reduce"] += m * d * 4
        elif block == "mla":
            mc = static["mla_cfg"]
            if seq:
                f["gather"] += t * d * c
            b["reduce"] += t * (mc.q_lora + mc.kv_lora + mc.d_rope) * 4
            leave()
        else:  # the SSM
            sc = static["ssm_cfg"]
            enter()
            leave()
            f["reduce"] += t * 4
            b["reduce"] += (t + sc.d_inner) * 4
            f["relayout"] += _ssm_relayout(sc, n) * p
            b["relayout"] += _ssm_relayout(sc, n) * p
    ffn = static["ffn"]
    if ffn == "mlp" and "mlp" not in split:
        whole()
    elif ffn == "mlp" and static["mlp"]["sparse"] is None:
        enter()
        leave()
    elif ffn == "mlp":  # the sparse MLP: whole output, columns gathered
        enter()
        b["reduce"] += t * cfg.d_ff * 4
        if seq:
            b["gather"] += t * d * c
    elif ffn == "moe":
        experts, shared = "moe" in split, "moe_shared" in split
        has_shared = "shared" in static["moe"]
        if seq:  # one gather for the router, the experts, the shared MLP
            f["gather"] += t * d * c
            b["scatter"] += t // n * d * 4
            if experts:
                b["reduce"] += t * cfg.moe.top_k * 4
                f["scatter"] += t // n * d * 4
                b["gather"] += t * d * c
            if shared:
                f["scatter"] += t // n * d * 4
                b["gather"] += t * d * 4
            if not experts or (has_shared and not shared):
                b["gather"] += t * d * c
        else:
            if experts:
                b["reduce"] += t * (d + cfg.moe.top_k) * 4
                f["reduce"] += t * d * 4
            if shared:
                b["reduce"] += t * d * 4
                f["reduce"] += t * d * 4
    if seq:
        norms = 1 + (mixer == "xattn") + (ffn != "none")
        b["reduce"] += norms * _norm_leaves(cfg) * d * 4
    return f, b


def _norm_leaves(cfg) -> int:
    return 1 if cfg.norm == "rmsnorm" else 2


def _trailing(cfg, static: dict, n: int, tokens: int, seq: bool) -> dict:
    """Bytes of a layer's last collective over ``model`` that a remat
    recompute ending with that layer does not run again
    (``models.transformer._remat`` stops at the last op that saved a
    tensor): the output of its last block where that block computes on
    its slab and ends in a row product (a dense MLP, MoE's shared
    experts, else its routed experts, or the mixer when the layer has no
    FFN), all-reduced, or on a split stream reduce-scattered; a sparse
    MLP ends in its gathered columns (a whole block, on a split stream,
    in a slice)."""
    ffn = static["ffn"]
    if ffn == "mlp":
        last = "mlp" if static["mlp"]["sparse"] is None else None
    elif ffn == "moe":
        last = "moe_shared" if "shared" in static["moe"] else "moe"
    else:
        last = {"mla": "mla", "ssm": "ssm", "xattn": "xattn"}.get(
            static["mixer"], "attn")
    out = _zero()
    if last in layer_splits(cfg, static, n):
        if seq:
            out["scatter"] = tokens // n * cfg.d_model * 4
        else:
            out["reduce"] = tokens * cfg.d_model * 4
    return out


def model_bytes(cfg, statics: dict, n: int, rows: int, seq: int,
                microbatches: int = 1, rank: int = 0) -> dict:
    """The bytes model rank ``rank`` of the sharded step moves over
    ``model`` (``n`` ranks) on its ``rows`` rows of ``seq`` input tokens
    in ``microbatches`` calls, as ``step.comm`` counts them:
    ``model_reduce_bytes`` all-reduced (float32, forward and backward),
    ``model_scatter_bytes`` reduce-scattered (float32, this rank's
    slabs), ``model_seq_gather_bytes`` all-gathered along the sequence
    (the whole tensors) and ``model_relayout_bytes`` re-laid out (param
    columns, forward, and their gradients back).

    Each layer's come from :func:`_layer_moves` (the decoder's layers
    over the prefix and the text, the encoder's over ``enc_seq`` frames,
    the MTP layer over the text), each stream split along the sequence
    where :func:`seq_splits` holds for its length.  Around them: the
    stream's entry (the vocabulary-split lookup reduce-scattered, or
    all-reduced on a whole stream; a whole lookup split, its gradient
    gathered), whisper's learned positions' and the final norms'
    gradients on a split stream (all-reduced), the head's input (a
    column product where :func:`vocab_splits` holds, else gathered whole
    from a split stream) and each cross-entropy's max, sum of
    exponentials and picked logit.  With ``cfg.remat`` the body's
    periods and the encoder's layers run their forward again in the
    backward (``models.transformer._remat``), so their forward moves
    count twice, but for each recompute's last collective, which stops
    early (:func:`_trailing`); the prefix layers', the MTP layer's and
    the rest count once."""
    r = rows // microbatches
    text, dec = r * seq, r * (seq + cfg.prefix_len)
    enc = r * cfg.enc_seq if cfg.encoder_layers else None
    seq_dec = seq_splits(n, seq + cfg.prefix_len)
    seq_txt = seq_splits(n, seq)
    seq_enc = bool(cfg.encoder_layers) and seq_splits(n, cfg.enc_seq)
    again = 2 if cfg.remat else 1
    stacks = [(st, 1, dec, seq_dec, 1) for st in statics["prefix_layers"]]
    stacks += [(st, statics["n_periods"], dec, seq_dec, again)
               for st in statics["body"]]
    if "encoder" in statics:
        stacks.append((statics["encoder"], cfg.encoder_layers, enc, seq_enc,
                       again))
    if "mtp_layer" in statics:
        stacks.append((statics["mtp_layer"], 1, text, seq_txt, 1))
    total = _zero()
    for st, times, tokens, split, forwards in stacks:
        f, b = _layer_moves(cfg, st, n, tokens, enc, split, seq_enc, rank)
        _add(total, f, times * forwards)
        _add(total, b, times)
    if cfg.remat:  # each recompute ends before its last layer's collective
        _add(total, _trailing(cfg, statics["body"][-1], n, dec, seq_dec),
             -statics["n_periods"])
        if "encoder" in statics:
            _add(total, _trailing(cfg, statics["encoder"], n, enc, seq_enc),
                 -cfg.encoder_layers)
    d = cfg.d_model
    c = torch.empty((), dtype=cfg.cdtype()).element_size()
    vocab = vocab_splits(cfg, n)
    norm = _norm_leaves(cfg) * d * 4

    def embed(looked_up, stream, split):
        if vocab and split:
            total["scatter"] += stream // n * d * 4
            total["gather"] += stream * d * c
        elif vocab:
            total["reduce"] += looked_up * d * 4
        elif split:
            total["gather"] += stream * d * c

    def head(tokens, split):
        if vocab and split:
            total["gather"] += tokens * d * c
            total["scatter"] += tokens // n * d * 4
        elif vocab:
            total["reduce"] += tokens * d * 4
        elif split:
            total["gather"] += tokens * d * c
        if vocab:
            total["reduce"] += 3 * text * 4

    embed(text, dec, seq_dec)
    if cfg.rope_theta is None and seq_dec:  # dec_pos, on the slab
        total["reduce"] += cfg.max_seq * d * 4
    total["reduce"] += norm * seq_dec
    head(dec, seq_dec)
    if "mtp_layer" in statics:
        embed(text, text, seq_txt)
        total["reduce"] += (2 * d * d * 4 + norm) * seq_txt
        head(text, seq_txt)
    if "encoder" in statics and seq_enc:
        total["gather"] += enc * d * c
        total["reduce"] += norm
    return {"model_reduce_bytes": microbatches * total["reduce"],
            "model_scatter_bytes": microbatches * total["scatter"],
            "model_seq_gather_bytes": microbatches * total["gather"],
            "model_relayout_bytes": microbatches * total["relayout"]}


# what a placed serving step moves, by kind (``TensorParallel``'s
# counters), with the collective ``launch.op_stats`` counts each under
_SERVE_OPS = {"reduce": "all-reduce", "gather": "all-gather",
              "relayout": "all-to-all", "scatter": "reduce-scatter",
              "seq_gather": "all-gather", "cache_gather": "all-gather",
              "cache_exchange": "all-to-all", "data_gather": "all-gather",
              "pod_gather": "all-gather"}
_SERVE_KINDS = tuple(_SERVE_OPS)


def _serve_key(kind: str) -> str:
    """``step.comm``'s key of a kind: ``model_*`` over ``model``."""
    return (f"{kind}_bytes" if kind in ("data_gather", "pod_gather")
            else f"model_{kind}_bytes")


# the keys of a placed serving step's ``step.comm``
SERVE_COMM = ("param_gather_bytes", *map(_serve_key, _SERVE_KINDS))


def serve_comm(param_gather_bytes: int, tp: TensorParallel) -> dict:
    """A placed serving step's ``step.comm`` (keys ``SERVE_COMM``): the
    param bytes it gathered and what ``tp``'s counters grew by."""
    return {"param_gather_bytes": param_gather_bytes,
            **{_serve_key(k): getattr(tp, f"{k}_bytes")
               for k in _SERVE_KINDS}}


def _serve_layer_moves(cfg, static: dict, n: int, rank: int, rows: int,
                       s: int, seq: bool, cache: dict | None,
                       blocks: int, pods: int = 1,
                       dp: int | None = None) -> dict:
    """The bytes, by kind (``_SERVE_KINDS``, ``TensorParallel``'s
    counters), that one call of a layer moves forward over ``n`` model
    ranks in a placed serving step (``models.transformer._apply_layer_tp``)
    on model rank ``rank``'s ``rows`` rows of ``s`` positions, the stream
    split along the sequence where ``seq``.  ``cache`` (None without one:
    an encoder layer): ``T`` positions, split over ``model`` where
    ``split``, of ``size`` bytes an entry, the write position ``pos``;
    ``blocks``: the row blocks, ``pods`` of them over ``pod`` within each
    over ``data``, of the mesh's ``dp`` pod x data ranks (default
    ``blocks``): MoE gathers its counts over them unless
    :func:`moe_per_block`."""
    d = cfg.d_model
    c = torch.empty((), dtype=cfg.cdtype()).element_size()
    p = torch.empty((), dtype=cfg.pdtype()).element_size()
    t = rows * s
    split = layer_splits(cfg, static, n)
    out = dict.fromkeys(_SERVE_KINDS, 0)

    def enter():
        if seq:
            out["seq_gather"] += t * d * c

    def leave():
        if seq:
            out["scatter"] += t // n * d * 4
        else:
            out["reduce"] += t * d * 4

    def positions(span_lo, span_hi, lo, hi):
        return max(0, min(hi, span_hi) - max(lo, span_lo))

    def span(q):
        w = cache["T"] // n if cache["split"] else cache["T"]
        return (q * w, (q + 1) * w) if cache["split"] else (0, w)

    def kv_cache(acfg, heads):
        size, pos, big_t = cache["size"], cache["pos"], cache["T"]
        owned = owned_heads(heads)
        w = positions(*span(rank), pos, pos + s)
        out["cache_exchange"] += (2 * rows * w * sum(map(len, owned))
                                  * acfg.d_head * size)
        if s > 1:
            return
        if acfg.decode_strategy == "flash" and acfg.window is None:
            hq = acfg.hq_pad
            out["gather"] += rows * hq * acfg.d_head * c
            if cache["split"]:
                out["reduce"] += rows * hq * (acfg.d_head + 2) * 4
            return
        lo, hi = 0, big_t
        if acfg.window is not None and big_t > acfg.window:
            lo = min(max(pos + 1 - acfg.window, 0), big_t - acfg.window)
            hi = lo + acfg.window
        if cache["split"]:
            out["cache_exchange"] += (2 * rows * (hi - lo) * len(heads[rank])
                                      * acfg.d_head * size)

    def whole(leaves):
        if seq:
            out["seq_gather"] += t * d * c
        if cache is not None:
            out["cache_gather"] += sum(leaves)

    mixer = static["mixer"]
    blocks_of = {"mla": ["mla"], "ssm": ["ssm"], "xattn": ["attn", "xattn"]
                 }.get(mixer, ["attn"])
    for block in blocks_of:
        if block in ("attn", "xattn"):
            acfg = static["attn_cfg" if block == "attn" else "xattn_cfg"]
            cached = cache is not None and block == "attn"
            if block not in split:
                big = (2 * rows * cache["T"] * acfg.n_kv_heads * acfg.d_head
                       * cache["size"] if cached and cache["split"] else 0)
                if seq:
                    out["seq_gather"] += t * d * c
                out["cache_gather"] += big
                continue
            enter()
            leave()
            out["relayout"] += _attention_kv_moves(acfg, n, rank)[0] * p
            if cached:
                if attention_splits(acfg, n):
                    per = acfg.n_kv_heads // n
                    heads = [list(range(r * per, (r + 1) * per))
                             for r in range(n)]
                else:
                    heads = attention_kv_heads(acfg, n)
                kv_cache(acfg, heads)
        elif block == "mla":
            mc = static["mla_cfg"]
            big = (rows * cache["T"] * (mc.kv_lora + mc.d_rope)
                   * cache["size"] if cache is not None and cache["split"]
                   else 0)
            if block not in split:
                whole([big])
                continue
            if seq:
                out["seq_gather"] += t * d * c
            out["cache_gather"] += big
            leave()
        else:  # the SSM; its cache is float32
            sc = static["ssm_cfg"]
            if block not in split:
                conv = rows * (sc.d_conv - 1) * sc.conv_dim * 4
                state = rows * sc.n_heads * sc.head_dim * sc.d_state * 4
                whole([conv * (sc.conv_dim % n == 0),
                       state * (sc.n_heads % n == 0)])
                continue
            enter()
            leave()
            out["reduce"] += t * 4
            out["relayout"] += _ssm_relayout(sc, n) * p
            if cache is not None:
                g = max(1, sc.n_groups // n)
                ch = sc.d_inner // n + 2 * g * sc.d_state
                out["relayout"] += (rows * (sc.d_conv - 1)
                                    * (ch + sc.conv_dim // n) * 4)
    ffn = static["ffn"]
    if ffn == "mlp" and "mlp" not in split:
        whole([])
    elif ffn == "mlp" and static["mlp"]["sparse"] is None:
        enter()
        leave()
    elif ffn == "mlp":  # the sparse MLP: each projection's columns gathered
        enter()
        for name in ("up", "gate", "down"):
            if name in static["mlp"]:
                st = static["mlp"][name]
                out["gather"] += t * st["block_ids"].shape[0] * st["tile"] * c
    elif ffn == "moe":
        if seq:
            out["seq_gather"] += t * d * c
        whole = not moe_per_block(cfg.moe.n_experts, n, blocks,
                                  blocks if dp is None else dp)
        if blocks > 1 and whole:  # gathered over pod, then data
            out["data_gather"] += (pods * (pods > 1) + blocks * (
                blocks > pods)) * cfg.moe.n_experts * 8
        for part in ("moe", "moe_shared"):
            if part in split:
                leave()
    return out


def serve_bytes(cfg, statics: dict, n: int, rows: int, length: int,
                kind: str, max_seq: int, cache_dtype=torch.bfloat16,
                pos: int = 0, rank: int = 0, blocks: int = 1,
                placements=None, pods: int = 1,
                cache_placements=None, dp: int | None = None) -> dict:
    """The bytes model rank ``rank`` of a placed serving step moves (a
    ``kind`` ``"prefill"`` of ``length`` positions, the prefix included,
    or a ``"decode"`` at ``pos``), on its ``rows`` rows (one of
    ``blocks`` row blocks, ``pods`` of them over ``pod`` within each
    over ``data``: :func:`serve_rows`, of the mesh's ``dp`` pod x data
    ranks, default ``blocks``) with a cache of ``max_seq``
    positions in ``cache_dtype``, as ``runtime.serve``'s ``step.comm``
    counts them (its keys): each layer's from :func:`_serve_layer_moves`,
    the decoder's and (a prefill with frames) the encoder's, and around
    them the stream's entry (the vocabulary-split lookup all-reduced, or
    reduce-scattered onto a split stream), the encoder's output gathered
    along its frames, the sampled position gathered from a split stream
    and its logits over the vocabulary.  ``placements`` (the params'):
    the leaves no block computes on the slabs of, gathered each time a
    layer (or the lookup, the head) reads them
    (``param_gather_bytes``).  Over ``pods`` (``cache_placements``, the
    cache's, needed then): what each layer wrote of its cache slab, and
    the encoder's output, all-gathered over ``pod``
    (:func:`share_rows`, ``pod_gather_bytes``)."""
    d = cfg.d_model
    c = torch.empty((), dtype=cfg.cdtype()).element_size()
    s = length if kind == "prefill" else 1
    pos = 0 if kind == "prefill" else min(max(pos, 0), max_seq - s)
    seq = seq_splits(n, s)
    cache = {"T": max_seq, "split": seq_splits(n, max_seq), "pos": pos,
             "size": torch.empty((), dtype=cache_dtype).element_size()}
    total = dict.fromkeys(_SERVE_KINDS, 0)

    def add(moves, times=1):
        for k in _SERVE_KINDS:
            total[k] += times * moves[k]

    for st in statics["prefix_layers"]:
        add(_serve_layer_moves(cfg, st, n, rank, rows, s, seq, cache,
                               blocks, pods, dp))
    for st in statics["body"]:
        add(_serve_layer_moves(cfg, st, n, rank, rows, s, seq, cache,
                               blocks, pods, dp), statics["n_periods"])
    encode = kind == "prefill" and "encoder" in statics
    if encode:
        seq_enc = seq_splits(n, cfg.enc_seq)
        add(_serve_layer_moves(cfg, statics["encoder"], n, rank, rows,
                               cfg.enc_seq, seq_enc, None, blocks, pods,
                               dp),
            cfg.encoder_layers)
        if seq_enc:
            total["seq_gather"] += rows * cfg.enc_seq * d * c
    vocab = vocab_splits(cfg, n)
    text = s - (cfg.prefix_len if kind == "prefill" else 0)
    if vocab and seq:
        total["scatter"] += rows * s // n * d * 4
    elif vocab:
        total["reduce"] += rows * text * d * 4
    if seq:
        total["seq_gather"] += rows * n * d * c
    if vocab:
        total["gather"] += rows * cfg.padded_vocab * c
    if pods > 1:
        if cache_placements is None:
            raise ValueError("rows over pod: the cache's placements reckon "
                             "what each pod writes")
        total["pod_gather"] += _pod_share_bytes(
            statics, cache_placements, n, rank, pos, s, encode,
            cache["size"], c)
    params = 0
    if placements is not None:
        slab = slab_leaves(cfg, statics, placements, n)
        size = torch.empty((), dtype=cfg.pdtype()).element_size()

        def gathered(pl_tree, flags, lead: int = 0) -> int:
            pls = _flat(pl_tree)
            return sum(size * math.prod(pl.shape[lead:])
                       for pl, on in zip(pls, _flat(flags))
                       if not on and not pl.whole)

        top = ["embed", "final_norm",
               "embed" if cfg.tie_embeddings else "lm_head"]
        top += ["dec_pos"] + (["enc_pos", "enc_norm"] if encode else [])
        params += sum(gathered(placements[k], slab[k]) for k in top
                      if k in placements)
        params += sum(gathered(pl, f) for pl, f in zip(
            placements["prefix_layers"], slab["prefix_layers"]))
        params += statics["n_periods"] * sum(gathered(pl, f, 1) for pl, f in
                                             zip(placements["body"],
                                                 slab["body"]))
        if encode:
            params += cfg.encoder_layers * gathered(placements["encoder"],
                                                    slab["encoder"], 1)
    return {"param_gather_bytes": params,
            **{_serve_key(k): total[k] for k in _SERVE_KINDS}}


def _pod_share_bytes(statics: dict, cache_placements, n: int, rank: int,
                     pos: int, s: int, encode: bool, size: int,
                     c: int) -> int:
    """What :func:`share_rows` all-gathers over ``pod`` in one placed
    step on model rank ``rank``: each layer's cache leaves, of
    ``cache_placements`` (a leaf indexed by position, ``SEQ_LEAVES``, in
    ``size`` bytes an entry: the positions ``[pos, pos + s)`` its slab
    holds; an SSM's conv and state, float32: all of it), every row of
    the slab; and with ``encode`` the encoder's output (``c`` bytes an
    entry)."""
    def leaf(name: str, pl, lead: int) -> int:
        shape = pl.slab_shape[lead:]
        if name not in SEQ_LEAVES:
            return math.prod(shape) * 4
        w = shape[1]
        lo = rank * w if pl.blocks[lead + 1] > 1 else 0
        inside = max(0, min(pos + s, lo + w) - max(pos, lo))
        return shape[0] * inside * math.prod(shape[2:]) * size

    def layer(tree, lead: int) -> int:
        if isinstance(tree, dict):
            return sum(leaf(k, v, lead) if not isinstance(v, dict)
                       else layer(v, lead) for k, v in tree.items())
        return 0

    out = sum(layer(t, 0) for t in cache_placements["prefix_layers"])
    out += statics["n_periods"] * sum(layer(t, 1)
                                      for t in cache_placements["body"])
    if encode:
        out += math.prod(cache_placements["memory"].slab_shape) * c
    return out


def serve_comm_by_kind(comm: dict) -> dict:
    """A placed serving step's ``step.comm`` (or :func:`serve_bytes`)
    summed by collective kind, under ``launch.op_stats``' names: what its
    ``collective_bytes_by_kind`` counts of the same step."""
    out = {"all-gather": comm["param_gather_bytes"], "all-reduce": 0,
           "reduce-scatter": 0, "all-to-all": 0}
    for kind, op in _SERVE_OPS.items():
        out[op] += comm[_serve_key(kind)]
    return out


def _flat(tree) -> list:
    """The leaves of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


# the leaves each block keeps on its slabs: (path in the layer, the
# leaves of that subtree; None: all of them)
_BLOCK_LEAVES = {
    "attn": (("attn",), None), "xattn": (("xattn",), None),
    "mla": (("attn",), ("wq_b", "wkv_b", "wo")),
    "ssm": (("attn",), ("in_proj", "conv_w", "conv_b", "A_log", "D",
                        "dt_bias", "out_proj")),
    "mlp": (("mlp",), None), "moe": (("moe", "experts"), None),
    "moe_shared": (("moe", "shared"), None)}


def slab_leaves(cfg, statics: dict, tree, n: int):
    """A tree of bools shaped as ``tree`` (the params or their
    placements): True for a leaf that stays on its slab under
    :func:`layer_splits` and :func:`vocab_splits` over ``n`` model
    ranks (the embedding, and the head when it is not tied, at the top
    of the tree; of attention whose ``wk``/``wv`` are whole leaves,
    :func:`kv_split`, ``wq`` and ``wo``)."""
    out = _map(lambda _: False, tree)
    layers = [*zip(out["prefix_layers"], statics["prefix_layers"]),
              *zip(out["body"], statics["body"])]
    for key in ("encoder", "mtp_layer"):
        if key in out:
            layers.append((out[key], statics[key]))
    for layer, static in layers:
        for block in layer_splits(cfg, static, n):
            path, names = _BLOCK_LEAVES[block]
            if block in ("attn", "xattn") and not kv_split(
                    static["attn_cfg" if block == "attn" else "xattn_cfg"],
                    n):
                names = ("wq", "wo")
            parent = layer
            for key in path[:-1]:
                parent = parent[key]
            sub = parent[path[-1]]
            if names is None:
                parent[path[-1]] = _map(lambda _: True, sub)
            else:
                for name in names:
                    sub[name] = _map(lambda _: True, sub[name])
    if vocab_splits(cfg, n):
        for key in ("embed", "lm_head"):
            if key in out:
                out[key] = _map(lambda _: True, out[key])
    return out


def check_slabs(placements, slab) -> None:
    """Every leaf computed on its slab (``slab``, :func:`slab_leaves`) is
    split over ``model`` alone, as these rules and
    ``launch.steps.param_shardings`` both derive it from the specs."""
    def one(pl, on_slab):
        if on_slab and (pl.whole or any(
                e not in (None, "model") for e in pl.pspec)):
            raise ValueError(f"a leaf computed on its model slab is placed "
                             f"as {pl.pspec} over {pl.shape}")
        return None

    _map(one, placements, slab)


# cache leaves indexed by position (dim 1 of a layer's leaf): a step
# writes only the positions it writes
SEQ_LEAVES = ("k", "v", "c_kv", "k_rope")


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


def gather_over_data(mesh, t: torch.Tensor, dims=("data", "pod"),
                     tp: TensorParallel | None = None) -> torch.Tensor:
    """``t`` of every row block stacked along a new leading dim, in row
    block order (an all-gather over ``data``, then ``pod``; ``dims``
    names the dims the blocks span).  With ``tp``, its
    ``data_gather_bytes`` grow by each gather's output."""
    sizes = mesh_axis_sizes(mesh)
    out = t[None]
    for a in dims:
        if sizes.get(a, 1) > 1:
            parts = [torch.empty_like(out) for _ in range(sizes[a])]
            dist.all_gather(parts, out.contiguous(), group=mesh.get_group(a))
            out = torch.cat(parts)
            if tp is not None:
                tp.data_gather_bytes += out.numel() * out.element_size()
    return out


def moe_per_block(n_experts: int, n_model: int, blocks: int,
                  dp: int) -> bool:
    """Whether MoE counts capacity on each of a step's ``blocks`` row
    blocks alone: where the rows split over all ``dp`` pod x data ranks
    (the batch divides over them) and the ``n_model`` model ranks divide
    the experts, as the reference's ``moe_apply`` takes
    ``_moe_shard_map`` under its mesh; else over the whole batch (its
    ``_moe_local``)."""
    return blocks == dp and n_experts % n_model == 0


def serve_row_dims(mesh, batch: int) -> tuple:
    """The mesh dims a placed serving step splits its ``batch`` rows
    over, inner first: ``pod`` where it divides each data block's rows,
    then ``data`` where it divides the batch (as it does the cache's
    rows, ``launch.steps.cache_pspec``'s ``data_only``)."""
    sizes = mesh_axis_sizes(mesh)
    dims, rows = [], batch
    for a in ("data", "pod"):
        if sizes.get(a, 1) > 1 and rows % sizes[a] == 0:
            dims.insert(0, a)
            rows //= sizes[a]
    return tuple(dims)


def serve_rows(mesh, batch: int) -> tuple[int, int]:
    """(this rank's row block, number of row blocks) of a placed serving
    step's ``batch`` rows, over :func:`serve_row_dims`: data-major, so a
    rank's rows lie in its data block, its cache slabs' rows, and each
    pod computes its share of them."""
    sizes = mesh_axis_sizes(mesh)
    r, n = 0, 1
    for a in reversed(serve_row_dims(mesh, batch)):
        r, n = r * sizes[a] + mesh.get_local_rank(a), n * sizes[a]
    return r, n


def serve_pods(mesh, batch: int) -> int:
    """The pods a placed serving step splits each data block's rows
    over (1 where ``pod`` does not split them)."""
    if "pod" in serve_row_dims(mesh, batch):
        return mesh_axis_sizes(mesh)["pod"]
    return 1


def share_rows(slab: torch.Tensor, pl, pos: int | None, s: int,
               tp: TensorParallel, pods: int) -> None:
    """Every pod's copy of a cache slab (rows over ``data``, whole over
    ``pod``; ``pl``: one layer's placement) given the rows each pod's
    rank computed, the slab's ``pods`` equal row blocks in pod order:
    this rank's block of what the step wrote (the positions ``[pos, pos
    + s)`` the slab holds, or, with ``pos`` None, the whole leaf)
    all-gathered over ``pod`` (``pod_gather_bytes``) and written in."""
    w = slab.shape[0] // pods
    me = tp.mesh.get_local_rank("pod")
    region: tuple = (slice(None),)
    if pos is not None:
        seq = pl.slices[1]
        lo, hi = max(pos, seq.start), min(pos + s, seq.stop)
        if lo >= hi:
            return
        region = (slice(None), slice(lo - seq.start, hi - seq.start))
    slab[region] = gather_pods(slab[me * w:(me + 1) * w][region], tp, pods)


def gather_pods(t: torch.Tensor, tp: TensorParallel,
                pods: int) -> torch.Tensor:
    """``t``, this rank's rows, beside the other pods' (stacked along dim
    0 in pod order, all-gathered over ``pod``; ``pod_gather_bytes``)."""
    if pods == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(pods)]
    dist.all_gather(parts, t.contiguous(), group=tp.mesh.get_group("pod"))
    out = torch.cat(parts)
    tp.pod_gather_bytes += out.numel() * out.element_size()
    return out
