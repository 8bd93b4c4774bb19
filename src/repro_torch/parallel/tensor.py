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
    rank's slice backward, column slabs that what follows needs whole;
  * :func:`relayout_columns`: a leaf's columns re-laid out from the
    ranks' storage slabs to the columns each rank computes with (an
    all-to-all forward; backward, each column's gradient back to the
    rank that stores it, summed over the ranks that read it).

One rounding rule holds for every block: each all-reduce over ``model``
(a row product's partial sums, a whole input's gradient parts, a norm's
or the cross-entropy's statistics) runs in float32 and rounds once to
the tensor's dtype, and the column and row products of every split
block (:func:`column_product`, :func:`row_product`) accumulate in
float32 and round once, as one product over the whole width does.
:func:`model_bytes` reckons from the shapes what each split block moves
(``_MOVES``), as the sharded step's ``step.comm`` counts it.

Which blocks compute on their slab (:func:`layer_splits`), and so which
param leaves stay slabs (:func:`slab_leaves`), follows from the configs
and the ``model`` size alone, as the slabs ``launch.steps.
param_shardings`` gives do: ``embed`` maps to no mesh axis, so a rank's
slab of a split leaf is its tensor-parallel shard.

  * attention (``attn``, ``swa``, whisper's ``xattn``): column-parallel
    ``wq``/``wk``/``wv`` (biases with them), each rank its own heads,
    row-parallel ``wo``; only where ``model`` divides the padded query
    heads and the key heads, the key/value projections carry the
    ``kv_heads`` axis, and the heads group (``AttnConfig.grouped``).
    Where the ranks outnumber the key heads (MQA's one), each rank's
    query heads read one key head, whose ``wk``/``wv`` columns it
    re-lays out from their storage slabs
    (:func:`attention_reads_one_kv_head`);
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

What stays gathered is what does not divide so (attention whose heads
or key projections do not divide over ``model``, an MLP whose ``ff`` or
tiles do not); norms, routers and MLA's latent projections are whole
leaves.  Only the sharded step of
``runtime.train`` enters :func:`tensor_parallel_ctx`; model code reads
it in ``models.transformer`` alone (``_apply_layer``, the lookup and the
head), so outside the context every layer runs as it does without a
mesh, serving's sharded paths included.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import _map, mesh_axis_sizes

__all__ = ["TensorParallel", "tensor_parallel_ctx", "entered", "current",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "relayout_columns", "column_product", "row_product",
           "attention_splits", "attention_reads_one_kv_head", "mlp_splits",
           "experts_split", "mla_splits", "ssm_splits", "vocab_splits",
           "layer_splits", "slab_leaves", "model_bytes", "data_shards",
           "gather_over_data"]


@dataclasses.dataclass
class TensorParallel:
    """One context's ``model`` group and what its collectives moved:
    ``reduce_bytes`` all-reduced (forward and backward), ``gather_bytes``
    all-gathered (the whole tensors' bytes) and ``relayout_bytes``
    re-laid out (each rank's assembled columns forward and their
    gradients backward)."""

    mesh: object
    size: int  # model ranks
    rank: int  # this rank's model coordinate
    group: object
    reduce_bytes: int = 0
    gather_bytes: int = 0
    relayout_bytes: int = 0

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


def column_product(x: torch.Tensor, params, tp: TensorParallel, dtype):
    """``linear(p, x)`` for ``params`` (one linear's, or a list of them,
    each this rank's column slab): ``x``, whole on every rank, enters
    once by ``copy_to_model`` in float32, each product accumulates in
    float32 and rounds once to ``dtype``, as one product over all the
    columns does, and the ranks' parts of ``x``'s gradient sum in float32
    before their one rounding.  A list gives a list."""
    x32 = copy_to_model(x.float(), tp)
    out = []
    for p in params if isinstance(params, list) else [params]:
        y = x32 @ p["w"].float()
        out.append((y + p["b"].float() if "b" in p else y).to(dtype))
    return out if isinstance(params, list) else out[0]


def row_product(x: torch.Tensor, params: dict, tp: TensorParallel,
                dtype) -> torch.Tensor:
    """``linear`` of the whole input whose rows' slab ``x`` this rank
    holds, on its row slab ``params``: the ranks' float32 partial
    products summed over the group in float32, then rounded once to
    ``dtype`` (the bias, whole, added once)."""
    y = reduce_from_model(x.float() @ params["w"].float(), tp)
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


def attention_reads_one_kv_head(cfg, n: int) -> bool:
    """Whether an ``AttnConfig``'s block computes on its query heads'
    slabs over ``n`` model ranks whose key heads do not split (fewer key
    heads than ranks, ``n`` a multiple of them, as MQA's one): each
    rank's query heads then lie in one key head's group, whose ``wk``/
    ``wv`` columns every such rank re-lays out from the storage slabs
    (the key projections split on their columns, ``model`` dividing
    them)."""
    kv = cfg.n_kv_heads * cfg.d_head
    return (n > 1 and cfg.grouped and cfg.hq_pad % n == 0
            and cfg.n_kv_heads % n != 0 and n % cfg.n_kv_heads == 0
            and kv % cfg.model_shards == 0 and kv % n == 0)


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
    ``{"attn", "xattn", "mla", "ssm", "mlp", "moe", "moe_shared"}``."""
    out = set()
    mixer = static["mixer"]

    def attends(key):
        return (attention_splits(static[key], n)
                or attention_reads_one_kv_head(static[key], n))

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


def _attention_moves(cfg, n: int, tokens: int, memory: int | None = None):
    """(forward elements all-reduced, backward elements all-reduced,
    param elements re-laid out each way) of one call of an
    ``AttnConfig``'s split block on ``tokens`` query tokens (and
    ``memory`` key tokens, cross-attention): the output forward, the
    query input's and the memory's gradients backward; where each rank
    reads one key head, that head's ``wk``/``wv`` columns and biases."""
    d = cfg.d_model
    relaid = (2 * (d + cfg.qkv_bias) * cfg.d_head
              if attention_reads_one_kv_head(cfg, n) else 0)
    return tokens * d, tokens * d + (memory or 0) * d, relaid


def _mlp_moves(static: dict, d: int, d_ff: int, tokens: int):
    """An MLP's: dense, its output forward and its input's gradient
    backward; sparse, its input's and ``h``'s gradients backward (its
    columns are gathered)."""
    if static["sparse"] is None:
        return tokens * d, tokens * d, 0
    return 0, tokens * (d + d_ff), 0


def _ssm_moves(cfg, n: int, tokens: int):
    """An ``SSMConfig``'s: its output and the gated norm's sum of squares
    forward; its input's gradient, the sum of squares' and the whole
    scale's backward; re-laid out, the rank's columns of ``in_proj`` (its
    heads' z, x and dt, its groups' B and C) and of the conv's weight and
    bias."""
    g = max(1, cfg.n_groups // n)
    ch = cfg.d_inner // n + 2 * g * cfg.d_state
    cols = ch + cfg.d_inner // n + cfg.n_heads // n
    return (tokens * cfg.d_model + tokens,
            tokens * cfg.d_model + tokens + cfg.d_inner,
            cfg.d_model * cols + (cfg.d_conv + 1) * ch)


def _shared_ff(cfg) -> int:
    moe = cfg.moe
    return moe.d_ff_shared or moe.n_shared * moe.d_ff_expert


# what one call of each split block moves over ``model``: (model config,
# layer static, ranks, tokens, memory tokens) -> (elements all-reduced in
# the forward, in the backward, param elements re-laid out each way)
_MOVES = {
    "attn": lambda cfg, st, n, t, m: _attention_moves(st["attn_cfg"], n, t),
    "xattn": lambda cfg, st, n, t, m: _attention_moves(st["xattn_cfg"], n,
                                                       t, m),
    # the output; the two latents' gradients (q's, and c_kv with the RoPE
    # key's)
    "mla": lambda cfg, st, n, t, m: (t * cfg.d_model, t * (
        st["mla_cfg"].q_lora + st["mla_cfg"].kv_lora + st["mla_cfg"].d_rope),
        0),
    "ssm": lambda cfg, st, n, t, m: _ssm_moves(st["ssm_cfg"], n, t),
    "mlp": lambda cfg, st, n, t, m: _mlp_moves(st["mlp"], cfg.d_model,
                                               cfg.d_ff, t),
    # the output; the input's and the top-k weights' gradients
    "moe": lambda cfg, st, n, t, m: (t * cfg.d_model,
                                     t * (cfg.d_model + cfg.moe.top_k), 0),
    "moe_shared": lambda cfg, st, n, t, m: _mlp_moves(
        st["moe"]["shared"], cfg.d_model, _shared_ff(cfg), t),
}


def _trailing_reduce(cfg, static: dict, n: int, tokens: int) -> int:
    """Elements of a layer's last all-reduce over ``model`` that a remat
    recompute ending with that layer does not run again
    (``models.transformer._remat`` stops at the last op that saved a
    tensor): the output of its last block where that block computes on
    its slab and ends in a row product (a dense MLP, MoE's shared
    experts, else its routed experts, or the mixer when the layer has no
    FFN); a sparse MLP's forward all-reduces nothing (its columns are
    all-gathered, which ``model_bytes`` does not reckon)."""
    ffn = static["ffn"]
    if ffn == "mlp":
        last = "mlp" if static["mlp"]["sparse"] is None else None
    elif ffn == "moe":
        last = "moe_shared" if "shared" in static["moe"] else "moe"
    else:
        last = {"mla": "mla", "ssm": "ssm", "xattn": "xattn"}.get(
            static["mixer"], "attn")
    return tokens * cfg.d_model if last in layer_splits(cfg, static, n) \
        else 0


def model_bytes(cfg, statics: dict, n: int, rows: int, seq: int,
                microbatches: int = 1) -> dict:
    """The bytes one rank's sharded step moves over ``model`` (``n``
    ranks) on its ``rows`` rows of ``seq`` input tokens in
    ``microbatches`` calls, as ``step.comm`` counts them:
    ``model_reduce_bytes`` all-reduced (float32, forward and backward)
    and ``model_relayout_bytes`` re-laid out (param columns, forward,
    and their gradients back), from ``_MOVES`` for each block
    :func:`layer_splits` gives (the decoder's layers over the prefix and
    the text, the encoder's over ``enc_seq`` frames, the MTP layer over
    the text) and, where :func:`vocab_splits` holds, each lookup's
    output, each head's input gradient and each cross-entropy's max, sum
    of exponentials and picked logit.  With ``cfg.remat`` the body's
    periods and the encoder's layers run their forward again in the
    backward (``models.transformer._remat``), so their forward moves
    count twice, but for each recompute's last all-reduce, which stops
    early (:func:`_trailing_reduce`); the prefix layers', the MTP
    layer's and the vocabulary's count once."""
    r = rows // microbatches
    text, dec = r * seq, r * (seq + cfg.prefix_len)
    enc = r * cfg.enc_seq if cfg.encoder_layers else None
    again = 2 if cfg.remat else 1
    stacks = [(st, 1, dec, 1) for st in statics["prefix_layers"]]
    stacks += [(st, statics["n_periods"], dec, again)
               for st in statics["body"]]
    if "encoder" in statics:
        stacks.append((statics["encoder"], cfg.encoder_layers, enc, again))
    if "mtp_layer" in statics:
        stacks.append((statics["mtp_layer"], 1, text, 1))
    reduce, relayout = 0, 0
    for st, times, tokens, forwards in stacks:
        for block in layer_splits(cfg, st, n):
            fwd, bwd, rel = _MOVES[block](cfg, st, n, tokens, enc)
            reduce += times * (forwards * fwd + bwd)
            relayout += times * (forwards + 1) * rel
    if cfg.remat:  # each recompute ends before its last layer's reduce
        reduce -= statics["n_periods"] * _trailing_reduce(
            cfg, statics["body"][-1], n, dec)
        if "encoder" in statics:
            reduce -= cfg.encoder_layers * _trailing_reduce(
                cfg, statics["encoder"], n, enc)
    if vocab_splits(cfg, n):
        heads = 1 + ("mtp_layer" in statics)
        reduce += heads * (text * cfg.d_model + 3 * text)
        reduce += dec * cfg.d_model + (heads - 1) * text * cfg.d_model
    p = torch.empty((), dtype=cfg.pdtype()).element_size()
    return {"model_reduce_bytes": 4 * microbatches * reduce,
            "model_relayout_bytes": p * microbatches * relayout}


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
    of the tree)."""
    out = _map(lambda _: False, tree)
    layers = [*zip(out["prefix_layers"], statics["prefix_layers"]),
              *zip(out["body"], statics["body"])]
    for key in ("encoder", "mtp_layer"):
        if key in out:
            layers.append((out[key], statics[key]))
    for layer, static in layers:
        for block in layer_splits(cfg, static, n):
            path, names = _BLOCK_LEAVES[block]
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

