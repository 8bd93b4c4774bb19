"""Mixture-of-Experts FFN with shared experts and capacity-based dispatch.

Port of ``src/repro/models/moe.py``.  Two execution paths, chosen as the
reference chooses them (:func:`moe_apply`):

  * **expert parallel** (:func:`_moe_sharded`, the reference's
    ``_moe_shard_map``): inside ``parallel.activations.
    activation_sharding_ctx(mesh)``, when the batch divides over the data
    dims and the experts over ``model``.  Each rank routes the rows of its
    data shard (capacity counted on those local tokens) and runs the
    experts ``[j*e_loc, (j+1)*e_loc)`` of its model rank ``j``; the
    partial outputs sum by an all-reduce over ``model`` and the data
    shards meet by an all-gather, so every rank returns the whole result
    (SPMD, as ``launch/mesh.py`` sets out);
  * **single device** (:func:`_moe_local`): the same dispatch over every
    token and every expert;
  * **tensor parallel** (:func:`moe_apply_tp`, inside
    ``parallel.tensor.tensor_parallel_ctx``: the sharded train step and
    the placed serving steps): each rank routes its row block of the
    batch through its ``model`` slab of the experts.  Capacity is counted
    as the reference counts it under its mesh: on the block's own tokens
    where the batch divides over the data dims and the experts over
    ``model`` (``_moe_shard_map``), else over the whole batch, each
    pair's place in its expert's queue after the earlier blocks' (its
    ``_moe_local`` fallback; the counts all-gathered over the data dims).

Dispatch is sort-based (dropless up to the capacity factor): (token, k)
pairs sort by expert id, each expert takes up to ``cap`` tokens and the
overflow drops.  Routing and drops are the reference's integers exactly:

  * top-k by a stable descending sort, so tied probabilities keep the
    lower expert index first as ``jax.lax.top_k`` does (``torch.topk``
    promises no order on ties, and bf16 router logits tie often across
    160-256 experts);
  * ``cap = int(max(1, round(t*k/E*cf)))`` with Python's half-to-even
    ``round``;
  * a stable ``argsort`` by expert, ``searchsorted(side="left")`` for the
    group starts, and every dropped pair written to the sentinel row
    ``e_loc*cap``, which is thrown away.

A drop depends on what else the block holds (idle decode slots
included), as in the reference.  The expert buffers are ``e_loc * cap``
rows of the block's capacity; the dispatch writes each pair's token row
into its slot (the dropped and foreign pairs into the sentinel row) and
the combine adds the ``k`` weighted contributions of each token in
``k`` order, in float32, rounded once: the reference's scatter-add
without its ``[t * k, d]`` contributions or atomics.  The expert
products are ``torch.einsum``, as the reference's are XLA einsums
outside any Pallas kernel.  Nothing here reads the device from the
host.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.models.layers import (
    _normal,
    gelu,
    linear,
    linear_init,
    linear_specs,
    mlp_apply,
    mlp_apply_tp,
    mlp_init,
    mlp_specs,
    mlp_static,
    silu,
)
from repro_torch.parallel.activations import current_mesh
from repro_torch.parallel.sharding import mesh_axis_sizes
from repro_torch.parallel.tensor import (
    copy_to_model,
    count_once,
    data_shards,
    gather_over_data,
    gather_sequence,
    moe_per_block,
    reduce_from_model,
    scatter_sequence,
    split_sequence,
)

__all__ = ["MoEConfig", "moe_static", "moe_init", "moe_specs", "moe_apply",
           "moe_apply_tp", "capacity", "kept_pairs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int | None = None  # defaults to n_shared * d_ff_expert
    capacity_factor: float = 1.25
    act: str = "swiglu"
    model_shards: int = 16
    router_scale: bool = True  # normalise top-k weights to sum 1


def _d_ff_shared(cfg: MoEConfig) -> int:
    return cfg.d_ff_shared or cfg.n_shared * cfg.d_ff_expert


def moe_static(cfg: MoEConfig, device=None) -> dict:
    """The static part: the shared experts' dense MLP static, if any."""
    if not cfg.n_shared:
        return {}
    return {"shared": mlp_static(cfg.d_model, _d_ff_shared(cfg), act=cfg.act,
                                 sparse=None, model_shards=cfg.model_shards,
                                 device=device)}


def moe_init(generator, cfg: MoEConfig, param_dtype=torch.float32,
             device=None):
    """Returns (params, static): the router ``[D, E]``, the routed experts'
    stacked ``gate``/``up`` ``[E, D, F]`` and ``down`` ``[E, F, D]``, and
    the shared experts' MLP."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    params = {
        "router": linear_init(generator, d, e, param_dtype=param_dtype,
                              device=device),
        "experts": {
            "gate": _normal(generator, (e, d, f), d ** -0.5, param_dtype,
                            device),
            "up": _normal(generator, (e, d, f), d ** -0.5, param_dtype,
                          device),
            "down": _normal(generator, (e, f, d), f ** -0.5, param_dtype,
                            device),
        },
    }
    static = moe_static(cfg, device)
    if cfg.n_shared:
        params["shared"], _ = mlp_init(
            generator, d, _d_ff_shared(cfg), act=cfg.act, sparse=None,
            model_shards=cfg.model_shards, param_dtype=param_dtype,
            device=device)
    return params, static


def moe_specs(cfg: MoEConfig) -> dict:
    """The specs of :func:`moe_init`'s params: the router replicated, the
    routed experts over ``model`` (expert parallel), the shared experts'
    dense MLP."""
    specs = {"router": linear_specs("embed", "unsharded"),
             "experts": {name: ("expert", None, None)
                         for name in ("gate", "up", "down")}}
    if cfg.n_shared:
        specs["shared"] = mlp_specs(cfg.d_model, _d_ff_shared(cfg),
                                    act=cfg.act, sparse=None,
                                    model_shards=cfg.model_shards)
    return specs


def capacity(t: int, cfg: MoEConfig) -> int:
    """Tokens each expert takes from ``t`` local tokens (the reference's
    expression; ``round`` is half-to-even)."""
    return int(max(1, round(t * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def _dispatch_slots(top_e: torch.Tensor, t: int, cfg: MoEConfig, e0: int,
                    e_loc: int, earlier=None):
    """The reference's sort-based dispatch of the (token, k) pairs of
    ``top_e`` [T, k] to the local experts ``[e0, e0 + e_loc)``: (slot,
    keep), each [T, k].  ``slot`` is the pair's row in the ``[e_loc * cap
    + 1]`` gather (the last row the sentinel of every dropped or foreign
    pair), ``keep`` whether it took one.

    ``earlier`` = (pairs [E] each expert took on the row blocks before
    this one, tokens of all row blocks) dispatches these tokens as the
    batch's row block: capacity over all its tokens, each pair's place in
    its expert's queue after the earlier blocks' pairs (the reference's
    dispatch of the whole batch, cut to these rows)."""
    dev = top_e.device
    cap = capacity(t if earlier is None else earlier[1], cfg)
    flat_e = top_e.reshape(-1) - e0  # local expert index (may be OOB)
    local = (flat_e >= 0) & (flat_e < e_loc)
    sort_key = torch.where(local, flat_e, e_loc)  # foreign pairs sort last

    order = torch.argsort(sort_key, stable=True)
    e_sorted = sort_key[order]
    seg_pos = torch.arange(e_sorted.shape[0], device=dev)
    group_start = torch.searchsorted(
        e_sorted, torch.arange(e_loc + 1, device=dev), side="left")
    pos_in_group = seg_pos - group_start[e_sorted.clamp(0, e_loc)]
    if earlier is not None:
        before = torch.cat([earlier[0][e0:e0 + e_loc],
                            earlier[0].new_zeros(1)])
        pos_in_group = pos_in_group + before[e_sorted.clamp(0, e_loc)]
    keep = (e_sorted < e_loc) & (pos_in_group < cap)
    slot = torch.where(keep, e_sorted * cap + pos_in_group, e_loc * cap)
    # back to (token, k) order
    slot_tk, keep_tk = torch.empty_like(slot), torch.empty_like(keep)
    slot_tk[order], keep_tk[order] = slot, keep
    return slot_tk.view(t, cfg.top_k), keep_tk.view(t, cfg.top_k)


def kept_pairs(top_e: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """bool [T, k]: which (token, k) pairs of ``top_e`` the dispatch keeps
    (within its expert's capacity)."""
    return _dispatch_slots(top_e, top_e.shape[0], cfg, 0, cfg.n_experts)[1]


def _dispatch_compute_combine(
    xf: torch.Tensor,  # [T, D] local tokens
    top_w: torch.Tensor,  # [T, k]
    top_e: torch.Tensor,  # [T, k] global expert ids
    experts: dict,  # local expert weights [E_loc, ...]
    cfg: MoEConfig,
    e0: int,  # first global expert id owned locally
    earlier=None,  # see _dispatch_slots
) -> torch.Tensor:
    """Capacity-gather local tokens to local experts, run the FFNs, and
    combine the weighted outputs.  Returns the *partial* output [T, D]
    (contributions of local experts only).  No tensor of the pairs'
    rows (``[T * k, D]``) is formed: the dispatch and the combine go
    over the ``k`` choices one at a time."""
    t, d = xf.shape
    k = cfg.top_k
    e_loc = experts["up"].shape[0]
    cap = capacity(t if earlier is None else earlier[1], cfg)
    slot, keep = _dispatch_slots(top_e, t, cfg, e0, e_loc, earlier)

    gathered = xf.new_zeros((e_loc * cap + 1, d))
    # kept slots are distinct; every dropped or foreign pair writes its
    # row to the sentinel row, which is thrown away
    for i in range(k):
        gathered[slot[:, i]] = xf
    xe = gathered[:-1].view(e_loc, cap, d)

    h = torch.einsum("ecd,edf->ecf", xe, experts["up"].to(xf.dtype))
    if cfg.act == "swiglu":
        g = torch.einsum("ecd,edf->ecf", xe, experts["gate"].to(xf.dtype))
        h = silu(g) * h
    else:
        h = gelu(h)
    ye = torch.einsum("ecf,efd->ecd", h, experts["down"].to(xf.dtype))
    ye = ye.reshape(e_loc * cap, d)

    # the reference's scatter-add of ye[slot] * w over the tokens, in k
    # order: a dropped or foreign pair adds zero wherever it points
    out = None
    for i in range(k):
        rows = ye[slot[:, i].clamp(max=e_loc * cap - 1)]
        term = torch.where(keep[:, i, None], rows * top_w[:, i, None],
                           0).float()
        out = term if out is None else out + term
    return out.to(xf.dtype)


def _route(params, cfg: MoEConfig, xf: torch.Tensor):
    """(top_w [T, k] in xf's dtype, top_e [T, k]): softmax router, top-k
    with ties to the lower expert index, weights renormalised."""
    logits = linear(params["router"], xf).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., : cfg.top_k], top_e[..., : cfg.top_k]
    if cfg.router_scale:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-9)
    return top_w.to(xf.dtype), top_e


def _moe_local(params, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    top_w, top_e = _route(params, cfg, xf)
    out = _dispatch_compute_combine(xf, top_w, top_e, params["experts"], cfg,
                                    0)
    return out.reshape(b, s, d)


def _moe_sharded(params, cfg: MoEConfig, x: torch.Tensor, mesh
                 ) -> torch.Tensor:
    """Expert parallelism over ``mesh`` (SPMD): this rank's data shard of
    the rows through its model rank's experts, all-reduced over
    ``model`` and all-gathered over the data dims (pod-major, as the
    reference's ``P(("pod", "data"))``).  ``_moe_sharded.calls`` counts
    the calls."""
    _moe_sharded.calls += 1
    sizes = mesh_axis_sizes(mesh)
    dp = [a for a in ("pod", "data") if sizes.get(a, 1) > 1]
    n_model = sizes.get("model", 1)
    b, s, d = x.shape
    n_dp = math.prod(sizes[a] for a in dp)
    b_loc = b // n_dp
    r = 0
    for a in dp:  # row block index, pod-major
        r = r * sizes[a] + mesh.get_local_rank(a)
    xf = x[r * b_loc:(r + 1) * b_loc].reshape(b_loc * s, d)
    top_w, top_e = _route(params, cfg, xf)
    e_loc = cfg.n_experts // n_model
    j = mesh.get_local_rank("model") if n_model > 1 else 0
    experts = {n: w[j * e_loc:(j + 1) * e_loc]
               for n, w in params["experts"].items()}
    out = _dispatch_compute_combine(xf, top_w, top_e, experts, cfg,
                                    j * e_loc)
    if n_model > 1:
        dist.all_reduce(out, group=mesh.get_group("model"))
    out = out.reshape(b_loc, s, d)
    for a in reversed(dp):
        parts = [torch.empty_like(out) for _ in range(sizes[a])]
        dist.all_gather(parts, out, group=mesh.get_group(a))
        out = torch.cat(parts)
    return out


_moe_sharded.calls = 0


def moe_apply(params, static, cfg: MoEConfig, x: torch.Tensor,
              kernels: bool = True) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]; ``kernels`` goes to the shared
    experts' MLP (``layers.mlp_apply``)."""
    mesh = current_mesh()
    use_sharded = False
    if mesh is not None:
        sizes = mesh_axis_sizes(mesh)
        n_dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
        use_sharded = (x.shape[0] % n_dp == 0
                       and cfg.n_experts % sizes.get("model", 1) == 0)
    if use_sharded:
        out = _moe_sharded(params, cfg, x, mesh)
    else:
        out = _moe_local(params, cfg, x)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], static["shared"], x,
                              kernels)
    return out


def _earlier(tp, top_e: torch.Tensor, n_experts: int):
    """``_dispatch_slots``' ``earlier`` for this rank's row block: None
    where MoE counts capacity on the block alone
    (``parallel.tensor.moe_per_block``, the reference's
    ``_moe_shard_map``), else the pairs each expert took on the earlier
    row blocks (every block's counts all-gathered,
    ``tp.data_gather_bytes``) and the tokens of all blocks (its
    ``_moe_local`` over the whole batch).  The blocks are ``tp.rows``
    over its dims (a placed serving step's, ``parallel.tensor.
    serve_rows``; one block: None, the rows are the batch), else the
    sharded train step's over ``pod``/``data``
    (``parallel.tensor.data_shards``).  The counts are a comparison's
    sum, which a fake tensor can take (``bincount``'s length depends on
    the data)."""
    dp = data_shards(tp.mesh)[1]
    if tp.rows is None:
        (r, blocks), dims = data_shards(tp.mesh), ("data", "pod")
    else:
        r, blocks, dims = tp.rows
    if blocks == 1 or moe_per_block(n_experts, tp.size, blocks, dp):
        return None
    flat = top_e.reshape(-1)
    mine = (flat[:, None] == torch.arange(n_experts, device=flat.device)
            ).sum(0)
    counts = gather_over_data(tp.mesh, mine, dims, tp)
    return counts[:r].sum(0), top_e.shape[0] * blocks


def moe_apply_tp(tp, params, static, cfg: MoEConfig, x: torch.Tensor,
                 split: bool, kernels: bool = True,
                 shared_split: bool = False, seq: bool = False
                 ) -> torch.Tensor:
    """:func:`moe_apply` inside ``parallel.tensor.tensor_parallel_ctx``
    (the sharded train step's, a placed serving step's), on this rank's
    rows of the batch: the twin of :func:`_moe_sharded`, with gradients.
    With ``split`` (``parallel.tensor.experts_split``) ``params["experts"]``
    is the rank's slab of ``tp``'s ``model`` group: every token of the
    rows runs through the slab's experts and the partial outputs sum over
    the group; else every rank runs all experts.  The router runs whole,
    and the shared experts on their ``ff`` slabs with ``shared_split``
    (``layers.mlp_apply_tp``), else whole.  Capacity is the rows' own
    where the batch divides over the data dims and the experts over
    ``model``, as the reference's ``moe_apply`` counts it under its mesh;
    else the whole batch's, each pair's place in its expert's queue after
    the earlier blocks' (:func:`_earlier`).

    ``seq``: ``x`` is this rank's slab of the sequence, gathered once
    (``parallel.tensor.gather_sequence``) for the router, the experts and
    the shared experts, so routing and capacity see every token of the
    rows.  The split parts read the gathered input directly (their
    gradient parts reduce-scatter back), the whole ones through
    ``count_once`` (their gradient, whole on every rank, counted once);
    the split outputs are reduce-scattered, the whole ones split, and
    the output is this rank's slab."""
    xin = gather_sequence(x, tp) if seq else x
    b, s, d = xin.shape
    xf = xin.reshape(b * s, d)
    xw = count_once(xf, tp) if seq else xf  # what runs whole
    top_w, top_e = _route(params, cfg, xw)
    earlier = _earlier(tp, top_e, cfg.n_experts)
    slab, whole = None, None
    if split:
        e_loc = cfg.n_experts // tp.size
        part = _dispatch_compute_combine(
            xf if seq else copy_to_model(xf, tp), copy_to_model(top_w, tp),
            top_e, params["experts"], cfg, tp.rank * e_loc,
            earlier).reshape(b, s, d)
        if seq:
            slab = scatter_sequence(part, tp)
        else:
            whole = reduce_from_model(part, tp)
    else:
        whole = _dispatch_compute_combine(xw, top_w, top_e, params["experts"],
                                          cfg, 0, earlier).reshape(b, s, d)
    if "shared" in params and shared_split:
        out = mlp_apply_tp(tp, params["shared"], static["shared"], xin,
                           kernels, seq, gathered=seq)
        slab = out if slab is None else slab + out
        if not seq:
            whole, slab = whole + slab, None
    elif "shared" in params:
        out = mlp_apply(params["shared"], static["shared"],
                        xw.reshape(b, s, d), kernels)
        whole = out if whole is None else whole + out
    if not seq:
        return whole
    if whole is None:
        return slab
    whole = split_sequence(whole, tp)
    return whole if slab is None else slab + whole
