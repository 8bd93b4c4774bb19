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
    token and every expert.

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

A drop depends on what else the batch holds (idle decode slots
included), as in the reference.  The combine un-sorts the weighted
contributions to ``[t, k]`` and sums over ``k``: the reference's
scatter-add, in a fixed order (``index_add_`` on CUDA sums in atomic
order).  The expert products are ``torch.einsum``, as the reference's are
XLA einsums outside any Pallas kernel.  Nothing here reads the device
from the host.
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
    mlp_init,
    mlp_specs,
    mlp_static,
    silu,
)
from repro_torch.parallel.activations import current_mesh
from repro_torch.parallel.sharding import mesh_axis_sizes
from repro_torch.parallel.tensor import (
    copy_to_model,
    data_shards,
    gather_over_data,
    reduce_from_model,
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
    ``top_e`` [T, k] to the local experts ``[e0, e0 + e_loc)``:
    (order, tok_sorted, slot, keep), each over the pairs in expert order.
    ``slot`` is the pair's row in the ``[e_loc * cap + 1]`` gather (the
    last row the sentinel of every dropped or foreign pair).

    ``earlier`` = (pairs [E] each expert took on the row blocks before
    this one, tokens of all row blocks) dispatches these tokens as the
    batch's row block: capacity over all its tokens, each pair's place in
    its expert's queue after the earlier blocks' pairs (the reference's
    dispatch of the whole batch, cut to these rows)."""
    dev = top_e.device
    cap = capacity(t if earlier is None else earlier[1], cfg)
    flat_e = top_e.reshape(-1) - e0  # local expert index (may be OOB)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(cfg.top_k)
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
    return order, flat_tok[order], slot, keep


def kept_pairs(top_e: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """bool [T, k]: which (token, k) pairs of ``top_e`` the dispatch keeps
    (within its expert's capacity)."""
    t, k = top_e.shape
    order, _, _, keep = _dispatch_slots(top_e, t, cfg, 0, cfg.n_experts)
    out = torch.empty_like(keep)
    out[order] = keep
    return out.reshape(t, k)


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
    (contributions of local experts only)."""
    t, d = xf.shape
    k = cfg.top_k
    dev = xf.device
    e_loc = experts["up"].shape[0]
    cap = capacity(t if earlier is None else earlier[1], cfg)
    order, tok_sorted, slot, keep = _dispatch_slots(top_e, t, cfg, e0, e_loc,
                                                    earlier)
    # a foreign or dropped pair's weight is zero wherever it lands
    w_sorted = torch.where(keep, top_w.reshape(-1)[order], 0.0)

    gathered = torch.zeros((e_loc * cap + 1, d), dtype=xf.dtype, device=dev)
    # kept slots are distinct; every dropped pair writes zeros to the
    # sentinel row
    gathered[slot] = torch.where(keep[:, None], xf[tok_sorted], 0).to(
        xf.dtype)
    xe = gathered[:-1].reshape(e_loc, cap, d)

    h = torch.einsum("ecd,edf->ecf", xe, experts["up"].to(xf.dtype))
    if cfg.act == "swiglu":
        g = torch.einsum("ecd,edf->ecf", xe, experts["gate"].to(xf.dtype))
        h = silu(g) * h
    else:
        h = gelu(h)
    ye = torch.einsum("ecf,efd->ecd", h, experts["down"].to(xf.dtype))
    ye = torch.cat([ye.reshape(e_loc * cap, d),
                    torch.zeros((1, d), dtype=ye.dtype, device=dev)])

    contrib = ye[slot] * w_sorted[:, None].to(xf.dtype)
    # un-sort to (token, k) order and sum over k: the reference's
    # scatter-add over tok_sorted, in a fixed order
    pairs = torch.empty_like(contrib)
    pairs[order] = contrib
    return pairs.reshape(t, k, d).sum(dim=1)


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


def moe_apply_tp(tp, params, static, cfg: MoEConfig, x: torch.Tensor,
                 split: bool, kernels: bool = True) -> torch.Tensor:
    """:func:`moe_apply` inside the sharded train step
    (``parallel.tensor.tensor_parallel_ctx``), on this rank's rows of the
    batch: the training twin of :func:`_moe_sharded`, with gradients.
    With ``split`` (``parallel.tensor.experts_split``) ``params["experts"]``
    is the rank's slab of ``tp``'s ``model`` group: every token of the
    rows runs through the slab's experts and the partial outputs sum over
    the group; else every rank runs all experts.  The router and the
    shared experts run whole.  Capacity and each pair's place in its
    expert's queue are the whole batch's (the rows' row block after the
    earlier blocks', counts all-gathered over ``pod``/``data``), as the
    reference's step computes them over its global batch."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    top_w, top_e = _route(params, cfg, xf)
    r, blocks = data_shards(tp.mesh)
    counts = gather_over_data(tp.mesh, torch.bincount(
        top_e.reshape(-1), minlength=cfg.n_experts))
    earlier = (counts[:r].sum(0), b * s * blocks)
    if split:
        e_loc = cfg.n_experts // tp.size
        out = reduce_from_model(_dispatch_compute_combine(
            copy_to_model(xf, tp), copy_to_model(top_w, tp), top_e,
            params["experts"], cfg, tp.rank * e_loc, earlier), tp)
    else:
        out = _dispatch_compute_combine(xf, top_w, top_e, params["experts"],
                                        cfg, 0, earlier)
    out = out.reshape(b, s, d)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], static["shared"], x,
                              kernels)
    return out
