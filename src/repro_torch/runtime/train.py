"""Training runtime: loss, train step, fault-tolerant driver loop.

Port of ``src/repro/runtime/train.py`` on one device.  The step function
supports, as the reference's does:

  * gradient accumulation (``microbatches`` > 1): microbatch ``j`` holds
    the contiguous rows ``[j * B / n, (j + 1) * B / n)`` (the reference's
    ``reshape((n, B // n))``), and the losses and gradients are averaged;
  * global-norm clipping;
  * int8 error-feedback gradient compression (``grad_compression``), see
    ``optim.compression``;
  * the MTP auxiliary loss (DeepSeek-V3) on ``roll(labels, -1)``, the
    wrapped last label included, as the reference's ``jnp.roll``;
  * a VLM's suffix scoring: logits over prefix + tokens, the last
    ``labels.shape[1]`` scored.

Gradients come from ``torch.autograd`` through ``apply_model(...,
kernels=False)``: every layer on its plain version, as the reference
trains through XLA routes (its Pallas kernels have no backward, and the
port's kernel wrappers refuse inputs that require grad), with the
reference's remat (``cfg.remat``, the default: each period of the body
recomputed in the backward, ``models.transformer._remat``).  The
state's tensors never require grad: each step differentiates detached
copies of the params, and the optimizer returns new tensors.

The Trainer drives checkpoint/restart: periodic (async) checkpoints,
failure injection for drills, straggler detection, and resume-from-latest
— a SimulatedFailure mid-run restores and continues bit-exactly (tested).

**Sharded** (``shardings=`` a :class:`TrainShardings` over a
``DeviceMesh``; every rank calls the step with its own rows of the
batch, ``data.shard_batch``).  The step computes the reference's global
step, what GSPMD computes for its jitted step under ``param_shardings``:
the loss and the gradient over the whole batch (each rank's mean over
its rows, microbatched as on one device, then averaged over the
``pod``/``data`` ranks), then clipping to the global norm, int8
compression and the update on that averaged gradient, as on one device.
What each rank stores:

  * ``params``: the slab ``launch.steps.param_shardings`` gives it;
  * the optimizer's moments (every tree of ``opt_state``): the slab
    ``launch.steps._zero1`` gives it, split further over ``data``; each
    rank updates only that slab and all-gathers the new params over
    ``data`` back to its param slab;
  * ``comp_state``: split as ``params``, as the reference derives it from
    the params (``zeros_like``);
  * ``step`` and the optimizer's ``count``: whole on every rank, as the
    reference's ``P()``.

Compute is split over ``model`` where the reference's GSPMD step splits
it (``parallel.tensor``): inside ``tensor_parallel_ctx`` the attention
query heads (the key heads each rank's query heads read re-laid out to
it where the key heads do not split with them), MLA's heads, the SSM's heads (its packed columns re-laid
out), the MLPs' ``ff`` (the sparse MLPs' tiles), the MoE experts and
shared experts, and the embedding's and the head's vocabulary compute on
the rank's slabs, whose gradients stay slabs; the logits are then a slab
of columns, and :func:`cross_entropy` reduces its max, its sum of
exponentials and the labels' logits over ``model``.  A split leaf whose
block's heads or widths do not divide over ``model``
(``parallel.tensor.layer_splits``) is all-gathered over the mesh each
step and computed whole, its gradient whole on every rank, as the whole
leaves (norms, routers, latent projections) are.  Where ``model``
divides a stream's length, the residual stream between layers is the
rank's slab of the sequence (``parallel.activations.shard_activation``):
split blocks gather it and reduce-scatter their outputs, and a whole
leaf that computes on the slab (a norm) sums its gradient over
``model``.

The gradients then go to the moment slabs, as GSPMD reduce-scatters
them onto the reference's ZeRO-1 moments: each leaf is cut to its param
slab, reduce-scattered over ``data`` onto its moment slab where
``_zero1`` splits a dim over ``data`` (all-reduced over ``data``
otherwise), then all-reduced over ``pod``; clipping, compression and
the update run on those slabs.  Two whole-leaf quantities stay
whole-leaf: the global norm sums each slab's squares over every dim that
splits it (``model``, then ``data``), and int8 compression takes each
leaf's scale from its largest value over the same dims; the new
residuals are all-gathered over ``data`` back to their param slabs.
MoE counts capacity as the reference's step does under its mesh
(``models.moe.moe_apply_tp``): on each rank's rows alone where ``model``
divides the experts, so with ``n`` microbatches each rank cuts its own
rows into ``n`` and the step is the unsharded one at ``n`` x pod x data
microbatches (the same blocks of ``B / (n dp)`` contiguous rows, each
counted alone, the loss a mean over them).  Where ``model`` does not
divide some MoE layer's experts, capacity is the global microbatch's: the
batch is all-gathered over ``pod``/``data`` and each rank's microbatch
``j`` is its row block of the global rows ``[j B / n, (j + 1) B / n)``,
as the reference cuts them.

``step.comm`` holds the last step's bytes: ``param_gather_bytes`` (the
params all-gathered, whole), ``model_reduce_bytes`` and
``model_gather_bytes`` (activations and their gradients all-reduced and
all-gathered along their last dim over ``model``; with ``cfg.remat`` the
body's forward runs again in the backward, ``parallel.tensor.
model_bytes``), ``model_scatter_bytes`` and ``model_seq_gather_bytes``
(the split stream reduce-scattered, its slabs' bytes, and all-gathered
along the sequence, over ``model``), ``model_relayout_bytes`` (the
SSM's and the key heads' param columns re-laid out over ``model``,
forward, and their gradients back), ``model_stat_bytes`` and ``data_stat_bytes`` (the
global norm's and int8 compression's per-leaf statistics over ``model``
and over ``data``), ``data_reduce_bytes`` (the loss, and the gradients
not split over ``data``, all-reduced over ``pod``/``data``),
``data_scatter_bytes`` (the gradients reduce-scattered over ``data``:
the slabs' bytes) and ``zero_gather_bytes`` (the updated params, and
the new residuals, all-gathered over ``data``); :func:`comm_by_kind`
sums them by collective kind.

A sharded state checkpoints through ``Trainer``: whole leaves gathered
over the mesh, written once by rank 0 in the reference's layout, then a
barrier; a restore onto any mesh cuts each rank's slab from the whole
leaves (``checkpoint.restore_checkpoint(placements=)``).  On a one-rank
mesh every gather, cut and reduction is the identity, and the step is the
unsharded step bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.launch.steps import _zero1, param_shardings
from repro_torch.models.transformer import ModelConfig, apply_model
from repro_torch.optim import (
    Optimizer,
    clip_by_global_norm,
    compress_gradients,
    decompress_gradients,
    init_compression_state,
)
from repro_torch.optim.optimizers import _leaves, _map, donated_map
from repro_torch.parallel.sharding import (
    _entry_axes,
    cut_slab,
    gather_tensor,
    mesh_axis_sizes,
    shard_tensor,
    shard_tree,
)
from repro_torch.parallel.tensor import (
    check_slabs,
    current,
    data_shards,
    gather_over_data,
    moe_per_block,
    reduce_from_model,
    reduce_scatter,
    slab_leaves,
    tensor_parallel_ctx,
    vocab_splits,
)
from repro_torch.runtime.fault import FailureInjector, StragglerDetector

__all__ = ["TrainConfig", "TrainShardings", "train_shardings",
           "state_placements", "cross_entropy", "comm_by_kind",
           "make_train_step",
           "init_train_state", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    grad_clip: float = 1.0
    grad_compression: bool = False
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_keep: int = 3
    async_ckpt: bool = False
    mtp_weight: float = 0.3
    log_every: int = 10


@dataclasses.dataclass(frozen=True)
class TrainShardings:
    """Where each rank of ``mesh`` keeps its share of a training state:
    ``params`` (``param_shardings``) and ``moments`` (``_zero1`` of them),
    trees of ``parallel.sharding.Placement``."""

    mesh: object
    params: object
    moments: object


def train_shardings(specs, shapes, mesh) -> TrainShardings:
    """The placements of a training state on ``mesh`` from the params'
    logical specs (``models.transformer.init_specs``) and their shapes (a
    tree of tensors or shapes)."""
    p_shard = param_shardings(specs, shapes, mesh)
    return TrainShardings(mesh, p_shard, _zero1(p_shard, shapes, mesh))


def state_placements(shardings: TrainShardings, state) -> dict:
    """The placement tree of a sharded state: ``None`` for a leaf every
    rank holds whole (``step``, the optimizer's ``count``)."""
    tree = {"params": shardings.params,
            "opt_state": {k: shardings.moments if isinstance(v, (dict, list))
                          else None for k, v in state["opt_state"].items()},
            "step": None}
    if "comp_state" in state:
        tree["comp_state"] = shardings.params
    return tree


def _mean_over_data(mesh, loss, grads, shardings: "TrainShardings", slab,
                    comm: dict):
    """The loss and the gradient averaged over the ranks that hold other
    rows of the batch (``pod`` and ``data``), the gradient on this rank's
    ZeRO-1 moment slabs (``shardings.moments``).  Each gradient leaf is
    first cut to its param slab (a leaf computed on its slab already is
    one); a leaf whose moments split a dim over ``data`` is then
    reduce-scattered over ``data`` onto that dim's slab
    (``comm["data_scatter_bytes"]``: the slab's bytes, as
    ``launch.op_stats`` counts a reduce-scatter), the rest all-reduced
    over ``data``; then each is all-reduced over ``pod``, as the loss is
    over both (``comm["data_reduce_bytes"]``).  Ranks of one data shard
    reduce identical values in the same order, so they stay equal."""
    sizes = mesh_axis_sizes(mesh)
    n = sizes.get("pod", 1) * sizes.get("data", 1)

    def reduce(t, axes):
        for a in axes:
            if sizes.get(a, 1) > 1:
                dist.all_reduce(t, group=mesh.get_group(a))
                comm["data_reduce_bytes"] += t.numel() * t.element_size()
        return t

    def one(g, pl, z, on_slab):
        g = g if on_slab else shard_tensor(g, pl)
        if n == 1:
            return g
        at = [d for d, e in enumerate(z.pspec) if "data" in _entry_axes(e)]
        if at and sizes["data"] > 1:
            g = reduce_scatter(g, at[0], mesh.get_group("data"))
            comm["data_scatter_bytes"] += g.numel() * g.element_size()
            return reduce(g, ("pod",)) / n
        return reduce(g, ("data", "pod")) / n

    grads = _map(one, grads, shardings.params, shardings.moments, slab)
    if n == 1:
        return loss, grads
    return reduce(loss.clone(), ("data", "pod")) / n, grads


def comm_by_kind(comm: dict) -> dict:
    """A sharded step's ``step.comm`` summed by collective kind, under
    ``launch.op_stats``' names (an all-gather's bytes its whole output's,
    a reduce-scatter's its slab's): what ``OpStats.
    collective_bytes_by_kind`` counts of the same step but where MoE
    counts capacity over the whole batch (its batch and count gathers,
    which ``step.comm`` does not count)."""
    return {"all-gather": comm["param_gather_bytes"]
            + comm["model_gather_bytes"] + comm["model_seq_gather_bytes"]
            + comm["zero_gather_bytes"],
            "all-reduce": comm["model_reduce_bytes"]
            + comm["model_stat_bytes"] + comm["data_stat_bytes"]
            + comm["data_reduce_bytes"],
            "reduce-scatter": comm["model_scatter_bytes"]
            + comm["data_scatter_bytes"],
            "all-to-all": comm["model_relayout_bytes"]}


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, vocab: int, tp=None
) -> torch.Tensor:
    """Mean CE in float32; the padding columns (``>= vocab``) are set to
    -1e30 before the log-softmax, so they carry no probability.  Each
    row's label log-probability is picked by a mask and a sum (exact: one
    term is nonzero), so the backward scatters nothing and is
    deterministic on the card.

    With ``tp`` (a ``parallel.tensor.TensorParallel``), ``logits`` are
    this rank's slab of the padded vocabulary's columns (rank ``r`` the
    columns ``[r W, (r + 1) W)``): the row max is all-reduced by ``MAX``
    and detached, the sum of exponentials and the label's logit (picked
    where the global column is the label) sum over the group, so every
    rank returns the whole loss."""
    lf = logits.float()
    if tp is not None:
        w = lf.shape[-1]
        cols = tp.rank * w + torch.arange(w, device=lf.device)
        lf = torch.where(cols < vocab, lf, -1e30)
        m = tp.all_reduce(lf.detach().amax(dim=-1, keepdim=True),
                          dist.ReduceOp.MAX)
        sumexp = reduce_from_model(torch.exp(lf - m).sum(-1), tp)
        pick = cols == labels[..., None].long()
        picked = reduce_from_model(torch.where(
            pick, lf, torch.zeros((), device=lf.device)).sum(-1), tp)
        return -(picked - m[..., 0] - torch.log(sumexp)).mean()
    if logits.shape[-1] > vocab:
        lf = torch.cat([lf[..., :vocab],
                        lf.new_full((*lf.shape[:-1], lf.shape[-1] - vocab),
                                    -1e30)], dim=-1)
    logp = torch.log_softmax(lf, dim=-1)
    cols = torch.arange(logp.shape[-1], device=logp.device)
    pick = cols == labels[..., None].long()
    ll = torch.where(pick, logp, torch.zeros((), device=logp.device)).sum(-1)
    return -ll.mean()


def make_train_step(
    cfg: ModelConfig,
    statics,
    opt: Optimizer,
    lr_fn: Callable,
    tcfg: TrainConfig,
    model_kwargs_fn: Callable[[dict], dict] | None = None,
    shardings: TrainShardings | None = None,
    donate: bool = False,
):
    """Returns step(state, batch) -> (state, metrics).

    state = {params, opt_state, step, [comp_state]}.
    batch = {'tokens': [B, S+1], ...extra model inputs}, tensors on the
    params' device.  ``model_kwargs_fn(batch)`` gives ``apply_model``'s
    extra inputs (whisper's ``frames``, a VLM's ``prefix_embeds``).
    With ``shardings``, the state is the sharded one of
    :func:`init_train_state` and the batch this rank's rows (module
    docstring).  Without ``shardings``, ``step.loss_and_grads(params,
    batch)`` gives the step's loss and gradients (microbatched as the
    step) and no update: the part of the step that remat changes.

    ``donate``: the step gives up the state it is called with, as the
    reference's jitted step donates it (``donate_argnums=(0,)``): the
    caller's state containers are emptied as the step starts, the grads
    are clipped in place, and the update writes AdamW's float32 moments
    and the params into the given tensors, each old leaf released as the
    update reaches it (on the ZeRO-1 path each param slab once its moment
    slab is cut; ``optim.optimizers.donated_map``), so the step holds one
    state, not two.  Its results are the functional step's bit for bit.
    """

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        kwargs = model_kwargs_fn(batch) if model_kwargs_fn else {}
        logits, _, aux = apply_model(params, statics, inputs, kernels=False,
                                     **kwargs)
        if logits.shape[1] != labels.shape[1]:  # vlm prefix: score suffix
            logits = logits[:, -labels.shape[1]:]
        # the logits are a vocabulary slab where apply_model split it
        tp = current()
        tp = tp if tp is not None and vocab_splits(cfg, tp.size) else None
        loss = cross_entropy(logits, labels, cfg.vocab, tp)
        if "mtp_logits" in aux:
            mtp_labels = torch.roll(labels, -1, dims=1)
            loss = loss + tcfg.mtp_weight * cross_entropy(
                aux["mtp_logits"][:, : mtp_labels.shape[1]], mtp_labels,
                cfg.vocab, tp,
            )
        return loss

    def value_and_grad(params, batch):
        leaves = _leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        tree = _map(lambda _: next(it), params)
        with torch.enable_grad():
            loss = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        # a leaf the loss does not reach gets zeros, as jax.grad gives it
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads, leaves))
        return loss.detach(), _map(lambda _: next(it), params)

    def microbatch(batch, j: int) -> dict:
        """Microbatch ``j`` of ``tcfg.microbatches`` of ``batch``: its
        rows ``[j B / n, (j + 1) B / n)`` (the reference's ``reshape((n,
        B // n))``); with ``whole_counts``, ``batch`` is the global one
        and this rank takes its row block of them."""
        nmb = tcfg.microbatches
        b = batch["tokens"].shape[0]
        r, blocks = data_shards(mesh) if whole_counts else (0, 1)
        if b % (nmb * blocks):
            raise ValueError(f"{b} rows do not cut into {nmb} microbatches "
                             f"of {blocks} row blocks")
        per = b // (nmb * blocks)
        lo = j * b // nmb + r * per
        return {k: v[lo:lo + per] for k, v in batch.items()}

    def loss_and_grads(params, batch):
        nmb = tcfg.microbatches
        if nmb > 1:
            if whole_counts:  # the global batch: row blocks in order
                batch = {k: gather_over_data(mesh, v).flatten(0, 1)
                         for k, v in batch.items()}
            loss, grads = 0.0, None
            for j in range(nmb):
                l_j, g_j = value_and_grad(params, microbatch(batch, j))
                loss = loss + l_j
                grads = g_j if grads is None else _map(torch.add, grads, g_j)
            loss = loss / nmb
            grads = _map(lambda g: g / nmb, grads)
        else:
            loss, grads = value_and_grad(params, batch)
        return loss, grads

    sharded = shardings is not None
    mesh = shardings.mesh if sharded else None
    sizes = mesh_axis_sizes(mesh) if sharded else {}
    n_model = sizes.get("model", 1)
    # leaves computed on their slabs (parallel.tensor); gathered otherwise
    slab = (slab_leaves(cfg, statics, shardings.params, n_model) if sharded
            else None)
    if sharded:
        check_slabs(shardings.params, slab)
    # where MoE counts capacity over the whole microbatch, every rank's
    # rows take part in each microbatch (a train step's rows split over
    # every pod and data rank, so the rule turns on the experts alone)
    dp = data_shards(mesh)[1] if sharded else 1
    whole_counts = (sharded and cfg.moe is not None and not moe_per_block(
        cfg.moe.n_experts, n_model, dp, dp))

    def whole(tree):
        """A params-shaped tree with every leaf that is not computed on
        its slab whole: gathered over the mesh if sharded
        (``comm["param_gather_bytes"]``)."""
        if not sharded:
            return tree

        def one(t, pl, on_slab):
            if on_slab or pl.whole:
                return t
            out = gather_tensor(t, pl, mesh)
            step.comm["param_gather_bytes"] += (out.numel()
                                                * out.element_size())
            return out

        return _map(one, tree, shardings.params, slab)

    def over_slabs(tree, op):
        """A hook of ``global_norm`` / ``compress_gradients`` on ``tree``,
        on this rank's moment slabs: their per-leaf values, each reduced
        by ``op`` over every mesh dim its slab splits (one all-reduce a
        dim, ``model``'s first, then ``data``'s), so each is the whole
        leaf's; None when no leaf is split."""
        dims = _leaves(_map(lambda _, z: tuple(
            a for e in z.pspec for a in _entry_axes(e) if sizes[a] > 1),
            tree, shardings.moments)) if sharded else []
        order = [a for a in ("model", "data", "pod")
                 if any(a in d for d in dims)]
        if not order:
            return None

        def reduce(vals):
            vals = list(vals)
            for a in order:
                at = [i for i, d in enumerate(dims) if a in d]
                t = torch.stack([vals[i] for i in at])
                dist.all_reduce(t, op=op, group=mesh.get_group(a))
                key = "model_stat_bytes" if a == "model" else "data_stat_bytes"
                step.comm[key] += t.numel() * t.element_size()
                for j, i in enumerate(at):
                    vals[i] = t[j]
            return vals

        return reduce

    def to_moments(tree):
        """A params-shaped tree (slab leaves on their slabs, the rest
        whole) cut to this rank's ZeRO-1 moment slabs; donated, each
        leaf of ``tree`` dropped once its moment slab is cut."""
        return consume(lambda t, pl, z, on_slab: cut_slab(t, pl, z)
                       if on_slab else shard_tensor(t, z), tree,
                       shardings.params, shardings.moments, slab)

    def to_params(tree):
        """A tree of this rank's moment slabs all-gathered over ``data``
        back to its param slabs (``comm["zero_gather_bytes"]``)."""
        n_data = sizes.get("data", 1)

        def back(t, z):
            out = gather_tensor(t, z, mesh, ("data",))
            if n_data > 1 and any("data" in _entry_axes(e) for e in z.pspec):
                step.comm["zero_gather_bytes"] += (out.numel()
                                                   * out.element_size())
            return out

        return consume(back, tree, shardings.moments)

    def consume(fn, tree, *rest):
        """``_map(fn, tree, *rest)``; donated, each leaf of ``tree``
        leaves its container as ``fn`` takes it."""
        if donate:
            return donated_map(fn, 1, tree, *rest)
        return _map(fn, tree, *rest)

    def update(grads, opt_state, params, lr):
        """The optimizer's update; sharded, on this rank's moment slabs
        (ZeRO-1), where the gradient already is, the new params then
        gathered over ``data`` back to the rank's param slabs."""
        kw = {"donate": True} if donate else {}
        if not sharded:
            return opt.update(grads, opt_state, params, lr, **kw)
        slabs, new_opt = opt.update(grads, opt_state, to_moments(params), lr,
                                    **kw)
        return to_params(slabs), new_opt

    def step(state, batch):
        if donate:  # the caller's containers emptied: this holds them now
            state = _take(state)
        step.comm = dict.fromkeys(step.comm, 0)
        params = whole(state.pop("params") if donate else state["params"])
        if sharded and mesh.size() > 1:
            with tensor_parallel_ctx(mesh) as tp:
                loss, grads = loss_and_grads(params, batch)
            step.comm["model_reduce_bytes"] = tp.reduce_bytes
            step.comm["model_gather_bytes"] = tp.gather_bytes
            step.comm["model_relayout_bytes"] = tp.relayout_bytes
            step.comm["model_scatter_bytes"] = tp.scatter_bytes
            step.comm["model_seq_gather_bytes"] = tp.seq_gather_bytes
            loss, grads = _mean_over_data(mesh, loss, grads, shardings,
                                          slab, step.comm)
        else:  # one device, or a one-rank mesh: every slab whole
            loss, grads = loss_and_grads(params, batch)
        grads, gnorm = clip_by_global_norm(
            grads, tcfg.grad_clip, over_slabs(grads, dist.ReduceOp.SUM),
            in_place=donate)
        if tcfg.grad_compression:
            residuals = state["comp_state"]
            if sharded:  # the param slabs' residuals on the moment slabs
                residuals = _map(cut_slab, residuals, shardings.params,
                                 shardings.moments)
            comp, new_comp_state = compress_gradients(
                grads, residuals, over_slabs(grads, dist.ReduceOp.MAX))
            grads = decompress_gradients(comp)
            if sharded:
                new_comp_state = to_params(new_comp_state)
        lr = lr_fn(state["step"])
        new_params, new_opt = update(
            grads, state.pop("opt_state") if donate else state["opt_state"],
            params, lr)
        new_state = {
            "params": new_params,
            "opt_state": new_opt,
            "step": state["step"] + 1,
        }
        if tcfg.grad_compression:
            new_state["comp_state"] = new_comp_state
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_state, metrics

    if not sharded:
        step.loss_and_grads = loss_and_grads
    step.comm = dict.fromkeys(("param_gather_bytes", "model_reduce_bytes",
                               "model_gather_bytes", "model_relayout_bytes",
                               "model_scatter_bytes", "model_seq_gather_bytes",
                               "model_stat_bytes", "data_stat_bytes",
                               "data_reduce_bytes", "data_scatter_bytes",
                               "zero_gather_bytes"),
                              0)
    return step


def init_train_state(params, opt: Optimizer, tcfg: TrainConfig,
                     shardings: TrainShardings | None = None):
    """{params, opt_state, step (int32 0-d, on the params' device),
    [comp_state]}.  With ``shardings``, ``params`` are the whole params
    (the same on every rank) and the state keeps this rank's slabs: the
    params' and the compression residuals' by ``shardings.params``, the
    moments' by ``shardings.moments``."""
    device = _leaves(params)[0].device
    if shardings is None:
        slabs, opt_state = params, opt.init(params)
    else:
        slabs = shard_tree(params, shardings.params)
        opt_state = opt.init(shard_tree(params, shardings.moments))
    state = {
        "params": slabs,
        "opt_state": opt_state,
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if tcfg.grad_compression:
        state["comp_state"] = init_compression_state(slabs)
    return state


def _take(tree):
    """``tree``'s leaves in containers of their own, ``tree``'s emptied:
    a donated state, which its caller no longer holds."""
    if isinstance(tree, dict):
        out = {k: _take(v) for k, v in tree.items()}
    elif isinstance(tree, list):
        out = [_take(v) for v in tree]
    else:
        return tree
    tree.clear()
    return out


def _to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class Trainer:
    """Fault-tolerant training driver (checkpoint / restart / stragglers).

    ``put_batch`` turns each batch of ``batches`` into the step's input;
    the default moves its arrays to the params' device.  With
    ``shardings`` (the step's), the state is sharded: checkpoints hold
    whole leaves, written by rank 0, and a restore cuts this rank's
    slabs (module docstring)."""

    def __init__(
        self,
        step_fn,
        state,
        batches,
        tcfg: TrainConfig,
        injector: FailureInjector | None = None,
        put_batch=None,
        shardings: TrainShardings | None = None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.tcfg = tcfg
        self.injector = injector or FailureInjector()
        device = _leaves(state["params"])[0].device
        self.put_batch = put_batch or (lambda b: _to_device(b, device))
        self.ckpt = Checkpointer(
            tcfg.ckpt_dir, keep=tcfg.ckpt_keep, async_save=tcfg.async_ckpt,
            mesh=None if shardings is None else shardings.mesh,
            placements=None if shardings is None
            else state_placements(shardings, state),
        )
        self.straggler = StragglerDetector()
        self.history: list[dict] = []

    def maybe_restore(self) -> int:
        step = self.ckpt.latest_step()
        if step is not None:
            self.state = self.ckpt.restore(step, self.state)
            return step
        return 0

    def run(self, steps: int | None = None):
        """Run (or resume) the training loop.

        A SimulatedFailure propagates to the caller, who restarts by
        constructing a fresh Trainer and calling maybe_restore() + run()
        — the integration test exercises exactly that sequence and asserts
        bit-identical losses vs an uninterrupted run.
        """
        steps = steps if steps is not None else self.tcfg.steps
        start = int(self.state["step"])
        for step in range(start, steps):
            batch = self.put_batch(next(self.batches))
            self.injector.maybe_fail(step)
            t0 = time.monotonic()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.straggler.record(step, dt)
            metrics.update(step=step, seconds=dt)
            self.history.append(metrics)
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == steps:
                self.ckpt.save(step + 1, self.state)
        self.ckpt.wait()
        return self.history
