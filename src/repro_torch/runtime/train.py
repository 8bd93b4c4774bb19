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
port's kernel wrappers refuse inputs that require grad).  The state's
tensors never require grad: each step differentiates detached copies of
the params, and the optimizer returns new tensors.

The Trainer drives checkpoint/restart: periodic (async) checkpoints,
failure injection for drills, straggler detection, and resume-from-latest
— a SimulatedFailure mid-run restores and continues bit-exactly (tested).

**Sharded** (``shardings=`` a :class:`TrainShardings` over a
``DeviceMesh``; every rank calls the step with its own rows of the
batch, ``data.shard_batch``).  The step computes the reference's global
step, what GSPMD computes for its jitted step under ``param_shardings``:
the loss and the gradient over the whole batch (each rank's mean over
its rows, microbatched as on one device, then averaged over the
``pod``/``data`` ranks by an all-reduce), then clipping to the global
norm, int8 compression and the update on that averaged gradient, as on
one device.  What each rank stores:

  * ``params``: the slab ``launch.steps.param_shardings`` gives it;
  * the optimizer's moments (every tree of ``opt_state``): the slab
    ``launch.steps._zero1`` gives it, split further over ``data``; each
    rank updates only that slab and all-gathers the new params over
    ``data`` back to its param slab;
  * ``comp_state``: split as ``params``, as the reference derives it from
    the params (``zeros_like``);
  * ``step`` and the optimizer's ``count``: whole on every rank, as the
    reference's ``P()``.

Compute is split over ``model`` where the reference's GSPMD step
splits it (``parallel.tensor``): inside ``tensor_parallel_ctx`` the
attention heads, the MLPs' ``ff`` (the sparse MLPs' tiles) and the MoE
experts compute on the rank's slabs, whose gradients stay slabs; every
other leaf (MLA, the SSM, the embedding and the head, norms, routers)
is all-gathered over the mesh each step and computed whole, its
gradient whole on every rank.  The gradients are all-reduced over
``pod``/``data`` as they come (gloo has no reduce-scatter), then cut to
the rank's moment slab.  Two whole-leaf quantities stay whole-leaf: the
global norm sums the slab leaves' squares over ``model``, and int8
compression takes each slab leaf's scale from its largest value over
``model``.  MoE capacity is counted over the whole batch
(``models.moe.moe_apply_tp``).  ``step.comm`` holds the last step's
bytes: ``param_gather_bytes`` (the params all-gathered, whole),
``model_reduce_bytes`` and ``model_gather_bytes`` (activations and
their gradients all-reduced and all-gathered over ``model``).

A sharded state checkpoints through ``Trainer``: whole leaves gathered
over the mesh, written once by rank 0 in the reference's layout, then a
barrier; a restore onto any mesh cuts each rank's slab from the whole
leaves (``checkpoint.restore_checkpoint(placements=)``).  On a one-rank
mesh every gather, cut and reduction is the identity, and the step is the
unsharded step bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
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
from repro_torch.optim.optimizers import _leaves, _map
from repro_torch.parallel.sharding import (
    cut_slab,
    gather_tensor,
    mesh_axis_sizes,
    shard_tensor,
    shard_tree,
)
from repro_torch.parallel.tensor import slab_leaves, tensor_parallel_ctx
from repro_torch.runtime.fault import FailureInjector, StragglerDetector

__all__ = ["TrainConfig", "TrainShardings", "train_shardings",
           "state_placements", "cross_entropy", "make_train_step",
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


def _mean_over_data(mesh, loss, grads):
    """The loss and the gradient averaged over the ranks that hold other
    rows of the batch (``pod`` and ``data``); ranks of one data shard
    reduce identical values in the same order, so they stay equal."""
    sizes = mesh_axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if sizes.get(a, 1) > 1]
    n = math.prod(sizes[a] for a in axes)
    if n == 1:
        return loss, grads
    loss = loss.clone()
    for t in [loss, *_leaves(grads)]:
        for a in axes:
            dist.all_reduce(t, group=mesh.get_group(a))
    return loss / n, _map(lambda g: g / n, grads)


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, vocab: int
) -> torch.Tensor:
    """Mean CE in float32; the padding columns (``>= vocab``) are set to
    -1e30 before the log-softmax, so they carry no probability.  Each
    row's label log-probability is picked by a mask and a sum (exact: one
    term is nonzero), so the backward scatters nothing and is
    deterministic on the card."""
    lf = logits.float()
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
):
    """Returns step(state, batch) -> (state, metrics).

    state = {params, opt_state, step, [comp_state]}.
    batch = {'tokens': [B, S+1], ...extra model inputs}, tensors on the
    params' device.  ``model_kwargs_fn(batch)`` gives ``apply_model``'s
    extra inputs (whisper's ``frames``, a VLM's ``prefix_embeds``).
    With ``shardings``, the state is the sharded one of
    :func:`init_train_state` and the batch this rank's rows (module
    docstring).
    """

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        kwargs = model_kwargs_fn(batch) if model_kwargs_fn else {}
        logits, _, aux = apply_model(params, statics, inputs, kernels=False,
                                     **kwargs)
        if logits.shape[1] != labels.shape[1]:  # vlm prefix: score suffix
            logits = logits[:, -labels.shape[1]:]
        loss = cross_entropy(logits, labels, cfg.vocab)
        if "mtp_logits" in aux:
            mtp_labels = torch.roll(labels, -1, dims=1)
            loss = loss + tcfg.mtp_weight * cross_entropy(
                aux["mtp_logits"][:, : mtp_labels.shape[1]], mtp_labels,
                cfg.vocab,
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

    def loss_and_grads(params, batch):
        nmb = tcfg.microbatches
        if nmb > 1:
            b = batch["tokens"].shape[0]
            per = b // nmb
            loss, grads = 0.0, None
            for j in range(nmb):
                mbatch = {k: v[j * per:(j + 1) * per] for k, v in batch.items()}
                l_j, g_j = value_and_grad(params, mbatch)
                loss = loss + l_j
                grads = g_j if grads is None else _map(torch.add, grads, g_j)
            loss = loss / nmb
            grads = _map(lambda g: g / nmb, grads)
        else:
            loss, grads = value_and_grad(params, batch)
        return loss, grads

    sharded = shardings is not None
    mesh = shardings.mesh if sharded else None
    n_model = mesh_axis_sizes(mesh).get("model", 1) if sharded else 1
    # leaves computed on their slabs (parallel.tensor); gathered otherwise
    slab = (slab_leaves(cfg, statics, shardings.params, n_model) if sharded
            else None)
    if sharded:
        _check_slabs(shardings.params, slab)

    def whole(tree, count: bool = False):
        """A params-shaped tree with every leaf that is not computed on
        its slab whole: gathered over the mesh if sharded."""
        if not sharded:
            return tree

        def one(t, pl, on_slab):
            if on_slab or pl.whole:
                return t
            out = gather_tensor(t, pl, mesh)
            if count:
                step.comm["param_gather_bytes"] += (out.numel()
                                                    * out.element_size())
            return out

        return _map(one, tree, shardings.params, slab)

    def over_model(tree, op):
        """A hook of ``global_norm`` / ``compress_gradients``: their
        per-leaf values of ``tree``'s leaves, each slab leaf's reduced by
        ``op`` over ``model`` in one all-reduce; None when no leaf is a
        slab."""
        flags = _leaves(_map(lambda _, s: s, tree, slab)) if sharded else []
        at = [i for i, s in enumerate(flags) if s]
        if not at:
            return None

        def reduce(vals):
            t = torch.stack([vals[i] for i in at])
            dist.all_reduce(t, op=op, group=mesh.get_group("model"))
            vals = list(vals)
            for j, i in enumerate(at):
                vals[i] = t[j]
            return vals

        return reduce

    def to_moments(tree):
        """A params-shaped tree (slab leaves on their slabs, the rest
        whole) cut to this rank's ZeRO-1 moment slabs."""
        return _map(lambda t, pl, z, on_slab: cut_slab(t, pl, z) if on_slab
                    else shard_tensor(t, z), tree, shardings.params,
                    shardings.moments, slab)

    def update(grads, opt_state, params, lr):
        """The optimizer's update; sharded, on this rank's moment slabs
        (ZeRO-1), the new params then gathered over ``data`` back to the
        rank's param slabs."""
        if not sharded:
            return opt.update(grads, opt_state, params, lr)
        z = shardings.moments
        slabs, new_opt = opt.update(to_moments(grads), opt_state,
                                    to_moments(params), lr)
        return _map(lambda t, pl: gather_tensor(t, pl, mesh, ("data",)),
                    slabs, z), new_opt

    def step(state, batch):
        step.comm = dict.fromkeys(step.comm, 0)
        params = whole(state["params"], count=True)
        if sharded and mesh.size() > 1:
            with tensor_parallel_ctx(mesh) as tp:
                loss, grads = loss_and_grads(params, batch)
            step.comm["model_reduce_bytes"] = tp.reduce_bytes
            step.comm["model_gather_bytes"] = tp.gather_bytes
            loss, grads = _mean_over_data(mesh, loss, grads)
        else:
            loss, grads = loss_and_grads(params, batch)
        grads, gnorm = clip_by_global_norm(
            grads, tcfg.grad_clip, over_model(grads, dist.ReduceOp.SUM))
        if tcfg.grad_compression:
            comp, new_comp_state = compress_gradients(
                grads, whole(state["comp_state"]),
                over_model(grads, dist.ReduceOp.MAX))
            grads = decompress_gradients(comp)
            if sharded:
                new_comp_state = _map(
                    lambda t, pl, on_slab: t if on_slab else shard_tensor(
                        t, pl), new_comp_state, shardings.params, slab)
        lr = lr_fn(state["step"])
        new_params, new_opt = update(grads, state["opt_state"], params, lr)
        new_state = {
            "params": new_params,
            "opt_state": new_opt,
            "step": state["step"] + 1,
        }
        if tcfg.grad_compression:
            new_state["comp_state"] = new_comp_state
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_state, metrics

    step.comm = dict.fromkeys(("param_gather_bytes", "model_reduce_bytes",
                               "model_gather_bytes"), 0)
    return step


def _check_slabs(placements, slab) -> None:
    """Every leaf computed on its slab is split over ``model`` alone, as
    ``parallel.tensor``'s rules and ``launch.steps.param_shardings``
    both derive it from the specs."""
    def one(pl, on_slab):
        if on_slab and (pl.whole or any(
                e not in (None, "model") for e in pl.pspec)):
            raise ValueError(f"a leaf computed on its model slab is placed "
                             f"as {pl.pspec} over {pl.shape}")
        return None

    _map(one, placements, slab)


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
