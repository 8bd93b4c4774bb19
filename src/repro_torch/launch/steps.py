"""Step builders and placements: the production steps of the dry run.

Port of ``src/repro/launch/steps.py``.  :func:`param_shardings` places
every parameter leaf by its logical spec under the default rules,
:func:`_zero1` splits the optimizer moments further over ``data``
(ZeRO-1), and :func:`cache_pspec` / :func:`cache_shardings` place the
serving caches by leaf name and rank: batch over ``data``, sequence over
``model``, which is what makes 32k/500k decode fit a card.  Placements
are ``parallel.sharding.Placement`` trees, this rank's share of each
leaf.

:func:`build_step` gives, for an (arch, shape, mesh) cell, the step a
rank runs and this rank's arguments: the sharded train step of
``runtime.train`` (ZeRO-1 moments, bfloat16 above
``_BF16_OPT_THRESHOLD`` params; the state donated) or the placed prefill / decode step of
``runtime.serve`` (params and caches held as the slabs above).  The
arguments are fake tensors (``torch._subclasses.fake_tensor``) of the
slabs' shapes, never whole leaves, in the mode :attr:`BuiltStep.mode`,
the counterpart of the reference's ``ShapeDtypeStruct``s with
shardings: running the step inside that mode over a fake mesh
(``launch.mesh.make_fake_mesh``) allocates nothing, and
``launch.op_stats`` counts what it does.  Since a hand-written kernel
cannot take a fake tensor, the step takes the plain routes
(``kernels=False``), and its record says so (``meta["routes"]``: a
serving step computes on the model slabs, its decode by the config's
``decode_strategy``; the cells keep the reference's, ``"gather"``).
A serving step's rows are its cache slabs', split over ``pod`` where
it divides them (``parallel.tensor.serve_rows``).
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config, input_specs
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    _map,
    _shape,
    logical_to_pspec,
    mesh_axis_sizes,
    placement,
    tree_shardings,
)

__all__ = ["BuiltStep", "build_step", "param_shardings", "cache_pspec",
           "cache_shardings"]

_BF16_OPT_THRESHOLD = 50e9  # params above this -> bf16 optimizer states


@dataclasses.dataclass
class BuiltStep:
    """A step ready to run: ``fn(*args)`` on this rank, ``args`` fake
    tensors of this rank's slabs belonging to ``mode`` (enter it around
    the call); ``meta`` names the cell and holds ``n_params``, the
    statics and the placements (``"placements"``)."""

    fn: Any
    args: tuple
    cfg: Any
    kind: str
    meta: dict
    mode: Any = None


def param_shardings(specs, shapes, mesh):
    """The :class:`~repro_torch.parallel.sharding.Placement` of every
    parameter: its logical spec resolved under ``DEFAULT_RULES``."""
    return tree_shardings(specs, shapes, mesh, DEFAULT_RULES)


def _zero1(p_shard, p_shapes, mesh):
    """ZeRO-1: shard optimizer moments over 'data' on the first dim that is
    currently unsharded and divisible — on top of the param sharding.
    The spec keeps a ``None`` for every dim before the one split, as the
    reference's ``P(*spec)`` does."""
    dsize = mesh_axis_sizes(mesh).get("data", 1)

    def one(pl, shape):
        shape = _shape(shape)
        spec = list(pl.pspec) + [None] * (len(shape) - len(pl.pspec))
        for i, (ax, dim) in enumerate(zip(spec, shape)):
            if ax is None and dim % dsize == 0 and dsize > 1:
                spec[i] = "data"
                return placement(tuple(spec), shape, mesh)
        return pl

    return _map(one, p_shard, p_shapes)


def cache_pspec(path: tuple, shape: tuple, mesh) -> tuple:
    """The partition spec of a cache leaf (a tuple, as
    ``logical_to_pspec`` gives), by its name and rank: ``path`` is the
    leaf's keys from the cache's root (list indices among them).

    batch -> 'data', sequence -> 'model' (sequence-sharded caches are what
    make 32k/500k decode fit HBM).  Non-divisible dims fall back to
    replication via logical_to_pspec.
    """
    name = [p for p in path if isinstance(p, str)]
    leaf = name[-1] if name else ""
    rank = len(shape)
    stacked = rank >= 1 and "body" in name  # leading n_periods dim

    def spec_for(core: tuple) -> tuple:
        return ((None,) + core) if stacked else core

    if leaf in ("k", "v"):
        core = ("data_only", "seq_shard", None, None)
    elif leaf in ("c_kv", "k_rope"):
        core = ("data_only", "seq_shard", None)
    elif leaf == "conv":
        core = ("data_only", None, "ff")
    elif leaf == "state":
        core = ("data_only", "heads", None, None)
    elif leaf == "memory":
        return logical_to_pspec(("data_only", None, None), shape, mesh)
    else:
        core = ("data_only",) + (None,) * (rank - (2 if stacked else 1))
    spec = spec_for(core)
    if len(spec) != rank:  # unexpected rank: replicate
        return ()
    return logical_to_pspec(spec, shape, mesh)


def _map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def cache_shardings(cache, mesh):
    """The :class:`~repro_torch.parallel.sharding.Placement` of every
    leaf of ``cache`` (tensors or shapes), by :func:`cache_pspec`."""
    return _map_path(lambda path, leaf: placement(
        cache_pspec(path, _shape(leaf), mesh), _shape(leaf), mesh), cache)


def _batch_pspec(mesh) -> tuple:
    """Batch rows over ``pod`` and ``data``, pod-major."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return (axes,)


def _dp_size(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


def _model_kwargs_fn(cfg):
    def fn(batch):
        kw = {}
        if "frames" in batch:
            kw["frames"] = batch["frames"]
        if "prefix_embeds" in batch:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        return kw

    return fn


def _slabs(placements, like):
    """Empty tensors of every placement's slab shape, in the dtype of the
    matching leaf of ``like``."""
    return _map(lambda pl, t: torch.empty(pl.slab_shape, dtype=t.dtype),
                placements, like)


def _rows(t: torch.Tensor, mesh, serve: bool = False) -> torch.Tensor:
    """Zeros of this rank's rows of a ``meta`` input: its batch split over
    ``pod``/``data`` where they divide it (``serve``: data-major, as
    ``parallel.tensor.serve_rows`` splits a serving step's), else
    whole."""
    from repro_torch.parallel.tensor import serve_rows

    shape = tuple(t.shape)
    if serve and shape:
        shape = (shape[0] // serve_rows(mesh, shape[0])[1], *shape[1:])
    elif shape and shape[0] % _dp_size(mesh) == 0:
        shape = placement(_batch_pspec(mesh), shape, mesh).slab_shape
    return torch.zeros(shape, dtype=t.dtype)


def cell_config(arch: str, spec: ShapeSpec, sparse: bool = False):
    """The (arch, shape) cell's config: the arch's at ``spec``, with the
    paper's block-pattern sparse MLPs where ``sparse``."""
    if sparse:
        return importlib.import_module(f"repro_torch.configs.{arch}").config(
            spec, sparse=True)
    return get_config(arch, spec)


def build_step(
    arch: str,
    shape: str | ShapeSpec,
    mesh,
    cfg=None,
    tcfg=None,
    sparse: bool = False,
    opt=None,
) -> BuiltStep:
    """The (arch, shape) cell's step on ``mesh`` (module docstring):
    ``train`` gives ``(fn, (state, batch))`` of the sharded train step,
    which donates ``state`` (as the reference's ``donate_argnums=(0,)``),
    ``prefill`` ``(fn, (params, cache, tokens, extras))`` and ``decode``
    ``(fn, (params, cache, tokens, pos))`` of the placed serving steps,
    with ``pos`` the cache's last position (the whole cache is read).
    ``opt`` replaces the reference's AdamW (bfloat16 moments above
    ``_BF16_OPT_THRESHOLD`` params); ``cfg`` the cell's config
    (:func:`cell_config`), as the reference's ``scripts/hillclimb.py``
    plans qwen's decode with ``decode_strategy="flash"``."""
    from repro_torch.launch.op_stats import fake_mode
    from repro_torch.models.transformer import (
        init_cache,
        init_params,
        init_specs,
        init_statics,
    )

    spec = SHAPES[shape] if isinstance(shape, str) else shape
    if cfg is None:
        cfg = cell_config(arch, spec, sparse)
    statics = init_statics(cfg, device="cpu")
    mode = fake_mode()
    with mode:
        # whole leaves' shapes only: fake tensors hold no memory
        p_shapes, _ = init_params(cfg, torch.Generator(), device="cpu")
    p_shard = param_shardings(init_specs(cfg), p_shapes, mesh)
    ins = input_specs(arch, spec, cfg)
    meta = {"arch": arch, "shape": spec.name, "cfg_name": cfg.name,
            "routes": "plain", "statics": statics}

    if spec.kind == "train":
        from repro_torch.optim import adamw, linear_warmup_cosine
        from repro_torch.optim.optimizers import _leaves
        from repro_torch.runtime.train import (
            TrainConfig,
            TrainShardings,
            make_train_step,
        )

        n_params = sum(t.numel() for t in _leaves(p_shapes))
        opt_dtype = (torch.bfloat16 if n_params > _BF16_OPT_THRESHOLD
                     else torch.float32)
        opt = opt or adamw(mu_dtype=opt_dtype)
        tcfg = tcfg or TrainConfig()
        shardings = TrainShardings(mesh, p_shard,
                                   _zero1(p_shard, p_shapes, mesh))
        step = make_train_step(cfg, statics, opt,
                               linear_warmup_cosine(3e-4, 100, 10000), tcfg,
                               _model_kwargs_fn(cfg), shardings=shardings,
                               donate=True)
        with mode:
            params = _slabs(p_shard, p_shapes)
            state = {"params": params,
                     "opt_state": opt.init(_slabs(shardings.moments,
                                                  p_shapes)),
                     "step": torch.tensor(0, dtype=torch.int32)}
            if tcfg.grad_compression:
                from repro_torch.optim import init_compression_state

                state["comp_state"] = init_compression_state(params)
            batch = {k: _rows(v, mesh) for k, v in ins.items()
                     if k != "pos"}
        meta.update(n_params=n_params, placements={
            "params": p_shard, "moments": shardings.moments})
        return BuiltStep(step, (state, batch), cfg, "train", meta, mode)

    from repro_torch.runtime.serve import (
        ServeConfig,
        ServeShardings,
        make_decode_step,
        make_prefill_step,
    )

    scfg = ServeConfig(max_seq=spec.seq_len, cache_dtype="bfloat16")
    with mode:
        cache_shapes = init_cache(statics, spec.global_batch, spec.seq_len,
                                  torch.bfloat16, device="cpu")
    c_shard = cache_shardings(cache_shapes, mesh)
    shardings = ServeShardings(mesh, p_shard, c_shard, spec.global_batch)
    meta["placements"] = {"params": p_shard, "cache": c_shard}
    meta["routes"] = ("plain, on the model slabs" + (
        "" if spec.kind == "prefill" else
        f", decode_strategy={cfg.decode_strategy}"))
    with mode:
        params = _slabs(p_shard, p_shapes)
        cache = _slabs(c_shard, cache_shapes)
        tokens = _rows(ins["tokens"], mesh, serve=True)
    if spec.kind == "prefill":
        fn = make_prefill_step(cfg, statics, scfg, shardings=shardings,
                               kernels=False)
        with mode:
            extras = {k: _rows(v, mesh, serve=True) for k, v in ins.items()
                      if k not in ("tokens", "pos")}
        return BuiltStep(fn, (params, cache, tokens, extras), cfg, "prefill",
                         meta, mode)
    fn = make_decode_step(cfg, statics, scfg, shardings=shardings,
                          kernels=False)
    with mode:
        pos = torch.tensor(spec.seq_len - 1, dtype=torch.int32)
    return BuiltStep(fn, (params, cache, tokens, pos), cfg, "decode", meta,
                     mode)
