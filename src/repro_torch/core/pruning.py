"""ADMM-based pattern pruning (paper §III-A, following ref [11]).

Port of ``repro/core/pruning.py``.  Pipeline (the paper's flowchart,
Fig 3):

  1. train a dense network,
  2. irregular (magnitude) pruning to the target sparsity + finetune,
  3. compute the pattern PDF per layer, select top-K candidates,
  4. ADMM phase: minimise  loss(W) + (rho/2)||W - Z + U||^2  with
       Z = project_to_patterns(W + U),  U <- U + W - Z
     re-projecting Z every ``admm_every`` steps,
  5. hard projection onto the dictionary + masked retraining
     (gradients masked so pruned positions stay zero).

Params are ``{name: {'w': ..., 'b': ...}}`` dicts of tensors; conv
weights use layout [C_out, C_in, Kh, Kw].  :func:`magnitude_prune`,
:func:`build_dictionaries`, :func:`project_params` and
:func:`sparsity_of` are host numpy over ``core/patterns.py``, copied
from the reference, so they give its results exactly; the weights they
return are tensors on the params' device.  :func:`admm_pattern_prune`
trains with torch autograd (``torch.autograd.grad``) where the reference
uses ``jax.value_and_grad``: the caller's ``loss_fn`` runs the dense
``models/cnn.cnn_apply`` (``F.conv2d``), never the CUDA spmm, which has
no autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import patterns as P
from repro_torch.device import host_array
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["PruneConfig", "PruneResult", "magnitude_prune", "build_dictionaries",
           "admm_pattern_prune", "project_params", "sparsity_of"]


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    target_sparsity: float = 0.75
    num_patterns: int = 6  # nonzero patterns per layer
    rho: float = 1e-2
    admm_steps: int = 300
    admm_every: int = 20
    retrain_steps: int = 300
    metric: str = "magnitude"


def _like(arr: np.ndarray, ref) -> torch.Tensor:
    """``arr`` as a tensor where (and of the type) ``ref`` is; a numpy
    ``ref`` means the CPU."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(arr, dtype=ref.dtype, device=ref.device)
    return torch.as_tensor(arr)


@dataclasses.dataclass
class PruneResult:
    params: dict
    dictionaries: dict[str, P.PatternDict]
    pattern_bits: dict[str, np.ndarray]

    def layer_sparsity(self, name: str) -> float:
        w = host_array(self.params[name]["w"])
        return 1.0 - float((np.abs(w) > 0).mean())


def sparsity_of(params: dict, conv_names: list[str]) -> float:
    nnz = tot = 0
    for n in conv_names:
        w = host_array(params[n]["w"])
        nnz += int((np.abs(w) > 0).sum())
        tot += w.size
    return 1.0 - nnz / tot


def magnitude_prune(params: dict, conv_names: list[str], sparsity: float) -> dict:
    """Irregular magnitude pruning, global threshold across conv layers."""
    mags = np.concatenate(
        [np.abs(host_array(params[n]["w"])).ravel() for n in conv_names]
    )
    thresh = np.quantile(mags, sparsity)
    out = dict(params)
    for n in conv_names:
        layer = dict(out[n])
        w = host_array(layer["w"])
        layer["w"] = _like(np.where(np.abs(w) > thresh, w, 0.0), layer["w"])
        out[n] = layer
    return out


def build_dictionaries(
    params: dict, conv_names: list[str], num_patterns: int
) -> dict[str, P.PatternDict]:
    """Per-layer top-K pattern dictionaries from the PDF of observed masks."""
    out = {}
    for n in conv_names:
        w = host_array(params[n]["w"])
        k = w.shape[-1] * w.shape[-2]
        bits = P.masks_to_bits(P.kernel_masks(w))
        pdf = P.pattern_pdf(bits)
        out[n] = P.select_candidates(pdf, num_patterns, k)
    return out


def project_params(
    params: dict,
    dictionaries: dict[str, P.PatternDict],
    metric: str = "magnitude",
) -> tuple[dict, dict[str, np.ndarray]]:
    """Hard-project every conv layer onto its dictionary."""
    out = dict(params)
    bits_out = {}
    for n, pdict in dictionaries.items():
        layer = dict(out[n])
        w = host_array(layer["w"])
        proj, bits = P.project_to_patterns(w, pdict, metric=metric)
        layer["w"] = _like(proj, layer["w"])
        out[n] = layer
        bits_out[n] = bits
    return out, bits_out


def _masks_from_bits(bits: np.ndarray, k: int, ref: torch.Tensor) -> torch.Tensor:
    m = ((bits[..., None] >> np.arange(k)) & 1).astype(np.float32)
    return torch.as_tensor(m.reshape(ref.shape), device=ref.device)


def _leaves(tree: dict) -> list[tuple[str, str]]:
    return [(n, key) for n, layer in tree.items() for key in layer]


def _grad(fn, params: dict, *args) -> dict:
    """``fn(params, *args)``'s gradient with respect to every tensor of
    ``params`` (a ``{name: {key: tensor}}`` dict), as the same dict."""
    keys = _leaves(params)
    live = {n: dict(layer) for n, layer in params.items()}
    for n, key in keys:
        live[n][key] = params[n][key].detach().requires_grad_(True)
    with torch.enable_grad():
        loss = fn(live, *args)
        grads = torch.autograd.grad(loss, [live[n][key] for n, key in keys])
    out: dict = {n: {} for n in params}
    for (n, key), g in zip(keys, grads):
        out[n][key] = g
    return out


def admm_pattern_prune(
    params: dict,
    conv_names: list[str],
    loss_fn: Callable[[dict, torch.Tensor, torch.Tensor], torch.Tensor],
    data_iter,
    cfg: PruneConfig,
    opt,
    lr: float = 3e-3,
    seed: int = 0,
    tracer: Tracer | None = None,
) -> PruneResult:
    """Full pattern-pruning pipeline on an already-trained network.

    Args:
      params: trained parameter dict (``{name: {'w':..., 'b':...}}``) of
        float32 tensors, all on one device.
      conv_names: layers to pattern-prune.
      loss_fn: (params, x, y) -> scalar loss tensor, differentiable in
        every tensor of ``params`` (the dense ``cnn_apply``).
      data_iter: iterator of (x, y) batches ``loss_fn`` accepts.
      cfg: pruning configuration.
      opt: ``repro_torch.optim.Optimizer``.
      seed: kept for the reference's signature; neither package draws
        from it.
      tracer: records one ``prune``-category span per stage
        (``magnitude_prune``, ``dictionaries``, ``admm``, ``project``,
        ``retrain``) on the host's clock.  The device work of the last
        retrain steps may outlast its span: a caller timing it on a GPU
        synchronizes after the call.

    Every step differentiates the loss with respect to all params (the
    biases and the FC head too), as the reference's ``value_and_grad``
    does, and the optimizer updates all of them.
    """
    tracer = tracer or NULL_TRACER
    # 1) irregular pruning
    with tracer.span("magnitude_prune", cat="prune"):
        params = magnitude_prune(params, conv_names, cfg.target_sparsity)
    # 2) candidate dictionaries from the pattern PDF
    with tracer.span("dictionaries", cat="prune"):
        dictionaries = build_dictionaries(params, conv_names,
                                          cfg.num_patterns)

    # 3) ADMM phase
    rho = cfg.rho

    def admm_loss(p, x, y, z, u):
        base = loss_fn(p, x, y)
        reg = sum(
            0.5 * rho * torch.sum((p[n]["w"] - z[n]["w"] + u[n]) ** 2)
            for n in conv_names
        )
        return base + reg

    with tracer.span("admm", cat="prune", steps=cfg.admm_steps):
        Z, _ = project_params(params, dictionaries, cfg.metric)
        U = {n: torch.zeros_like(params[n]["w"]) for n in conv_names}
        opt_state = opt.init(params)
        for step in range(cfg.admm_steps):
            x, y = next(data_iter)
            g = _grad(admm_loss, params, x, y, Z, U)
            params, opt_state = opt.update(g, opt_state, params, lr)
            if (step + 1) % cfg.admm_every == 0:
                # Z-update: project W+U ; U-update: dual ascent
                WU = {
                    n: {"w": params[n]["w"] + U[n], "b": params[n]["b"]}
                    for n in conv_names
                }
                Z, _ = project_params(WU, dictionaries, cfg.metric)
                U = {n: U[n] + params[n]["w"] - Z[n]["w"]
                     for n in conv_names}

    # 4) hard projection + masked retrain
    with tracer.span("project", cat="prune"):
        params, bits = project_params(params, dictionaries, cfg.metric)
        masks = {
            n: _masks_from_bits(bits[n], dictionaries[n].k, params[n]["w"])
            for n in conv_names
        }

    with tracer.span("retrain", cat="prune", steps=cfg.retrain_steps):
        opt_state = opt.init(params)
        for _ in range(cfg.retrain_steps):
            x, y = next(data_iter)
            g = _grad(loss_fn, params, x, y)
            for n in conv_names:
                g[n]["w"] = g[n]["w"] * masks[n]
            params, opt_state = opt.update(g, opt_state, params, lr)
        # re-assert exact zeros (optimizer weight decay can perturb)
        for n in conv_names:
            layer = dict(params[n])
            layer["w"] = layer["w"] * masks[n]
            params = {**params, n: layer}

    return PruneResult(params=params, dictionaries=dictionaries,
                       pattern_bits=bits)
