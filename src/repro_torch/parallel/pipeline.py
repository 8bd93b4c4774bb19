"""GPipe-style pipeline parallelism over a homogeneous layer stack.

Port of ``src/repro/parallel/pipeline.py``, SPMD over one dim of a
``DeviceMesh``: every rank of the ``stage`` dim calls
:func:`pipeline_apply` with the same arguments.  Stage ``s`` of ``n``
keeps the contiguous layers ``[s * L / n, (s + 1) * L / n)`` of the
stacked params; microbatches flow from stage to stage by point-to-point
send and receive (``dist.batch_isend_irecv``, the reference's
``collective_permute``); the schedule runs ``n_micro + n_stages - 1``
ticks (GPipe's fill/drain bubble, which the caller amortises by choosing
``n_micro >> n_stages``).  At tick ``t`` stage 0 takes microbatch ``t``
(the last one again once the stream is spent, as the reference's
clipped index), every other stage the buffer its predecessor sent, and
the last stage records its result for microbatch ``t - (n - 1)``; at the
end it broadcasts the outputs, so every rank returns them (the
reference's ``psum`` of the last stage's outputs and the others' zeros).

Forward only, as the reference is exercised.  Under the ``gloo`` backend
a CUDA buffer crosses through host memory (gloo moves host buffers
point to point).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import mesh_axis_sizes

__all__ = ["pipeline_apply"]


def _layer(tree, i):
    """Layer ``i`` of a stacked param tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layer(v, i) for v in tree]
    return tree[i]


def _stack_len(tree) -> int:
    if isinstance(tree, dict):
        return _stack_len(next(iter(tree.values())))
    if isinstance(tree, list):
        return _stack_len(tree[0])
    return tree.shape[0]


def _shift(out: torch.Tensor, buf: torch.Tensor, stage: int, n_stages: int,
           group) -> None:
    """Send ``out`` to the next stage and receive the previous stage's
    into ``buf`` (the first stage receives nothing, the last sends
    nothing)."""
    staged = out.is_cuda and "gloo" in str(dist.get_backend(group))
    send = out.cpu() if staged else out.contiguous()
    recv = torch.empty_like(send)
    ops = []
    if stage + 1 < n_stages:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, stage + 1), group))
    if stage > 0:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, stage - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if stage > 0:
        buf.copy_(recv)


@torch.no_grad()
def pipeline_apply(layer_fn, stacked_params, x_micro: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``layer_fn`` over a stage-sharded layer stack.

    Args:
      layer_fn: (params_slice, x) -> x, applied per layer.
      stacked_params: tree (dicts and lists) of tensors with a leading
        layer dim L; this rank keeps its stage's L / n_stages layers.
      x_micro: microbatched inputs [n_micro, B_micro, ...]; n_micro >= 1.
      mesh: a ``DeviceMesh`` with a dim named ``axis``.
      axis: the pipeline dim.

    Returns the [n_micro, B_micro, ...] outputs after all L layers, on
    every rank.  Raises ``ValueError`` when n_stages does not divide L.
    """
    n_stages = mesh_axis_sizes(mesh)[axis]
    n_micro = x_micro.shape[0]
    n_layers = _stack_len(stacked_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over {n_stages} "
                         f"pipeline stages")
    per = n_layers // n_stages
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    local = [_layer(stacked_params, i)
             for i in range(stage * per, (stage + 1) * per)]
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        y = x_micro[min(t, n_micro - 1)] if stage == 0 else buf
        for p in local:
            y = layer_fn(p, y)
        slot = t - (n_stages - 1)
        if stage == n_stages - 1 and slot >= 0:
            outs[slot] = y
        _shift(y, buf, stage, n_stages, group)
    dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return outs
