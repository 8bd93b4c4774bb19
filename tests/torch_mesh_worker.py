"""One rank of a ``gloo`` process group for ``tests/test_torch_sharded.py``
(and ``tests/test_torch_fault_data.py``'s ``data`` job,
``tests/test_torch_sharded_train.py``'s ``train`` and ``restore`` jobs,
``tests/test_torch_pipeline.py``'s ``pipeline`` job,
``tests/test_torch_tensor_parallel.py``'s ``tp_mlp`` and ``tp_train``
jobs).

    python tests/torch_mesh_worker.py <spec.pkl> <rank>

The parent test writes a spec (the world size, a file-store path, the
jobs and their numpy inputs) and starts one process per rank.  Each rank
joins the group, runs every job through the port's public entry points
on CPU meshes (``make_mesh(..., device_type="cpu")``), and writes its
results to ``<out>.<rank>``.  It imports ``torch`` and ``repro_torch``
only: the JAX references are computed in the parent and compared there.
"""

from __future__ import annotations

import datetime
import math
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def cnn_job(job: dict) -> dict:
    """The mini programs on one mesh: forwards, stats, int8, the service,
    ``execute`` and an explicit partition."""
    from repro_torch.engine import (
        InferenceService,
        execute,
        load_program,
        make_forward,
        partition_network,
    )
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(job["mesh"], ("data", "model"), device_type="cpu")
    prog = load_program(job["fp32"], verify=False, device="cpu")
    prog8 = load_program(job["int8"], verify=False, device="cpu")
    out = {}
    x = job["x"]
    out["logits"] = _np(make_forward(prog, mesh=mesh)(x))
    logits, stats = make_forward(prog, mesh=mesh, collect_stats=True)(
        job["x_stats"], job["valid"])
    out["stats_logits"] = _np(logits)
    out["stats"] = {k: (st.counts, st.windows)
                    for k, st in stats.layers.items()}
    out["int8"] = _np(make_forward(prog8, mesh=mesh)(job["x_int8"]))
    data, model = job["mesh"]
    part = partition_network(prog, data=data, model=model)
    out["partitioned"] = _np(execute(part, x, mesh=mesh))
    calls = []
    real = ops.pattern_spmm_raw

    def counting(xm, *args, **kwargs):
        calls.append(tuple(xm.shape))
        return real(xm, *args, **kwargs)

    # the executor's own reference, so every spmm of a served batch shows
    import repro_torch.engine.executor as ex
    ex.pattern_spmm_raw = counting
    try:
        svc = InferenceService(prog, batch_slots=job["batch_slots"],
                               mesh=mesh, collect_stats=True)
        out["service_labels"] = svc.classify(job["images"])
    finally:
        ex.pattern_spmm_raw = real
    out["service_stats"] = {k: (st.counts, st.windows)
                            for k, st in svc.activation_stats.layers.items()}
    out["service_trace_count"] = svc.trace_count()
    out["spmm_rows"] = calls
    return out


def flash_job(job: dict) -> dict:
    """Prefill, then teacher-forced decode steps at one shared position
    under ``activation_sharding_ctx(mesh)``: the logits of every step."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.models.transformer import (
        apply_model,
        init_cache,
        init_statics,
    )
    from repro_torch.parallel.activations import activation_sharding_ctx
    from repro_torch.runtime.serve import ServeConfig, decode_logits, \
        make_decode_step

    mesh = make_mesh(job["mesh"], ("data", "model"), device_type="cpu")
    cfg = job["cfg"]
    params = lm_params_from_numpy(job["params"], "cpu")
    statics = init_statics(cfg, "cpu")
    prompts = torch.as_tensor(job["prompts"])
    b, n = prompts.shape
    cache = init_cache(statics, b, job["max_seq"], dtype=torch.float32)
    apply_model(params, statics, prompts, positions=torch.arange(n),
                cache=cache, cache_pos=0, cache_len=n)
    calls0 = attention.flash_decode_sharded.calls
    steps = []
    with activation_sharding_ctx(mesh):
        for i, tok in enumerate(job["teacher"]):
            logits, cache = decode_logits(
                statics, params, cache, torch.as_tensor(tok),
                torch.tensor(n + i))
            steps.append(_np(logits))
        # the serving step reaches the same route and samples greedily
        decode = make_decode_step(cfg, statics, ServeConfig())
        tok, _ = decode(params, cache, torch.as_tensor(job["teacher"][-1]),
                        torch.tensor(n + len(job["teacher"]) - 1))
    return {"logits": np.stack(steps), "greedy": _np(tok),
            "flash_calls": attention.flash_decode_sharded.calls - calls0}


def moe_job(job: dict) -> dict:
    """``moe_apply`` under ``activation_sharding_ctx(mesh)`` (expert
    parallel over ``model``, rows over ``data``) on each case's input:
    the outputs and the expert-parallel route's calls."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.parallel.activations import activation_sharding_ctx

    mesh = make_mesh(job["mesh"], ("data", "model"), device_type="cpu")
    params = lm_params_from_numpy(job["params"], "cpu")
    out = {}
    calls0 = moe._moe_sharded.calls
    with activation_sharding_ctx(mesh):
        for name, cfg, x in job["cases"]:
            static = moe.moe_static(cfg, "cpu")
            out[name] = _np(moe.moe_apply(params, static, cfg,
                                          torch.as_tensor(x)))
    out["sharded_calls"] = moe._moe_sharded.calls - calls0
    return out


def data_job(job: dict) -> dict:
    """``shard_batch`` of one host batch on a (data, model) mesh, and
    ``error_feedback_allreduce`` of this rank's own gradients (row
    ``rank`` of each case) over the world."""
    from repro_torch.data import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import (
        error_feedback_allreduce,
        init_compression_state,
    )

    mesh = make_mesh(job["mesh"], ("data", "model"), device_type="cpu")
    rank = dist.get_rank()
    rows = shard_batch(job["batch"], mesh)
    grads = {k: torch.as_tensor(v[rank]) for k, v in job["grads"].items()}
    reduced, state = error_feedback_allreduce(
        grads, init_compression_state(grads))
    return {"rows": {k: _np(v) for k, v in rows.items()},
            "reduced": {k: _np(v) for k, v in reduced.items()},
            "residual": {k: _np(v) for k, v in state.items()}}


def _whole_state(state, shardings) -> dict | None:
    """The sharded training state gathered whole (every rank takes part),
    as numpy by checkpoint key on rank 0, ``None`` elsewhere."""
    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.parallel.sharding import gather_tensor
    from repro_torch.runtime.train import state_placements

    placed = dict(_leaf_paths(state_placements(shardings, state)))
    out = {}
    for key, leaf in _leaf_paths(state):
        if key in placed:
            leaf = gather_tensor(leaf, placed[key], shardings.mesh)
        out[key] = _np(leaf)
    return out if dist.get_rank() == 0 else None


def _train_setup(job: dict):
    """(mesh, cfg, statics, whole params, shardings, opt, tcfg) of a
    ``train`` or ``restore`` job."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.models.transformer import init_specs, init_statics
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import TrainConfig, train_shardings

    mesh = make_mesh(job["mesh"], ("data", "model"), device_type="cpu")
    cfg = job["cfg"]
    params = lm_params_from_numpy(job["params"], "cpu")
    shardings = train_shardings(init_specs(cfg), params, mesh)
    tcfg = TrainConfig(steps=len(job.get("batches", ())) or 1,
                       ckpt_every=1, ckpt_dir=job.get("ckpt_dir"),
                       **job.get("tcfg", {}))
    return (mesh, cfg, init_statics(cfg, "cpu"), params, shardings,
            adamw(weight_decay=0.0), tcfg)


def train_job(job: dict) -> dict:
    """The sharded train step through ``Trainer`` (a checkpoint after
    every step when ``job["save"]``) on this rank's rows of each batch:
    the metrics, this rank's slab shapes and coordinates, and the state
    gathered whole (rank 0)."""
    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.data import shard_batch
    from repro_torch.runtime.train import (
        Trainer,
        init_train_state,
        make_train_step,
    )

    mesh, cfg, statics, params, shardings, opt, tcfg = _train_setup(job)
    lr = job["lr"]
    step = make_train_step(cfg, statics, opt, lambda s: lr, tcfg,
                           shardings=shardings)
    state = init_train_state(params, opt, tcfg, shardings=shardings)
    slabs = {k: tuple(t.shape) for k, t in _leaf_paths(state)}
    if job["save"]:
        trainer = Trainer(step, state, iter(job["batches"]), tcfg,
                          put_batch=lambda b: shard_batch(b, mesh),
                          shardings=shardings)
        hist = trainer.run()
        metrics = [{k: h[k] for k in ("loss", "grad_norm")} for h in hist]
        state = trainer.state
    else:
        metrics = []
        for batch in job["batches"]:
            state, m = step(state, shard_batch(batch, mesh))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return {"metrics": metrics, "slabs": slabs,
            "coords": {a: mesh.get_local_rank(a) for a in ("data", "model")},
            "state": _whole_state(state, shardings)}


def restore_job(job: dict) -> dict:
    """A fresh sharded state on this job's mesh restored through
    ``Trainer.maybe_restore`` from the checkpoints in ``job["ckpt_dir"]``:
    the step restored, this rank's slab shapes and the state gathered
    whole (rank 0)."""
    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.runtime.train import (
        Trainer,
        init_train_state,
        make_train_step,
    )

    mesh, cfg, statics, params, shardings, opt, tcfg = _train_setup(job)
    step = make_train_step(cfg, statics, opt, lambda s: 0.0, tcfg,
                           shardings=shardings)
    trainer = Trainer(step, init_train_state(params, opt, tcfg,
                                             shardings=shardings),
                      iter(()), tcfg, shardings=shardings)
    at = trainer.maybe_restore()
    return {"restored_step": at,
            "coords": {a: mesh.get_local_rank(a) for a in ("data", "model")},
            "slabs": {k: tuple(t.shape)
                      for k, t in _leaf_paths(trainer.state)},
            "state": _whole_state(trainer.state, shardings)}


def tp_mlp_job(job: dict) -> dict:
    """``layers.mlp_apply_tp`` on this rank's slab of each MLP of
    ``job["cases"]`` (whole numpy params) inside ``tensor_parallel_ctx``:
    the output, the input's gradient and the slab's gradients under the
    upstream gradient ``dy``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import mlp_apply_tp, mlp_specs, mlp_static
    from repro_torch.optim.optimizers import _map
    from repro_torch.parallel.sharding import shard_tree, tree_shardings
    from repro_torch.parallel.tensor import tensor_parallel_ctx

    mesh = make_mesh(job["mesh"], ("data", "model"), device_type="cpu")
    out = {}
    for name, (d, ff, act, sparse, shards), params, x, dy in job["cases"]:
        static = mlp_static(d, ff, act, sparse, shards, device="cpu")
        whole = _map(torch.as_tensor, params)
        slabs = shard_tree(whole, tree_shardings(
            mlp_specs(d, ff, act, sparse, shards), whole, mesh))
        live = _map(lambda t: t.detach().clone().requires_grad_(True), slabs)
        xt = torch.as_tensor(x).requires_grad_(True)
        with tensor_parallel_ctx(mesh) as tp:
            y = mlp_apply_tp(tp, live, static, xt, kernels=False)
            (y * torch.as_tensor(dy)).sum().backward()
        out[name] = {"y": _np(y), "dx": _np(xt.grad),
                     "grads": _map(lambda t: _np(t.grad), live),
                     "reduce_bytes": tp.reduce_bytes,
                     "gather_bytes": tp.gather_bytes}
    return out


def tp_train_job(job: dict) -> dict:
    """The sharded step with tensor-parallel compute, ``job["steps"]``
    steps of each case of ``job["cases"]`` (a port config, whole numpy
    params, a batch, a ``TrainConfig``'s fields): per step the metrics,
    the bytes the step moved (``step.comm``), the params gathered whole
    (rank 0) and the placements the step all-gathered over the mesh,
    against the leaves ``parallel.tensor.slab_leaves`` keeps on their
    slabs."""
    from repro_torch.checkpoint.checkpointer import _leaf_paths
    from repro_torch.data import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.models.transformer import init_specs, init_statics
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import _leaves
    from repro_torch.parallel.sharding import gather_tree, mesh_axis_sizes
    from repro_torch.parallel.tensor import slab_leaves
    from repro_torch.runtime import train as rt

    mesh = make_mesh(job["mesh"], ("data", "model"), device_type="cpu")
    n_model = mesh_axis_sizes(mesh)["model"]
    real = rt.gather_tensor
    gathered: list = []

    def spy(t, pl, mesh, axes=None):
        if axes is None:
            gathered.append(id(pl))
        return real(t, pl, mesh, axes)

    out = {}
    for name, cfg, nparams, batch, tkw in job["cases"]:
        params = lm_params_from_numpy(nparams, "cpu")
        statics = init_statics(cfg, "cpu")
        shardings = rt.train_shardings(init_specs(cfg), params, mesh)
        tcfg = rt.TrainConfig(steps=job["steps"], **tkw)
        opt = adamw(weight_decay=0.0)
        step = rt.make_train_step(
            cfg, statics, opt, lambda s: job["lr"], tcfg,
            model_kwargs_fn=lambda b: {k: b[k] for k in ("frames",)
                                       if k in b},
            shardings=shardings)
        state = rt.init_train_state(params, opt, tcfg, shardings)
        del params
        slab = slab_leaves(cfg, statics, shardings.params, n_model)
        pls, flags = _leaves(shardings.params), _leaves(slab)
        size = torch.empty((), dtype=cfg.pdtype()).element_size()
        rows = []
        for _ in range(job["steps"]):
            gathered.clear()
            rt.gather_tensor = spy
            try:
                state, m = step(state, shard_batch(batch, mesh))
            finally:
                rt.gather_tensor = real
            got = gather_tree(state["params"], shardings.params, mesh)
            rows.append({
                "metrics": {k: float(m[k]) for k in ("loss", "grad_norm")},
                "comm": dict(step.comm), "gathered": list(gathered),
                "params": ({k: _np(v) for k, v in _leaf_paths(got)}
                           if dist.get_rank() == 0 else None)})
        out[name] = {
            "steps": rows,
            "slab_ids": [id(pl) for pl, s in zip(pls, flags) if s],
            "gathered_ids": [id(pl) for pl, s in zip(pls, flags)
                             if not s and not pl.whole],
            "gathered_bytes": size * sum(
                math.prod(pl.shape) for pl, s in zip(pls, flags)
                if not s and not pl.whole),
            "slab_leaves": sum(flags)}
    return out


def pipeline_job(job: dict) -> dict:
    """``pipeline_apply`` of ``tanh(x @ w)`` over a ``stage`` mesh of the
    whole world, for each case ``(ws, x)``; a case whose layers do not
    split over the stages records the error."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh((dist.get_world_size(),), ("stage",),
                     device_type="cpu")
    out = {}
    for name, ws, x in job["cases"]:
        try:
            y = pipeline_apply(lambda w, h: torch.tanh(h @ w),
                               torch.as_tensor(ws), torch.as_tensor(x),
                               mesh, "stage")
            out[name] = _np(y)
        except ValueError as e:
            out[name] = str(e)
    return out


JOBS = {"cnn": cnn_job, "flash": flash_job, "moe": moe_job, "data": data_job,
        "train": train_job, "restore": restore_job,
        "pipeline": pipeline_job, "tp_mlp": tp_mlp_job,
        "tp_train": tp_train_job}


def main(spec_path: str, rank: int) -> None:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], spec["world"]),
        rank=rank, world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        out = {job["name"]: JOBS[job["kind"]](job) for job in spec["jobs"]}
    finally:
        dist.destroy_process_group()
    with open(f"{spec['out']}.{rank}", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
