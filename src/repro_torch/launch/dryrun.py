"""Multi-pod dry run: plan every (arch x shape x mesh) cell on the host.

Port of ``src/repro/launch/dryrun.py``.  For each cell it

  * builds the production step (train / prefill / decode) with full
    production placements (``launch/steps.py``) over a fake mesh of 256
    or 512 ranks (``launch.mesh.make_fake_mesh``), this process its rank
    0, with fake tensors of rank 0's slabs as the arguments;
  * runs the step once inside their ``FakeTensorMode`` under
    ``launch.op_stats.OpStats``: nothing is allocated on any device and
    nothing is computed, so it runs on the host wherever it is started
    (the reference's runs on 512 host placeholders);
  * records rank 0's memory (its param, optimizer and cache slabs, and
    the peak of live bytes during the step, ``fits`` if that peak is at
    most the card's 80 GB), FLOPs and bytes, the collectives by kind and
    by mesh dim, three roofline terms and the dominant one,
    ``model_flops`` and ``useful_flops_ratio``;
  * writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__sparse]
    .json`` (existing cells are kept unless ``--force``).

A train step runs as the config says, with the reference's remat: its
FLOPs count the backward's recomputed forward and its peak is the
checkpointed one, as the reference's ``hlo_stats`` and memory analysis
of its compiled step count them; its gradients are reduce-scattered
over ``data`` (``runtime.train``), and it donates its state as the
reference's jitted step does, so its peak holds one state, not two.

The step takes the plain routes (``"routes": "plain"``): a hand-written
kernel cannot take a fake tensor, and its wrapper refuses one.  A cell
that fails is recorded with ``status: "error"`` and its traceback: it is
a bug to fix.  The reference's XLA fields become the port's own:
``trace_s`` for ``lower_s`` / ``compile_s``, ``memory`` for
``memory_analysis``; ``hlo_flops_per_device`` / ``hlo_bytes_per_device``
keep their names and hold ``op_stats``' counts of the dispatched ops.

The roofline terms are reckonings from the H100's published peaks, not
measurements (``ROOFLINE``):

  compute    = FLOPs / peak (989e12 bf16 dense, 67e12 float32)
  memory     = bytes / 3.35e12 (HBM3)
  collective = sum over mesh dims of that dim's bytes / its link rate:
               450e9 (NVLink, each way) where the dim's groups lie within
               one host's 8 consecutive ranks, else 50e9 (assumed: one
               400 Gb/s NDR port a card, as on a DGX H100)

A serving cell's step computes on rank 0's model slabs
(``runtime.serve``, ``"routes"``); ``step_comm`` holds the bytes it moved
by kind, ``serve_reckoned`` those ``parallel.tensor.serve_bytes``
reckons from the shapes.  ``--decode-strategy flash`` plans the decode
cells on the flash route (records tagged ``__flash``), as the reference's
``scripts/hillclimb.py`` plans qwen's ``decode_32k``.

Usage:
  python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--force] [--sparse]
      [--decode-strategy gather|flash] [--out DIR] [--list]
  python -m repro_torch.launch.dryrun --table [--out DIR] [--sparse]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch.configs import ARCH_NAMES, SHAPES, runnable, skip_reason
from repro_torch.launch.op_stats import COLLECTIVES, OpStats

__all__ = ["ROOFLINE", "roofline_terms", "measure", "record", "run_cell",
           "table", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__),
                       "../../../experiments/dryrun_torch")

# Per card.  Published figures for the H100 SXM5 80 GB HBM3 at 700 W, and
# one stated assumption for the links between hosts.
ROOFLINE = {
    "device": "H100 SXM5 80 GB HBM3, 700 W",
    "peak_flops": {"bfloat16": 989e12, "float16": 989e12,
                   "float32": 67e12},  # NVIDIA H100 datasheet, dense
    "hbm_bytes_per_s": 3.35e12,  # NVIDIA H100 datasheet, SXM5
    "hbm_bytes": 80e9,
    "nvlink_bytes_per_s": 450e9,  # NVLink 4: 900 GB/s a card, both ways
    "host_ranks": 8,  # cards a host (HGX / DGX H100)
    "inter_host_bytes_per_s": 50e9,  # assumed: one 400 Gb/s NDR port a card
    "source": "NVIDIA H100 Tensor Core GPU datasheet (SXM5); DGX H100 "
              "user guide (8 cards a host, 8 x 400 Gb/s ConnectX-7)",
}


def _dim_in_host(mesh, dim: str) -> bool:
    """Whether each group of ``dim`` lies within one host's
    ``host_ranks`` consecutive ranks (row-major mesh)."""
    names, shape = list(mesh.mesh_dim_names), [int(s) for s in mesh.shape]
    i = names.index(dim)
    stride = math.prod(shape[i + 1:])
    return stride * shape[i] <= ROOFLINE["host_ranks"]


def roofline_terms(flops: float, bytes_: float, coll_by_dim: dict, mesh,
                   dtype: str) -> dict:
    """Roofline terms in seconds from one rank's counts (``coll_by_dim``:
    ``"kind/dim"`` -> bytes; a group that is no mesh dim's counts as
    leaving the host)."""
    coll = 0.0
    for key, nbytes in coll_by_dim.items():
        dim = key.split("/", 1)[1]
        inside = dim in mesh.mesh_dim_names and _dim_in_host(mesh, dim)
        coll += nbytes / (ROOFLINE["nvlink_bytes_per_s"] if inside
                          else ROOFLINE["inter_host_bytes_per_s"])
    return {
        "compute_s": flops / ROOFLINE["peak_flops"][dtype],
        "memory_s": bytes_ / ROOFLINE["hbm_bytes_per_s"],
        "collective_s": coll,
    }


def _nbytes(tree) -> int:
    from repro_torch.models.transformer import _leaves

    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if hasattr(t, "element_size"))


def _resident(built) -> dict:
    """The bytes of rank 0's param, optimizer and cache slabs in
    ``built``'s arguments."""
    args = built.args
    if built.kind == "train":
        return {"param_bytes": _nbytes(args[0]["params"]),
                "opt_bytes": _nbytes(args[0]["opt_state"]), "cache_bytes": 0}
    return {"param_bytes": _nbytes(args[0]), "opt_bytes": 0,
            "cache_bytes": _nbytes(args[1])}


def measure(built, mesh) -> tuple:
    """Run ``built`` (a ``launch.steps.BuiltStep``) once in its fake mode
    under ``OpStats``; returns (the stats, the trace seconds).  The
    arguments' sizes are read first (``built.meta["resident"]``): a train
    step donates its state, which it leaves empty."""
    statics = built.meta.get("statics")
    built.meta["resident"] = _resident(built)
    with built.mode, OpStats().name_groups(mesh) as stats:
        stats.add_inputs(built.args, _static_tensors(statics))
        t0 = time.perf_counter()
        built.fn(*built.args)
        seconds = time.perf_counter() - t0
    return stats, seconds


def _static_tensors(statics) -> list:
    """The tensors the statics hold (sparse layouts' index tables)."""
    import torch

    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))

    walk(statics)
    return out


def record(built, mesh, spec, stats, seconds: float) -> dict:
    """The cell's record fields from one measured run (module
    docstring; ``built`` as :func:`measure` left it)."""
    from repro_torch.models.transformer import model_flops_per_token

    chips = math.prod(int(s) for s in mesh.shape)
    tokens = (spec.global_batch * spec.seq_len
              if spec.kind in ("train", "prefill") else spec.global_batch)
    # model_flops_per_token is 6N (train fwd+bwd); fwd-only steps = 2N
    mf = model_flops_per_token(built.cfg)
    model_flops = mf * tokens if spec.kind == "train" else mf / 3.0 * tokens
    coll = {k: {"count": int(stats.collective_counts.get(k, 0)),
                "bytes": float(stats.collective_bytes_by_kind.get(k, 0.0))}
            for k in COLLECTIVES}
    coll["total_bytes"] = stats.collective_bytes
    coll["total_count"] = int(sum(stats.collective_counts.values()))
    coll["by_dim"] = dict(stats.collective_bytes_by_dim)
    coll["while_trips"] = []  # Python loops dispatch every iteration
    mem = dict(built.meta["resident"])
    mem["peak_bytes"] = int(stats.peak_bytes)
    mem["fits"] = stats.peak_bytes <= ROOFLINE["hbm_bytes"]
    flops, bytes_ = stats.flops, stats.bytes
    rec = dict(
        status="ok", chips=chips, kind=built.kind,
        n_params=built.meta.get("n_params"), routes=built.meta["routes"],
        trace_s=round(seconds, 1), tokens=tokens,
        hlo_flops_per_device=flops, hlo_bytes_per_device=bytes_,
        collectives=coll, memory=mem, model_flops=model_flops,
        roofline=roofline_terms(flops, bytes_, coll["by_dim"], mesh,
                                built.cfg.compute_dtype),
        roofline_device=ROOFLINE["device"],
        roofline_source=ROOFLINE["source"])
    rec["step_comm"] = dict(built.fn.comm)
    if built.kind != "train":
        rec["serve_reckoned"] = _serve_reckoned(built, mesh, spec)
    terms = rec["roofline"]
    rec["dominant_term"] = max(terms, key=terms.get)
    rec["useful_flops_ratio"] = (model_flops / (flops * chips) if flops
                                 else None)
    return rec


def _serve_reckoned(built, mesh, spec) -> dict:
    """``parallel.tensor.serve_bytes`` for rank 0 of a serving cell."""
    import torch

    from repro_torch.parallel.sharding import mesh_axis_sizes
    from repro_torch.parallel.tensor import (
        data_shards,
        serve_bytes,
        serve_pods,
        serve_rows,
    )

    cfg, statics = built.cfg, built.meta["statics"]
    blocks = serve_rows(mesh, spec.global_batch)[1]
    return serve_bytes(
        cfg, statics, mesh_axis_sizes(mesh).get("model", 1),
        spec.global_batch // blocks, spec.seq_len, spec.kind, spec.seq_len,
        torch.bfloat16, pos=spec.seq_len - 1, blocks=blocks,
        placements=built.meta["placements"]["params"],
        pods=serve_pods(mesh, spec.global_batch),
        cache_placements=built.meta["placements"]["cache"],
        dp=data_shards(mesh)[1])


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False, sparse: bool = False,
             decode_strategy: str | None = None) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    tag = (f"{arch}__{shape}__{mesh_name}" + ("__sparse" if sparse else "")
           + (f"__{decode_strategy}" if decode_strategy else ""))
    path = os.path.join(out_dir, f"{tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                 "sparse": sparse, "status": "skip"}
    if decode_strategy:
        rec["decode_strategy"] = decode_strategy
    reason = skip_reason(arch, shape)
    if reason:
        rec["skip_reason"] = reason
        _write(path, rec)
        return rec

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step, cell_config

    try:
        mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
        cfg = cell_config(arch, SHAPES[shape], sparse)
        if decode_strategy:
            cfg = dataclasses.replace(cfg, decode_strategy=decode_strategy)
        built = build_step(arch, shape, mesh, cfg=cfg)
        stats, seconds = measure(built, mesh)
        rec.update(record(built, mesh, SHAPES[shape], stats, seconds))
    except Exception as e:  # record failures — they are bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _write(path, rec)
    return rec


def _write(path: str, rec: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


_TERM = {"compute_s": "c", "memory_s": "m", "collective_s": "x"}


def table(out_dir: str, sparse: bool = False) -> str:
    """The grid of the records in ``out_dir`` as a markdown table: per
    arch and shape, single / multi pod: rank 0's peak (GB, ``fits`` or
    not), the dominant roofline term (c, m, x) and
    ``useful_flops_ratio``."""
    rows = ["| arch | " + " | ".join(SHAPES) + " |",
            "| --- |" + " --- |" * len(SHAPES)]
    for a in ARCH_NAMES:
        cells = []
        for s in SHAPES:
            recs = []
            for m in ("single", "multi"):
                tag = f"{a}__{s}__{m}" + ("__sparse" if sparse else "")
                path = os.path.join(out_dir, f"{tag}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        recs.append(json.load(f))
            if not recs:
                cells.append("not run")
            elif all(r["status"] == "skip" for r in recs):
                cells.append("skip")
            elif any(r["status"] != "ok" for r in recs):
                cells.append("/".join(r["status"] for r in recs))
            else:
                peak = "/".join(
                    f"{r['memory']['peak_bytes'] / 1e9:.1f}"
                    + ("" if r["memory"]["fits"] else "✗") for r in recs)
                dom = "/".join(_TERM[r["dominant_term"]] for r in recs)
                ratio = "/".join(f"{r['useful_flops_ratio']:.2f}"
                                 for r in recs)
                cells.append(f"{peak} GB; {dom}; {ratio}")
        rows.append(f"| {a} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="enable the paper's block-pattern sparse MLPs")
    ap.add_argument("--out", default=None)
    ap.add_argument("--decode-strategy", default=None,
                    choices=["gather", "flash"],
                    help="replace the configs' (the grid keeps theirs); "
                         "the records are tagged with it")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the grid of the records in --out")
    args = ap.parse_args(argv)

    out_dir = args.out or os.path.abspath(OUT_DIR)
    if args.table:
        print(table(out_dir, args.sparse))
        return 0
    archs = [args.arch] if args.arch else ARCH_NAMES
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.list:
        for a in archs:
            for s in shapes:
                print(a, s, "runnable" if runnable(a, s) else "SKIP")
        return 0

    results = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_cell(a, s, mp, out_dir, force=args.force,
                               sparse=args.sparse,
                               decode_strategy=args.decode_strategy)
                dt = time.time() - t0
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (
                        f"dom={rec['dominant_term']} "
                        f"c={r['compute_s']:.2e} m={r['memory_s']:.2e} "
                        f"x={r['collective_s']:.2e} "
                        f"peak={rec['memory']['peak_bytes'] / 1e9:.1f}GB"
                    )
                elif status == "error":
                    extra = rec["error"][:120]
                print(
                    f"[{status:5}] {a:22} {s:12} "
                    f"{'multi' if mp else 'single':6} {dt:7.1f}s {extra}",
                    flush=True,
                )
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    print(f"done: {n_ok} ok, {n_skip} skip, {n_err} error")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
