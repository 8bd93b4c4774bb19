"""End-to-end reproduction in miniature on the PyTorch port: train ->
pattern-prune -> map -> simulate -> compile -> serve (the paper's
flowchart, Fig 3, plus the deployment path).  The twin of
``examples/pattern_prune_cnn.py`` through ``repro_torch``.

  PYTHONPATH=src python examples/pattern_prune_cnn_torch.py \\
      [--device {cuda,cpu}] [--precision {int8,fp32}] [--cell-bits N] \\
      [--trace-out trace.json]

  # step 7 sharded over N ranks (gloo lets ranks share one card):
  PYTHONPATH=src torchrun --nproc-per-node N \\
      examples/pattern_prune_cnn_torch.py [--backend gloo]

Steps:
  1. train a small CNN on a synthetic 4-class task to ~100% accuracy,
  2. ADMM pattern pruning (irregular prune -> pattern PDF -> top-K
     dictionary -> ADMM -> hard projection -> masked retrain),
  3. map the pruned kernels with the kernel-reordering scheme,
  4. report the paper's three metrics on this network,
  5. compile the pruned network into an executable crossbar program and
     serve a batch of requests through the classification service — then
     recompile with ``optimize='auto'`` (the per-layer mapping search),
  6.-7. measured-vs-assumed energy pricing, sharded execution over a
     ``DeviceMesh``: a one-rank mesh in this process, or every rank of a
     ``torchrun`` launch (each runs this script on the same data),
  8. cell precision: recompile the same pruned network quantized.

``--device`` is where everything runs (default ``cuda``: the Hopper
kernels; ``cpu``: their plain PyTorch versions).  Under ``torchrun``
every rank runs the whole script with the same seeds and only rank 0
prints.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.mapping import map_layer, map_layer_naive
from repro_torch.core.pruning import PruneConfig, admm_pattern_prune, sparsity_of
from repro_torch.engine import (
    CompileOptions,
    InferenceService,
    compile_network,
    load_program,
    make_forward,
    partition_network,
    save_program,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.cnn import (
    cnn_apply,
    conv_weight_names,
    init_cnn,
    mini_cnn_config,
)
from repro_torch.optim import adamw

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
ap.add_argument("--precision", choices=["int8", "fp32"], default="int8",
                help="stored cell precision for the step-8 quantized "
                     "compile (fp32 skips it)")
ap.add_argument("--cell-bits", type=int, default=4,
                help="RRAM cell width the int8 weights are sliced over "
                     "for hardware pricing")
ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                help="process-group backend under torchrun (default: nccl "
                     "on cuda when every rank has a card, else gloo)")
ap.add_argument("--trace-out", default=None, metavar="FILE",
                help="write a Chrome trace-event JSON of compile/serve "
                     "spans (open in Perfetto or chrome://tracing)")
args = ap.parse_args()
world = int(os.environ.get("WORLD_SIZE", "1"))
if world > 1:  # launched by torchrun: join its group before any mesh
    backend = args.backend or (
        "nccl" if args.device == "cuda"
        and int(os.environ.get("LOCAL_WORLD_SIZE", world))
        <= torch.cuda.device_count() else "gloo")
    dist.init_process_group(backend)
rank0 = not dist.is_initialized() or dist.get_rank() == 0
log = print if rank0 else (lambda *a, **k: None)
if args.device == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device: pass --device cpu")
if args.device == "cuda" and world > 1:
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                          % torch.cuda.device_count())
dev = torch.device(args.device, torch.cuda.current_device()) \
    if args.device == "cuda" else torch.device("cpu")
if args.trace_out:
    from repro_torch.obs.trace import Tracer

    tracer = Tracer()
else:
    tracer = None
# build the quantized-compile config up front so bad flags fail in
# milliseconds, not after the training/pruning pipeline has run
if args.precision != "fp32":
    quant_opts = CompileOptions(precision=args.precision,
                                cell_bits=args.cell_bits)

t0 = time.time()
cfg = mini_cnn_config(num_classes=4, input_hw=12, widths=(8, 16, 16))
protos = torch.randn((4, 1, 12, 12), generator=torch.Generator().manual_seed(42))


def gen_batch(gen, n=64):
    y = torch.randint(0, 4, (n,), generator=gen)
    x = protos[y] + 0.7 * torch.randn((n, 1, 12, 12), generator=gen)
    return x.to(dev), y.to(dev)


def loss_fn(p, x, y):
    return F.cross_entropy(cnn_apply(cfg, p, x), y)


def accuracy(p):
    gen = torch.Generator().manual_seed(999)
    accs = []
    with torch.no_grad():
        for _ in range(8):
            x, y = gen_batch(gen, 256)
            accs.append(float((cnn_apply(cfg, p, x).argmax(-1) == y)
                              .float().mean()))
    return float(np.mean(accs))


def grads(p, x, y):
    """The loss's gradient with respect to every tensor of ``p``."""
    live = {n: {k: t.detach().requires_grad_(True) for k, t in layer.items()}
            for n, layer in p.items()}
    flat = [t for layer in live.values() for t in layer.values()]
    g = iter(torch.autograd.grad(loss_fn(live, x, y), flat))
    return {n: {k: next(g) for k in layer} for n, layer in live.items()}


# -- 1. dense training ------------------------------------------------------
params = init_cnn(cfg, torch.Generator().manual_seed(0), device=dev)
opt = adamw(weight_decay=0.0)
state = opt.init(params)
train_gen = torch.Generator().manual_seed(1)
for _ in range(400):
    params, state = opt.update(grads(params, *gen_batch(train_gen)), state,
                               params, 3e-3)
acc_dense = accuracy(params)
log(f"[{time.time()-t0:5.1f}s] dense accuracy: {acc_dense:.3f}")

# -- 2. ADMM pattern pruning -------------------------------------------------
names = conv_weight_names(cfg)


def data_iter():
    gen = torch.Generator().manual_seed(7)
    while True:
        yield gen_batch(gen)


pcfg = PruneConfig(target_sparsity=0.7, num_patterns=4, admm_steps=200,
                   retrain_steps=200)
res = admm_pattern_prune(params, names, loss_fn, data_iter(), pcfg, opt)
acc_pruned = accuracy(res.params)
log(f"[{time.time()-t0:5.1f}s] pattern-pruned accuracy: {acc_pruned:.3f} "
    f"(drop {acc_dense-acc_pruned:+.3f}), "
    f"sparsity {sparsity_of(res.params, names):.1%}")
for n in names:
    d = res.dictionaries[n]
    log(f"  {n}: {d.num_nonzero_patterns} nonzero patterns, "
        f"layer sparsity {res.layer_sparsity(n):.1%}")

# -- 3./4. mapping + metrics --------------------------------------------------
tot_ours = tot_naive = 0
for n in names:
    bits = res.pattern_bits[n]
    tot_ours += map_layer(bits).num_crossbars
    tot_naive += map_layer_naive(bits.shape[0], bits.shape[1]).num_crossbars
log(f"crossbars: ours={tot_ours} naive={tot_naive} "
    f"-> area efficiency {tot_naive/max(tot_ours,1):.2f}x")

# -- 5. compile into an executable crossbar program + serve ------------------
program = compile_network(cfg, res.params, res.pattern_bits,
                          options=CompileOptions(tracer=tracer), device=dev)
with tempfile.TemporaryDirectory() as td:  # pay compilation once per model
    program = load_program(save_program(td + "/prog", program), device=dev)
x, y = gen_batch(torch.Generator().manual_seed(123), 64)
with torch.no_grad():
    logits_ref = cnn_apply(cfg, res.params, x)
logits_eng = make_forward(program, device=dev)(x)
diff = float((logits_eng - logits_ref).abs().max())
rep = program.hardware_report()
log(f"[{time.time()-t0:5.1f}s] compiled program "
    f"(max |engine - dense| = {diff:.2e}):")
for op, detail in program.op_list():
    log(f"  {op}: {detail}")
log(f"  hardware: {rep['crossbars']} crossbars "
    f"(naive {rep['naive_crossbars']}), "
    f"energy {rep['energy_pj']/1e3:.1f} nJ/img, "
    f"index {rep['index_kb']:.2f} KiB")

# -- 5b. mapping design-space search ------------------------------------------
program_opt = compile_network(
    cfg, res.params, res.pattern_bits,
    options=CompileOptions(optimize="auto", tracer=tracer), device=dev,
)
rep_opt = program_opt.hardware_report()
logits_opt = make_forward(program_opt, device=dev)(x)
if not torch.equal(logits_opt, logits_eng):
    raise SystemExit("the searched layout changed the logits")
log(f"[{time.time()-t0:5.1f}s] optimize='auto' mapping search:")
for name, m_entry in rep_opt["mapping"]["per_layer"].items():
    log(f"  {name}: {m_entry['rows']}x{m_entry['cols']} crossbars, "
        f"block_order={m_entry['block_order']}, "
        f"reorder={m_entry['reorder']}")
log(f"  area {rep_opt['area_cells']} cells vs fixed {rep['area_cells']} "
    f"({rep['area_cells']/max(rep_opt['area_cells'],1):.1f}x win), "
    f"energy {rep_opt['energy_pj']/1e3:.1f} nJ/img "
    f"(fixed {rep['energy_pj']/1e3:.1f}), logits bit-identical")

service = InferenceService(program, batch_slots=16, collect_stats=True,
                           tracer=tracer, device=dev)
labels = service.classify(x.cpu().numpy())
acc_served = float((labels == y.cpu().numpy()).mean())
m = service.metrics
log(f"[{time.time()-t0:5.1f}s] served {len(labels)} requests in "
    f"{service.batches_run} batches, accuracy {acc_served:.3f}")
log(f"  scheduler: 1 batch shape ({service.trace_count()} signature), "
    f"occupancy {m['occupancy_mean']:.0%}, "
    f"mean latency {m['latency_mean_s']*1e3:.1f} ms")

# -- 6. measured vs assumed energy --------------------------------------------
rep_m = service.hardware_report(assumed_skip=0.5)
skip = rep_m["skip"]
log(f"energy pricing over {skip['measured_windows']} measured windows:")
log(f"  no-skip upper bound : {skip['energy_pj_noskip']/1e3:8.1f} nJ/img")
log(f"  assumed skip (p=0.5): {skip['energy_pj_assumed']/1e3:8.1f} nJ/img")
log(f"  measured skip       : {skip['energy_pj_measured']/1e3:8.1f} nJ/img "
    f"({skip['measured_discount']:.1%} below no-skip)")
log(f"  measured - assumed  : "
    f"{skip['measured_vs_assumed_delta_pj']/1e3:+8.1f} nJ/img "
    f"({skip['measured_vs_assumed_delta_frac']:+.1%})")
for lrow in rep_m["layers"]:
    st = service.activation_stats.layers.get(lrow["name"])
    if st is None:
        continue
    log(f"  {lrow['name']}: mean measured skip {st.mean_skip():.2f}, "
        f"energy {lrow['energy_pj_measured']/1e3:.1f} nJ "
        f"(no-skip {lrow['energy_pj']/1e3:.1f} nJ)")

# -- 7. sharded execution across a device mesh -------------------------------
# One compiled artifact serves from several devices: each layer's spmm
# tiles split over the mesh's 'model' dim (partial outputs all-reduced)
# and batch slots over 'data'.  Every rank calls the same forward with
# the same batch and gets the whole result back; outputs match the
# unsharded forward.
mesh = make_mesh((1, world), ("data", "model"), device_type=dev.type)
sharded_prog = partition_network(program, model=world)
logits_sh = make_forward(sharded_prog, mesh=mesh)(x)
log(f"[{time.time()-t0:5.1f}s] sharded over {world} rank(s) "
    f"({dist.get_backend()}): max |sharded - unsharded| = "
    f"{float((logits_sh - logits_eng).abs().max()):.2e}")
chips = sharded_prog.hardware_report()["chips"]
log(f"  per-chip split ({chips['model_shards']} tile-parallel chip(s)): "
    f"max {chips['crossbars_per_chip_max']:.1f} crossbars/chip, "
    f"bottleneck {chips['cycles_parallel']:.0f} cycles "
    f"({chips['parallel_speedup']:.2f}x vs single chip)")

# -- 8. cell precision: int-quantized 4-bit-cell execution --------------------
if args.precision != "fp32":
    program_q = compile_network(cfg, res.params, res.pattern_bits,
                                options=quant_opts, device=dev)
    x_eval, y_eval = gen_batch(torch.Generator().manual_seed(321), 256)
    logits_fp = make_forward(program, device=dev)(x_eval)
    logits_q = make_forward(program_q, device=dev)(x_eval)
    top1_agree = float((logits_q.argmax(-1) == logits_fp.argmax(-1))
                       .float().mean())
    acc_q = float((logits_q.argmax(-1) == y_eval).float().mean())
    rep_q = program_q.hardware_report()
    prec = rep_q["precision"]
    cb_fp, _ = program.weight_bytes()
    cb_q, _ = program_q.weight_bytes()
    log(f"[{time.time()-t0:5.1f}s] cell precision "
        f"({prec['weights']}, {prec['cell_bits']}-bit cells, "
        f"{prec['cells_per_weight']} cells/weight):")
    log(f"  accuracy: max |int8 - fp32| = "
        f"{float((logits_q - logits_fp).abs().max()):.2e}, "
        f"top-1 agreement {top1_agree:.1%} (served accuracy {acc_q:.3f})")
    log(f"  area:     {rep_q['crossbars']} crossbars vs "
        f"{rep['crossbars']} fp32-priced "
        f"({rep['crossbars']/max(rep_q['crossbars'],1):.2f}x win), "
        f"weights {cb_q/1024:.1f} KiB vs {cb_fp/1024:.1f} KiB")
    log(f"  energy:   {rep_q['energy_pj']/1e3:.1f} nJ/img vs "
        f"{rep['energy_pj']/1e3:.1f} nJ/img no-skip "
        f"({rep['energy_pj']/max(rep_q['energy_pj'],1e-9):.2f}x win)")

# -- observability epilogue: where the time actually went --------------------
if tracer is not None:
    fwd_tr = make_forward(program, tracer=tracer, device=dev)
    fwd_tr(x)
    drift = program.hardware_report(observed=fwd_tr.observed_times())["drift"]
    log(f"[{time.time()-t0:5.1f}s] predicted-vs-measured drift over "
        f"{len(drift['layers'])} layers: "
        f"max |share drift| {drift['max_abs_share_drift']:.1%}, "
        f"rate spread {drift['rate_spread']:.1f}x")
    PHASES = ("prune", "reorder", "pack", "quantize")
    top_phases = [(n, s) for n, s in tracer.slowest(16, cat="compile")
                  if n in PHASES][:3]
    log("  top-3 compile phases: "
        + ", ".join(f"{n} {s*1e3:.1f} ms" for n, s in top_phases))
    top_layers = tracer.slowest(3, cat="execute", prefix="layer:")
    log("  top-3 layers:         "
        + ", ".join(f"{n.removeprefix('layer:')} {s*1e3:.1f} ms"
                    for n, s in top_layers))
    if rank0:
        tracer.write(args.trace_out)
    log(f"  wrote {args.trace_out} (open in Perfetto / chrome://tracing)")

dist.destroy_process_group()
