"""Quickstart of the PyTorch port (twin of ``examples/quickstart.py``):
the paper's pipeline on one layer.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. synthesize a pattern-pruned conv layer (Table-II-like statistics),
2. map it onto 512x512 RRAM crossbars with the kernel-reordering scheme,
3. price area / energy / cycles vs the naive mapping (paper Figs 7-8),
4. show the same idea at tensor-core granularity: block-pattern SpMM.

Steps 1-3 are the port's copy of the reference's host numpy, so they
print the reference's numbers.  Step 4 runs ``kernels.ops.pattern_spmm``
on ``--device``: ``cuda`` by default (the hand-written Hopper kernel
``kernels/csrc/pattern_spmm.cu``; raising without a card), ``cpu`` when
asked (its plain version).
"""

import argparse

import numpy as np
import torch

from repro_torch.core.indexing import build_index_stream, index_overhead_bits
from repro_torch.core.mapping import map_layer, map_layer_naive
from repro_torch.core.simulator import simulate_layer
from repro_torch.core.sparse import block_density, build_block_pattern
from repro_torch.core.synthetic import LayerSpec, synthesize_layer
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import pattern_spmm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else "cpu")
    rng = np.random.default_rng(0)

    # -- 1. a pattern-pruned layer: 128 -> 256 channels, 3x3 kernels ------
    spec = LayerSpec("demo", c_in=128, c_out=256, out_hw=16)
    layer = synthesize_layer(
        spec, n_patterns=6, zero_ratio=0.4, target_sparsity=0.85, rng=rng
    )
    print(f"layer: {spec.c_in}->{spec.c_out}, "
          f"{layer.pdict.num_nonzero_patterns} nonzero patterns, "
          f"{(layer.weights == 0).mean():.1%} sparse")

    # -- 2. kernel-reordering mapping -------------------------------------
    mapping = map_layer(layer.pattern_bits)
    naive = map_layer_naive(spec.c_out, spec.c_in)
    print(f"crossbars: ours={mapping.num_crossbars}  "
          f"naive={naive.num_crossbars}"
          f"  (area efficiency "
          f"{naive.num_crossbars/mapping.num_crossbars:.2f}x,"
          f" utilization {mapping.utilization:.0%})")

    idx = index_overhead_bits(build_index_stream(mapping))
    print(f"index overhead: {idx['total_bits']/8/1024:.1f} KB "
          f"({idx['bits_per_kernel_index']} bits/kernel)")

    # -- 3. energy / cycles -------------------------------------------------
    res = simulate_layer(layer, zero_ind=None)
    print(f"energy: {res.naive_energy_pj/res.ours_energy_pj:.2f}x  "
          f"speedup: {res.naive_cycles/max(res.ours_cycles,1):.2f}x "
          f"(without input-sparsity skips; the full benchmark adds them)")

    # -- 4. the GPU form: block-pattern SpMM --------------------------------
    w = rng.normal(size=(1024, 1024)).astype(np.float32)
    bp = build_block_pattern(w, num_patterns=8, density=0.25, device=dev)
    x = torch.as_tensor(rng.normal(size=(8, 1024)).astype(np.float32),
                        device=dev)
    y = pattern_spmm(x, bp)
    print(f"pattern_spmm: block density {block_density(bp):.2f} -> "
          f"{1/block_density(bp):.1f}x fewer FLOPs/weight-bytes, "
          f"output {tuple(y.shape)} on {dev.type}")
    return {"x": x, "bp": bp, "y": y}


if __name__ == "__main__":
    main()
