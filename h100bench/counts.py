"""Operations and bytes that a pattern-pruned network's inputs need.

Counted from the pruned weights' nonzeros, never from the program's
stored bricks: a brick holds zeros that a smarter kernel or packing need
not touch, so a count of bricks is the most a kernel could do, not what
the layer needs.  Per spmm call (one conv or the FC over ``rows``):

  * ops   = 2 * rows * nnz(W)
  * bytes = 4 * (input activations + nnz(W) + output), each counted
            once: the layer's feature maps, not its im2col patches, so a
            kernel that fuses the gather is counted the same

The least time of a call is the larger of ops at the chip's fp32 peak and
bytes at its memory bandwidth (``peaks.json``, keyed by the name
``torch.cuda.get_device_name()`` gives).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from h100bench.synth import layer_specs

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
ELEM_BYTES = 4  # float32 activations and weights

__all__ = ["LayerCount", "layer_counts", "image_flops", "least_seconds",
           "peaks_for", "nnz_of"]


@dataclasses.dataclass(frozen=True)
class LayerCount:
    name: str
    rows: int  # rows of the spmm call: windows for a conv, images for the FC
    nnz: int  # nonzero weights of the pruned layer
    ops: float
    bytes: float


def nnz_of(params: dict) -> dict[str, int]:
    """``{layer: nonzero weights}`` of ``{layer: {w, b}}`` (tensors or
    arrays); biases are not spmm operands and are not counted."""
    out = {}
    for name, p in params.items():
        w = p["w"]
        out[name] = int((w != 0).sum())
    return out


def layer_counts(config: dict, nnz: dict[str, int],
                 batch: int) -> list[LayerCount]:
    """One :class:`LayerCount` per spmm call of a forward over ``batch``
    images: the convs in order, then the FC."""
    specs = layer_specs(config["conv_channels"], config["pool_after"],
                        config["input_hw"])
    out = []
    for s in specs:
        rows = batch * s.out_hw * s.out_hw
        n = nnz[s.name]
        act = rows * (s.c_in + s.c_out)
        out.append(LayerCount(s.name, rows, n, 2.0 * rows * n,
                              float(ELEM_BYTES * (act + n))))
    d_in = int(config["conv_channels"][-1][1])
    classes = int(config["num_classes"])
    n = nnz["fc"]
    out.append(LayerCount("fc", batch, n, 2.0 * batch * n,
                          float(ELEM_BYTES * (batch * (d_in + classes) + n))))
    return out


def image_flops(config: dict, nnz: dict[str, int]) -> float:
    """Useful operations of one image's forward: the spmm calls' ops."""
    return sum(c.ops for c in layer_counts(config, nnz, 1))


def peaks_for(device_kind: str) -> dict | None:
    """The published peaks of ``device_kind``, or ``None`` when the table
    has no entry for it."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    return table.get(device_kind)


def least_seconds(count: LayerCount, peaks: dict) -> float:
    """The least time the chip could take for one call, in fp32."""
    return max(count.ops / peaks["fp32_flops_per_s"],
               count.bytes / peaks["hbm_bytes_per_s"])

