"""Bytes and least times of the int8 spmm calls, from the pruned weights'
nonzeros.

The operations are ``counts.layer_counts``'s (``2 * rows * nnz(W)``:
the precision does not change the work).  The bytes are the int8
kernel's: its input maps and weights are one byte an element, its output
maps float32, each counted once (the layer's feature maps, not its
im2col patches, as ``counts`` counts them):

  * bytes = 1 * (input maps + nnz(W)) + 4 * output maps

The least time of a call is the larger of its operations at the chip's
int8 tensor-core peak and its bytes at its memory bandwidth
(``peaks.json``).
"""

from __future__ import annotations

import dataclasses

from h100bench.counts import LayerCount, layer_counts

IN_BYTES = 1  # int8 input rows and weights
OUT_BYTES = 4  # float32 outputs

__all__ = ["layer_counts_i8", "least_seconds_i8"]


def layer_counts_i8(config: dict, nnz: dict[str, int],
                    batch: int) -> list[LayerCount]:
    """One :class:`~h100bench.counts.LayerCount` per spmm call of a
    forward over ``batch`` images (the convs in order, then the FC), with
    the int8 kernel's bytes."""
    c_in = [int(ci) for ci, _ in config["conv_channels"]]
    c_out = [int(co) for _, co in config["conv_channels"]]
    c_in.append(c_out[-1])
    c_out.append(int(config["num_classes"]))
    out = []
    for c, ci, co in zip(layer_counts(config, nnz, batch), c_in, c_out):
        maps_in, maps_out = c.rows * ci, c.rows * co
        out.append(dataclasses.replace(
            c, bytes=float(IN_BYTES * (maps_in + c.nnz)
                           + OUT_BYTES * maps_out)))
    return out


def least_seconds_i8(count: LayerCount, peaks: dict) -> float:
    """The least time the chip could take for one int8 call."""
    return max(count.ops / peaks["int8_ops_per_s"],
               count.bytes / peaks["hbm_bytes_per_s"])
