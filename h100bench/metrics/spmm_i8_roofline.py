"""spmm_i8_roofline (%, device trace): the int8 pattern spmm's share of
its roofline over the profiled stretch.

For each spmm call of a step (the convs, then the FC) the least time is
the larger of its operations at the int8 tensor-core peak and its bytes
at HBM bandwidth, both counted from the pruned weights' nonzeros
(``counts_i8.layer_counts_i8``: int8 input maps and weights, float32
output maps), over the fixed batch's rows.  The share is the stretch's
steps times the summed least time of a step's calls, over the summed
device time of the kernels named below.  The stretch must hold one
launch of the walk per call (else nothing is read).  Moves images_per_s.
"""

from h100bench import counts_i8

# the kernels that carry the int8 spmm: the split walk, and the
# fixed-order sum of its partials where a layer's plan splits it
SPMM_KERNELS = ("pattern_spmm_i8_kernel", "split_reduce_kernel")
WALK = SPMM_KERNELS[0]


def is_spmm(name: str) -> bool:
    return any(k in name for k in SPMM_KERNELS)


def read(run):
    tr = run.trace
    if tr is None or not run.peaks:
        return None
    device_s, _ = tr.seconds_where(is_spmm)
    _, walks = tr.seconds_where(lambda n: WALK in n)
    calls = counts_i8.layer_counts_i8(run.config, run.nnz, run.batch_slots)
    if device_s <= 0 or walks != tr.steps * len(calls):
        return None
    least = sum(counts_i8.least_seconds_i8(c, run.peaks) for c in calls)
    return 100.0 * tr.steps * least / device_s
