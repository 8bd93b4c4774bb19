"""mfu_i8 (%, host clock): the useful operations of every image the
window completed (each image's spmm calls counted from the pruned
weights' nonzeros, ``counts.image_flops``) over the window's seconds
times the chip's int8 tensor-core peak.  The whole int8 step's share of
the peak: it bounds every int8 kernel's roofline gain.  Moves
images_per_s."""

from h100bench import counts


def read(run):
    win = run.window
    if not run.peaks or win.seconds <= 0 or win.images == 0:
        return None
    ops = win.images * counts.image_flops(run.config, run.nnz)
    return 100.0 * ops / (win.seconds * run.peaks["int8_ops_per_s"])
