"""glue_i8_device_ms.bulk (ms, device trace): device time a step of
every kernel, copy and memset that is not the int8 spmm's walk or its
split reduction: the activations' quantization (abs, amax, scale,
round, clamp, cast), the row-scale multiply, the patch rows, the inverse
permutation's gather, bias, channel_norm, ReLU, pooling, the input's
upload and the logits' readback, over the profiled stretch.  Moves
images_per_s."""

from h100bench.registry import metric_reader

_spmm = metric_reader("spmm_i8_roofline")


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.steps <= 0:
        return None
    glue_s, _ = tr.seconds_where(lambda n: not _spmm.is_spmm(n))
    return glue_s / tr.steps * 1e3
