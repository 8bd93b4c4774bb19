"""Functional optimizers (``optim/optimizers.py``) and int8 gradient
compression with error feedback (``optim/compression.py``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    lion,
    linear_warmup_cosine,
    sgd,
)
from repro_torch.optim.compression import (  # noqa: F401
    CompressionState,
    compress_gradients,
    decompress_gradients,
    error_feedback_allreduce,
    init_compression_state,
)
