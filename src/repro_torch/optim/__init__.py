"""Functional optimizers for the port (``optim/optimizers.py``)."""

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
