"""Architecture and shape registry (port of ``repro.configs``)."""

from repro_torch.configs.base import (  # noqa: F401
    ARCH_NAMES,
    PORTED,
    SHAPES,
    ShapeSpec,
    get_config,
    get_smoke_config,
    input_specs,
    runnable,
    skip_reason,
)
