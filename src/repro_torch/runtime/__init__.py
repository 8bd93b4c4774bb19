"""Token generation (``serve``), training (``train``) and its fault
tolerance (``fault``)."""

from repro_torch.runtime.fault import (  # noqa: F401
    FailureInjector,
    HeartbeatMonitor,
    RestartPolicy,
    SimulatedFailure,
    StragglerDetector,
)
from repro_torch.runtime.train import (  # noqa: F401
    TrainConfig,
    Trainer,
    TrainShardings,
    cross_entropy,
    init_train_state,
    make_train_step,
    state_placements,
    train_shardings,
)
