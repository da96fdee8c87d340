"""Runtime fault handling of the PyTorch port (counterpart of
``repro.runtime``): message-level chaos injection, failure injection and
re-mesh planning, step-time straggler detection, and the fault-tolerant
trainer (:class:`~repro_torch.runtime.train_loop.Trainer`).
"""

from repro_torch.runtime.fault import (
    FailureInjector,
    SimulatedFailure,
    plan_remesh,
    rescale_batch,
)
from repro_torch.runtime.straggler import StragglerDetector


def __getattr__(name):
    # the trainer imports the models and the step builders, which import
    # this package: load it on first use
    if name in ("Trainer", "TrainerConfig"):
        from repro_torch.runtime import train_loop

        return getattr(train_loop, name)
    raise AttributeError(name)

__all__ = [
    "FailureInjector",
    "SimulatedFailure",
    "StragglerDetector",
    "Trainer",
    "TrainerConfig",
    "plan_remesh",
    "rescale_batch",
]
