"""Runtime fault handling of the PyTorch port (counterpart of
``repro.runtime``): message-level chaos injection, failure injection and
re-mesh planning, and step-time straggler detection.

The reference's ``__init__`` also exports its trainer (``train_loop``),
which the port does not have yet; only the ported modules are exported.
"""

from repro_torch.runtime.fault import (
    FailureInjector,
    SimulatedFailure,
    plan_remesh,
    rescale_batch,
)
from repro_torch.runtime.straggler import StragglerDetector

__all__ = [
    "FailureInjector",
    "SimulatedFailure",
    "StragglerDetector",
    "plan_remesh",
    "rescale_batch",
]
