"""PyTorch/CUDA port of the offloaded MPI_Scan reproduction.

A second package beside the JAX reference (``repro``), mirroring its layout
module for module. It imports ``torch`` and numpy, never ``jax`` and never
the reference package; descriptor words, plans and results are held against
the reference by the ``tests/test_torch_*.py`` parity tests.

The main path: ``OffloadEngine().make_descriptor(...)`` -> ``offload(desc,
x)`` -> plan -> lowering registry -> the fused collective kernel
(``kernels/csrc/fused_collective.cu``) on an NVIDIA GPU.
"""

from repro_torch.core import (
    CollType,
    CollectiveDescriptor,
    WireDType,
    WireOp,
    get_operator,
    sim_scan,
)
from repro_torch.offload import OffloadEngine, build_plan, lower_sim

__all__ = [
    "CollType",
    "CollectiveDescriptor",
    "OffloadEngine",
    "WireDType",
    "WireOp",
    "build_plan",
    "get_operator",
    "lower_sim",
    "sim_scan",
]
