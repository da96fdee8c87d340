"""Launchers of the port (counterpart of ``repro.launch``): the engine's
launch path (:mod:`~repro_torch.launch.offload_runtime`), the meshes
(:mod:`~repro_torch.launch.mesh`), the step builders
(:mod:`~repro_torch.launch.steps`), and the training and serving launchers
(:mod:`~repro_torch.launch.train`, :mod:`~repro_torch.launch.serve`)."""

from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh, production_topology
from repro_torch.launch.offload_runtime import build_offload_engine, get_engine

__all__ = ["build_offload_engine", "get_engine", "make_production_mesh",
           "make_smoke_mesh", "production_topology"]
