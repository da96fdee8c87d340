"""Batched serving (port of ``repro.serving``)."""

from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
