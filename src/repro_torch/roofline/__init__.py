"""Roofline of the port (counterpart of ``repro.roofline``): an op-level
count of a PyTorch step (:mod:`~repro_torch.roofline.op_cost`, in place of
the reference's HLO parser) and its analysis against the card's data-sheet
peaks (:mod:`~repro_torch.roofline.analysis`)."""

from repro_torch.roofline import op_cost  # submodule (keep name unshadowed)
from repro_torch.roofline.analysis import Roofline, analyze_step, model_flops

__all__ = ["Roofline", "analyze_step", "model_flops", "op_cost"]
