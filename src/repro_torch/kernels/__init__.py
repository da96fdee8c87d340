"""Hand-written CUDA kernels of the PyTorch port (counterpart of
``repro.kernels``). Kernels build on first use (``_build``); importing this
package builds nothing.

The public entry points, as the reference exports them: ``prefix_scan``
(K3), ``ssd_scan`` (K4) and ``flash_attention`` (K5), from
:mod:`repro_torch.kernels.ops`. K1, the fused collective, is reached through
the offload engine (:mod:`repro_torch.kernels.fused_collective`), and K2, its
per-rank form, through the engine's spmd and driver modes
(:mod:`repro_torch.kernels.spmd_collective`). K6, the chunked SSD's chunk
output, has no counterpart in the reference: the Mamba2 mixer reaches it
through ``ops.ssd_chunk_out`` (:mod:`repro_torch.kernels.ssd_chunk`)."""

from repro_torch.kernels.ops import flash_attention, prefix_scan, ssd_scan

#: every CUDA source of the package, as ``_build.build_all`` takes them
SOURCES = ("fused_collective", "spmd_collective", "prefix_scan", "ssd_scan",
           "flash_attention", "ssd_chunk")

__all__ = ["SOURCES", "flash_attention", "prefix_scan", "ssd_scan"]
