"""Optimizer and gradient compression of the port (counterpart of
``repro.optim``)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state, lr_at
from repro_torch.optim.compression import (
    compress_with_feedback,
    compressed_allreduce_mean,
    dequantize_int8,
    quantize_int8,
)

__all__ = ["AdamWConfig", "adamw_update", "compress_with_feedback",
           "compressed_allreduce_mean", "dequantize_int8", "init_opt_state",
           "lr_at", "quantize_int8"]
