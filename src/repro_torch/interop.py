"""State that crosses between the JAX reference and the PyTorch port.

The system has no weights. What crosses is

* descriptor words, which :class:`repro_torch.core.packet.
  CollectiveDescriptor.decode` reads directly (the wire format is shared);
* payload pytrees: single arrays, the SSD ``(a, b)`` and the flash
  ``(m, l, o)`` tuples, as numpy arrays on one side and tensors on the other.

bfloat16 has no numpy dtype of its own; on the numpy side it is the
``ml_dtypes`` bfloat16 the JAX package uses, carried across bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.trees import tree_map

PyTree = Any


def _tensor_from_numpy(a: np.ndarray, device: "torch.device | str") -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def payload_from_numpy(tree: PyTree, device: "torch.device | str") -> PyTree:
    """numpy payload pytree -> tensors on ``device`` (values bit for bit)."""
    return tree_map(lambda a: _tensor_from_numpy(np.asarray(a), device), tree)


def payload_to_numpy(tree: PyTree) -> PyTree:
    """Tensor payload pytree -> numpy arrays on the host (bit for bit)."""
    return tree_map(_tensor_to_numpy, tree)
