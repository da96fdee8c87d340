"""Pytree and device helpers (the port's ``jax.tree``).

Payloads are tensors or tuples of tensors (SSD ``(a, b)``, flash
``(m, l, o)``); ``tree_map`` maps over several trees of one structure, like
``jax.tree.map``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

PyTree = Any

tree_flatten = pytree.tree_flatten
tree_unflatten = pytree.tree_unflatten
tree_leaves = pytree.tree_leaves
tree_map = pytree.tree_map


def resolve_device(device: "torch.device | str") -> torch.device:
    """``device`` with the current CUDA device filled in for a bare
    ``"cuda"``, so it compares equal to the device a tensor reports."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def checked_device(device: "torch.device | str", who: str) -> torch.device:
    """``device`` resolved as :func:`resolve_device` does; raises, naming
    ``who``, when it is a CUDA device on a machine without one (entry points
    run on the card unless the caller asks for the CPU, never quietly on the
    CPU in its place)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} needs a CUDA device and none is available; pass "
            "device='cpu' to run on the CPU"
        )
    return resolve_device(device)


def tree_device(tree: PyTree) -> torch.device:
    """The one device every leaf of ``tree`` lives on (raises on a mix)."""
    devices = {leaf.device for leaf in tree_leaves(tree)}
    if len(devices) != 1:
        raise ValueError(
            f"payload leaves must share one device; got {sorted(map(str, devices))}"
        )
    return devices.pop()
