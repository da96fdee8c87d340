"""Gradient compression: int8 quantization with error feedback (port of
``repro.optim.compression``).

Symmetric per-tensor int8 with the quantization residual fed back into the
next step's gradient, so the compression error is re-injected rather than
lost. ``torch.round`` rounds half to even, as ``jnp.round`` does.

:func:`compressed_allreduce_mean` is the region building block: quantize ->
``compat.psum`` of the dequantized values -> mean, with the residual
returned for feedback. Gradient trees are ``{name: tensor}`` dicts (or any
pytree of tensors).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.core.trees import tree_flatten, tree_map, tree_unflatten

PyTree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_with_feedback(
    grads: PyTree, error: Optional[PyTree]
) -> Tuple[PyTree, PyTree, PyTree]:
    """Quantize (grads + error); new error = input - dequantized.

    Returns (q_tree, scale_tree, new_error_tree)."""
    if error is None:
        error = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                         grads)

    def one(g, e):
        x = g.float() + e
        q, s = quantize_int8(x)
        return q, s, x - dequantize_int8(q, s)

    flat_g, spec = tree_flatten(grads)
    flat_e, _ = tree_flatten(error)
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return tuple(tree_unflatten([o[i] for o in outs], spec) for i in range(3))


def compressed_allreduce_mean(
    grads: PyTree, axis_name: str, error: Optional[PyTree] = None
) -> Tuple[PyTree, PyTree]:
    """Data-parallel gradient mean with int8 payloads and error feedback,
    inside a :func:`repro_torch.compat.block_shard_map` region over
    ``axis_name``.

    int8 does not survive summation, so the sum runs on each rank's
    dequantized int8 value; the quantization error stays local in the
    feedback buffer. A region's leaves carry rank rows, so each row is
    quantized on its own (its own scale), as each rank is in the
    reference."""
    rows = compat.region_rows(axis_name)
    p = compat.axis_size(axis_name)

    def per_row(fn, *trees):
        """``fn`` over each rank row of ``trees``, stacked back."""
        outs = [fn(*[tree_map(lambda a, r=r: a[r], t) for t in trees])
                for r in range(rows)]
        flat = [tree_flatten(o)[0] for o in outs]
        spec = tree_flatten(outs[0])[1]
        return tree_unflatten([torch.stack(col) for col in zip(*flat)], spec)

    q, s, new_err = per_row(
        compress_with_feedback,
        grads, error if error is not None
        else tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                      grads))
    deq = tree_map(
        lambda qi, si: dequantize_int8(
            qi, si.reshape(si.shape + (1,) * (qi.ndim - si.ndim))), q, s)
    tot = compat.psum(deq, axis_name)
    mean = tree_map(lambda t, g: (t / p).to(g.dtype), tot, grads)
    return mean, new_err
