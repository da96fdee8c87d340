"""Public scan entry points over a stacked rank axis (PyTorch port of
``repro.core.scan_collective``).

This slice ports the single-device simulator, :func:`sim_scan`. Exclusive
scans come in two flavors, mirroring the paper:
  * structural: run the inclusive schedule on shifted inputs (one extra
    single-hop permute) — works for any operator;
  * inverse-op (``algorithm="invertible_doubling"``): recover exclusive from
    inclusive locally via the operator inverse — the Fig. 3 subtraction
    trick, zero extra communication.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core import algorithms as alg
from repro_torch.core.operators import AssocOp, get_operator
from repro_torch.core.trees import tree_device, tree_leaves

PyTree = Any


def _payload_bytes(x: PyTree) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(x))


def sim_scan(
    stacked: PyTree,
    op: "AssocOp | str",
    p: int,
    *,
    algorithm: str,
    inclusive: bool = True,
    backend: "alg.Backend | None" = None,
) -> PyTree:
    """Run a schedule on stacked ``(p, ...)`` tensors without any mesh, on
    the device the tensors live on.

    ``backend`` overrides the default :class:`~repro_torch.core.algorithms.
    SimBackend`; it must behave like a SimBackend of size ``p``.
    """
    op = get_operator(op)
    if backend is None:
        backend = alg.SimBackend(p, tree_device(stacked))
    if inclusive:
        return alg.get_algorithm(algorithm)(backend, stacked, op)
    identity = op.identity_like(stacked)
    if p == 1:
        return identity
    rank = backend.rank()
    if (
        algorithm == "invertible_doubling"
        and op.inverse is not None
        and op.commutative
    ):
        # The Fig. 3 subtraction trick: recover the exclusive value locally,
        # skipping the structural shift permute.
        inc = alg.get_algorithm(algorithm)(backend, stacked, op)
        ex = op.combine(inc, op.inverse(stacked))
        return alg._bwhere(rank != 0, ex, identity)
    shifted = backend.permute(stacked, [(i, i + 1) for i in range(p - 1)])
    if not op.zero_identity:
        shifted = alg._bwhere(rank != 0, shifted, identity)
    out = alg.get_algorithm(algorithm)(backend, shifted, op)
    return alg._bwhere(rank != 0, out, identity)
