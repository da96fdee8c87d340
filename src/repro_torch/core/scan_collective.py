"""Public API of the offloaded scan collective (PyTorch port of
``repro.core.scan_collective``): :func:`dist_scan` / :func:`dist_exscan` /
:func:`dist_scan_pair` per rank inside :func:`repro_torch.compat.shard_map`
over one named axis, and :func:`sim_scan` over stacked ``(p, ...)`` tensors
on one device.

Exclusive scans come in two flavors, mirroring the paper:
  * structural: run the inclusive schedule on shifted inputs (one extra
    single-hop permute) — works for any operator;
  * inverse-op (``algorithm="invertible_doubling"``): recover exclusive from
    inclusive locally via the operator inverse — the Fig. 3 subtraction
    trick, zero extra communication.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.core import algorithms as alg
from repro_torch.core.operators import AssocOp, get_operator
from repro_torch.core.packet import CollectiveDescriptor
from repro_torch.core.selector import select_algorithm
from repro_torch.core.trees import tree_device, tree_leaves

PyTree = Any


def _payload_bytes(x: PyTree) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(x))


def dist_scan(
    x: PyTree,
    op: "AssocOp | str",
    axis_name: str,
    *,
    algorithm: str = "auto",
    descriptor: Optional[CollectiveDescriptor] = None,
) -> PyTree:
    """Inclusive parallel prefix scan (MPI_Scan) across ``axis_name``.

    Args:
      x: per-rank pytree contribution (leaves may be any shape).
      op: an :class:`AssocOp` or registered name ("sum", "max", "ssd", ...).
      axis_name: mesh axis to scan over (bound by the enclosing
        :func:`repro_torch.compat.shard_map`).
      algorithm: one of ``core.algorithms.ALGORITHMS`` or "auto" to let the
        selector pick from (p, per-rank payload bytes).
      descriptor: optional offload descriptor; when given, its ``algo_type``
        wins.
    """
    from repro_torch import compat

    op = get_operator(op)
    p = compat.axis_size(axis_name)
    if descriptor is not None:
        algorithm = descriptor.algo_type
    if algorithm == "auto":
        algorithm = select_algorithm(
            p, compat.per_rank_bytes(x, axis_name), op
        )
    backend = alg.SpmdBackend(axis_name, p)
    return alg.get_algorithm(algorithm)(backend, x, op)


def dist_exscan(
    x: PyTree,
    op: "AssocOp | str",
    axis_name: str,
    *,
    algorithm: str = "auto",
    use_inverse: Optional[bool] = None,
    descriptor: Optional[CollectiveDescriptor] = None,
) -> PyTree:
    """Exclusive scan (MPI_Exscan): rank j gets x_0 (+) ... (+) x_{j-1}.

    Rank 0 receives the operator identity. The structural form has no final
    rank-0 mask, as the reference's: rank 0's shifted-in value already is
    the identity (zeros for zero-identity operators, the identity fill
    otherwise).
    """
    from repro_torch import compat

    op = get_operator(op)
    p = compat.axis_size(axis_name)
    if descriptor is not None:
        algorithm = descriptor.algo_type
    if algorithm == "auto":
        algorithm = select_algorithm(
            p, compat.per_rank_bytes(x, axis_name), op, coll="exscan"
        )
    if use_inverse is None:
        use_inverse = algorithm == "invertible_doubling" and op.inverse is not None

    backend = alg.SpmdBackend(axis_name, p)
    identity = op.identity_like(x)
    if p == 1:
        return identity

    if use_inverse:
        if op.inverse is None:
            raise ValueError(f"op {op.name!r} has no inverse")
        inc = alg.get_algorithm(algorithm)(backend, x, op)
        # y_inc = y_ex (+) x, so for commutative ops y_ex = y_inc (+) inv(x)
        if not op.commutative:
            raise ValueError(
                "inverse-based exscan requires a commutative operator; "
                f"{op.name!r} is not"
            )
        ex = op.combine(inc, op.inverse(x))
        rank = backend.rank()
        return alg._bwhere(rank == 0, identity, ex)

    # Structural: shift contributions one rank to the right, then inclusive
    # scan; rank 0 holds the identity. One extra single-hop permute.
    shifted = backend.permute(x, [(i, i + 1) for i in range(p - 1)])
    if op.zero_identity:
        return alg.get_algorithm(algorithm)(backend, shifted, op)
    rank = backend.rank()
    shifted = alg._bwhere(rank != 0, shifted, identity)
    return alg.get_algorithm(algorithm)(backend, shifted, op)


def dist_scan_pair(
    x: PyTree,
    op: "AssocOp | str",
    axis_name: str,
    *,
    algorithm: str = "auto",
) -> "tuple[PyTree, PyTree]":
    """Return (exclusive, inclusive) in one schedule run: inc = ex (+) x."""
    op = get_operator(op)
    ex = dist_exscan(x, op, axis_name, algorithm=algorithm)
    return ex, op.combine(ex, x)


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
