"""The descriptor's other coll_types on the same schedule machinery (PyTorch
port of ``repro.core.reduce_ops``): MPI_Reduce / MPI_Allreduce /
MPI_Barrier, built from the identical backend abstraction — a reduce is a
scan whose result is read at the root; a barrier is a one-token allreduce.

Every schedule is written against the abstract backend, so the same code
runs per rank inside :func:`repro_torch.compat.shard_map` (``dist_*``) and on
the single-device simulator (``sim_*``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import algorithms as alg
from repro_torch.core.operators import MAX, AssocOp, get_operator
from repro_torch.core.trees import tree_device

PyTree = Any


# ---------------------------------------------------------------------------
# Backend-generic schedules
# ---------------------------------------------------------------------------


def reduce_schedule(
    backend: alg.Backend, x: PyTree, op: AssocOp, *, root: int = 0,
    algorithm: str = "binomial_tree",
) -> PyTree:
    """MPI_Reduce: the full reduction lands on ``root``; other ranks receive
    the operator identity. Runs the scan schedule (rank p-1 holds the total)
    and ships it to root with one permute."""
    p = backend.p
    total = alg.get_algorithm(algorithm)(backend, x, op)
    if p == 1:
        return total
    rank = backend.rank()
    ident = op.identity_like(x)
    if root == p - 1:
        return alg._bwhere(rank == root, total, ident)
    moved = backend.permute(total, [(p - 1, root)])
    return alg._bwhere(rank == root, moved, ident)


def allreduce_schedule(
    backend: alg.Backend, x: PyTree, op: AssocOp, *,
    algorithm: str = "recursive_doubling",
) -> PyTree:
    """MPI_Allreduce (every rank ends with the total).

    Power-of-two sizes run the recursive-doubling butterfly with the combine
    *ordered by rank block* (received block precedes ours iff the partner is
    lower), which keeps the schedule correct for non-commutative operators
    such as SSD. Other sizes fall back to inclusive-scan +
    broadcast-from-last, correct for any p and operator."""
    p = backend.p
    if p == 1:
        return x
    if p & (p - 1) == 0:
        rank = backend.rank()
        acc_v, acc_f = x, alg._ones_flag(backend)
        for k in range(alg.num_steps(p)):
            d = 1 << k
            perm = [(j, j ^ d) for j in range(p)]
            rv, rf = backend.permute((acc_v, acc_f), perm)
            partner_lower = (rank & d) != 0  # partner = rank ^ d < rank
            lo_v, lo_f = alg._combine_lr(op, rv, rf, acc_v, acc_f)
            hi_v, hi_f = alg._combine_lr(op, acc_v, acc_f, rv, rf)
            acc_v = alg._bwhere(partner_lower, lo_v, hi_v)
            acc_f = torch.where(partner_lower, lo_f, hi_f)
        return acc_v
    total = alg.get_algorithm(algorithm)(backend, x, op)
    bcast = backend.permute(total, [(p - 1, j) for j in range(p - 1)])
    rank = backend.rank()
    return alg._bwhere(rank == p - 1, total, bcast)


def barrier_schedule(
    backend: alg.Backend, *, algorithm: str = "recursive_doubling"
) -> torch.Tensor:
    """MPI_Barrier (the authors' NetFPGA barrier, ref [6]): a minimal-payload
    allreduce; returns 1.0 per rank."""
    r = backend.rank()
    token = torch.ones(r.shape, dtype=torch.float32, device=r.device)
    return allreduce_schedule(backend, token, MAX, algorithm=algorithm)


# ---------------------------------------------------------------------------
# SPMD entry points (per rank, inside shard_map)
# ---------------------------------------------------------------------------


def dist_reduce(
    x: PyTree, op: "AssocOp | str", axis_name: str, *, root: int = 0,
    algorithm: str = "binomial_tree",
) -> PyTree:
    op = get_operator(op)
    backend = alg.SpmdBackend(axis_name)
    return reduce_schedule(backend, x, op, root=root, algorithm=algorithm)


def dist_allreduce(
    x: PyTree, op: "AssocOp | str", axis_name: str, *,
    algorithm: str = "recursive_doubling",
) -> PyTree:
    op = get_operator(op)
    backend = alg.SpmdBackend(axis_name)
    return allreduce_schedule(backend, x, op, algorithm=algorithm)


def dist_barrier(
    axis_name: str, *, algorithm: str = "recursive_doubling"
) -> torch.Tensor:
    backend = alg.SpmdBackend(axis_name)
    return barrier_schedule(backend, algorithm=algorithm)


# ---------------------------------------------------------------------------
# Simulator entry points (stacked leading rank axis, single device)
# ---------------------------------------------------------------------------


def sim_reduce(
    stacked: PyTree, op: "AssocOp | str", p: int, *, root: int = 0,
    algorithm: str = "binomial_tree",
) -> PyTree:
    op = get_operator(op)
    backend = alg.SimBackend(p, tree_device(stacked))
    return reduce_schedule(backend, stacked, op, root=root, algorithm=algorithm)


def sim_allreduce(
    stacked: PyTree, op: "AssocOp | str", p: int, *,
    algorithm: str = "recursive_doubling",
) -> PyTree:
    op = get_operator(op)
    backend = alg.SimBackend(p, tree_device(stacked))
    return allreduce_schedule(backend, stacked, op, algorithm=algorithm)


def sim_barrier(
    p: int, *, algorithm: str = "recursive_doubling",
    device: "torch.device | str" = "cuda",
) -> torch.Tensor:
    return barrier_schedule(alg.SimBackend(p, device), algorithm=algorithm)
