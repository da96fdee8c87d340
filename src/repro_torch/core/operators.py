"""Associative operators for the offloaded scan collective (PyTorch port of
``repro.core.operators``).

The paper's offload packet carries an ``operation`` enum (MPI_SUM, MPI_MAX, ...)
and a ``data_type``; the NetFPGA state machine streams the combine at line rate.
Here the analogue is an :class:`AssocOp`: a named, pytree-valued associative
combine with an identity, an optional inverse (the paper's Fig. 3 "subtraction"
trick requires an invertible operator), and metadata the schedule generator uses
to pick fast paths (``zero_identity`` lets a zero-filled receive act as the
identity, removing all masking selects from the schedule, and it is what the
fused collective kernel's envelope depends on).

Operators act on pytrees of tensors (``torch.utils._pytree``): the SSD operator
combines ``(decay, state)`` pairs, the flash operator ``(m, l, o)`` triples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.trees import tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AssocOp:
    """An associative binary operator over pytrees.

    Attributes:
      name: wire name (the ``operation`` field of the offload descriptor).
      combine: combine(left, right) with *left* the earlier-prefix operand.
        Must be associative; need not be commutative.
      identity_like: given an example pytree, return the identity element
        (same shapes/dtypes/devices).
      inverse: optional. ``combine(inverse(a), combine(a, b)) == b`` and, when
        ``commutative``, ``combine(combine(b, a), inverse(a)) == b``.
      commutative: whether operand order is irrelevant.
      zero_identity: True iff the identity element is all-zeros for every leaf;
        lets schedules skip (value, valid) masking because a zero-filled
        receive already is the identity.
    """

    name: str
    combine: Callable[[PyTree, PyTree], PyTree]
    identity_like: Callable[[PyTree], PyTree]
    inverse: Optional[Callable[[PyTree], PyTree]] = None
    commutative: bool = False
    zero_identity: bool = False

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"AssocOp({self.name})"


def _lowest(a: torch.Tensor):
    if a.dtype.is_floating_point:
        return torch.finfo(a.dtype).min
    return torch.iinfo(a.dtype).min


def _highest(a: torch.Tensor):
    if a.dtype.is_floating_point:
        return torch.finfo(a.dtype).max
    return torch.iinfo(a.dtype).max


SUM = AssocOp(
    name="sum",
    combine=lambda l, r: tree_map(torch.add, l, r),
    identity_like=lambda t: tree_map(torch.zeros_like, t),
    inverse=lambda t: tree_map(torch.neg, t),
    commutative=True,
    zero_identity=True,
)

PROD = AssocOp(
    name="prod",
    combine=lambda l, r: tree_map(torch.mul, l, r),
    identity_like=lambda t: tree_map(torch.ones_like, t),
    # Inverse only valid away from zero; callers opt in.
    inverse=lambda t: tree_map(lambda a: 1.0 / a, t),
    commutative=True,
)

MAX = AssocOp(
    name="max",
    combine=lambda l, r: tree_map(torch.maximum, l, r),
    identity_like=lambda t: tree_map(
        lambda a: torch.full_like(a, _lowest(a)), t
    ),
    commutative=True,
)

MIN = AssocOp(
    name="min",
    combine=lambda l, r: tree_map(torch.minimum, l, r),
    identity_like=lambda t: tree_map(
        lambda a: torch.full_like(a, _highest(a)), t
    ),
    commutative=True,
)


def _ssd_combine(left: PyTree, right: PyTree) -> PyTree:
    """Combine for the linear recurrence h' = a*h + b.

    Elements are ``(a, b)`` tuples (decay, state contribution); ``a`` must be
    broadcast-compatible with ``b``. Applying ``left`` then ``right`` to an
    incoming state h gives ``aR*(aL*h + bL) + bR = (aR*aL)*h + (aR*bL + bR)``.
    """
    a_l, b_l = left
    a_r, b_r = right
    return (a_r * a_l, a_r * b_l + b_r)


SSD = AssocOp(
    name="ssd",
    combine=_ssd_combine,
    identity_like=lambda t: (torch.ones_like(t[0]), torch.zeros_like(t[1])),
    commutative=False,
)


def _flash_combine(left: PyTree, right: PyTree) -> PyTree:
    """Associative combine of flash-attention partial results.

    Elements are ``(m, l, o)``: running max of logits, sum of exp-weights, and
    the exp-weighted value accumulator. Commutative & associative.
    """
    m_l, l_l, o_l = left
    m_r, l_r, o_r = right
    m = torch.maximum(m_l, m_r)
    c_l = torch.exp(m_l - m)
    c_r = torch.exp(m_r - m)
    return (m, l_l * c_l + l_r * c_r, o_l * c_l + o_r * c_r)


def make_flash_op(neg_inf: float = -1e30) -> AssocOp:
    return AssocOp(
        name="flash",
        combine=_flash_combine,
        identity_like=lambda t: (
            torch.full_like(t[0], neg_inf),
            torch.zeros_like(t[1]),
            torch.zeros_like(t[2]),
        ),
        commutative=True,
    )


_REGISTRY = {
    "sum": SUM,
    "prod": PROD,
    "max": MAX,
    "min": MIN,
    "ssd": SSD,
    "flash": make_flash_op(),
}


def get_operator(op: "AssocOp | str") -> AssocOp:
    if isinstance(op, AssocOp):
        return op
    try:
        return _REGISTRY[op]
    except KeyError:
        raise ValueError(
            f"unknown operator {op!r}; known: {sorted(_REGISTRY)}"
        ) from None


def register_operator(op: AssocOp) -> None:
    _REGISTRY[op.name] = op


def segmented_operator(op: AssocOp) -> AssocOp:
    """Lift an operator to SEGMENTED scans (Blelloch — the paper's refs [8,9]).

    Elements are ``(value, start_flag)``: flag=1 marks a segment start and
    blocks accumulation across the boundary. The lifted combine

        (a, fa) (+) (b, fb) = (b if fb else a (+) b,  fa | fb)

    is associative whenever ``op`` is, so every schedule works unchanged.
    """

    def combine(left: PyTree, right: PyTree) -> PyTree:
        (va, fa) = left
        (vb, fb) = right
        merged = op.combine(va, vb)
        keep_b = fb > 0.5

        def sel(m, b):
            c = keep_b
            extra = m.ndim - c.ndim
            if extra > 0:
                c = c.reshape(c.shape + (1,) * extra)
            return torch.where(c, b, m)

        return (
            tree_map(sel, merged, vb),
            torch.maximum(fa, fb),
        )

    return AssocOp(
        name=f"segmented_{op.name}",
        combine=combine,
        identity_like=lambda t: (
            op.identity_like(t[0]), torch.zeros_like(t[1])
        ),
        commutative=False,  # segment boundaries impose order
        zero_identity=False,
    )
