"""Algorithm selection (PyTorch port of ``repro.core.selector``) — the
paper's "MPI runtime can make an intelligent selection of algorithms based
on the underlying network topology".

The choice is an alpha-beta-gamma cost model:

    T(algo) = sum over steps of [ alpha + bytes_on_wire * beta + hops * gamma ]

with per-algorithm step counts and wire patterns, linear in (alpha, beta,
gamma) via :func:`cost_features`. When a tuning table is active
(:func:`set_active_tuning`) the selector consults its measured per-point
winners and fitted model before falling back to the static constants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.algorithms import (
    ALGORITHMS,
    algorithm_step_count,
    num_steps,
)
from repro_torch.core.operators import AssocOp


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Interconnect constants.

    alpha: per-step launch latency (s).
    beta: seconds per byte per link (1 / link bandwidth).
    gamma: per-hop transit latency (s).
    ring: axes are rings; hop distance of a stride-s permute is
      min(s, p - s).
    """

    alpha: float = 1.0e-6
    beta: float = 1.0 / 50.0e9
    gamma: float = 0.5e-6
    ring: bool = True


#: The reference package's unmeasured cost-model defaults, kept unchanged so
#: that plans (split, per-phase algorithms, chunk counts) come out identical
#: to the reference's. They are not a measurement of any card; a fitted
#: model for the GPU comes with the tuner.
DEFAULT_LINK_MODEL = LinkModel()


def _hop(stride: int, p: int, ring: bool) -> int:
    return min(stride, p - stride) if ring else stride


def cost_features(
    algo: str, p: int, payload_bytes: int, ring: bool = True
) -> Tuple[float, float, float]:
    """(steps, bytes, hops) such that the predicted latency is their dot
    product with (alpha, beta, gamma)."""
    if p <= 1:
        return (0.0, 0.0, 0.0)
    m = float(payload_bytes)
    lg = num_steps(p)
    if algo in ("sequential", "sequential_pipelined"):
        return (float(p - 1), (p - 1) * m, float(p - 1))
    up_hops = float(sum(_hop(1 << k, p, ring) for k in range(lg)))
    if algo in (
        "hillis_steele",
        "invertible_doubling",
        "recursive_doubling",
        "sklansky",
    ):
        return (float(lg), lg * m, up_hops)
    if algo == "binomial_tree":
        down_hops = float(
            sum(_hop(1 << (k - 1), p, ring) for k in range(lg, 0, -1))
        )
        return (2.0 * lg, 2 * lg * m, up_hops + down_hops)
    raise ValueError(f"unknown algo {algo!r}")


def estimate_cost(
    algo: str, p: int, payload_bytes: int,
    model: LinkModel = DEFAULT_LINK_MODEL,
) -> float:
    """Predicted completion latency of one scan with ``algo`` at size p."""
    steps, nbytes, hops = cost_features(algo, p, payload_bytes, model.ring)
    return steps * model.alpha + nbytes * model.beta + hops * model.gamma


def cost_table(
    p: int, payload_bytes: int, model: LinkModel = DEFAULT_LINK_MODEL
) -> Dict[str, float]:
    return {
        name: estimate_cost(name, p, payload_bytes, model)
        for name in ALGORITHMS
    }


# ---------------------------------------------------------------------------
# Tuning-table hook (duck-typed): anything with
# ``lookup(p, payload_bytes, coll) -> Optional[str]`` and
# ``fitted_model() -> Optional[LinkModel]``.
# ---------------------------------------------------------------------------

_ACTIVE_TUNING = None


def set_active_tuning(table) -> None:
    """Install (or, with None, clear) the tuning table ``select_algorithm``
    consults before the static constants."""
    global _ACTIVE_TUNING
    _ACTIVE_TUNING = table


def get_active_tuning():
    return _ACTIVE_TUNING


def _applicable(name: str, p: int, op: AssocOp) -> bool:
    if name not in ALGORITHMS:
        return False
    if name == "invertible_doubling" and (
        op.inverse is None or not op.commutative
    ):
        return False
    return True


def select_algorithm(
    p: int,
    payload_bytes: int,
    op: AssocOp,
    model: Optional[LinkModel] = None,
    coll: str = "scan",
) -> str:
    """Pick the cheapest *applicable* schedule.

    Resolution order when ``model`` is not given explicitly:
      1. an active tuning table's measured winner at/near (p, payload, coll);
      2. the tuning table's least-squares-fitted LinkModel;
      3. :data:`DEFAULT_LINK_MODEL`.

    Ties break toward fewer steps, then lexicographic for determinism.
    """
    if model is None:
        if _ACTIVE_TUNING is not None:
            winner = _ACTIVE_TUNING.lookup(p, payload_bytes, coll)
            if winner is not None and _applicable(winner, p, op):
                return winner
            model = _ACTIVE_TUNING.fitted_model()
        if model is None:
            model = DEFAULT_LINK_MODEL
    costs = cost_table(p, payload_bytes, model)
    if op.inverse is None or not op.commutative:
        costs.pop("invertible_doubling", None)
    # sequential's O(p) critical path makes it a scalability trap (the paper's
    # own conclusion); keep it out of auto-selection beyond tiny axes.
    if p > 8:
        costs.pop("sequential", None)
        costs.pop("sequential_pipelined", None)
    return min(
        costs.items(),
        key=lambda kv: (kv[1], algorithm_step_count(kv[0], p), kv[0]),
    )[0]
