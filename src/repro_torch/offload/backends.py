"""The lowering-backend registry (PyTorch port of ``repro.offload.backends``):
how a ``CollectivePlan`` becomes code.

A :class:`LoweringBackend` exposes:

  name           registry key ("sim", "spmd", "pallas")
  capabilities   can this backend lower this plan? Returns ``(ok, reason)``
                 with a stable reason token so the engine can attribute
                 fallbacks in telemetry.
  lower          plan -> schedule callable: over stacked ``(p, ...)`` leaves
                 on a device, or, given ``axis_names``, per rank inside
                 :func:`repro_torch.compat.shard_map`
  fingerprint    extra cache-key fields. Empty for the mode default, so
                 default cache keys stay byte-identical to the reference's;
                 a non-default backend contributes ``(("backend", name),)``.

The fused-kernel backend is registered under ``"pallas"``: that is the
backend's *wire* name (``packet._WIRE_BACKENDS``), so descriptor words stay
byte-identical to the reference's; here it lowers to the CUDA kernels of
:mod:`repro_torch.kernels.fused_collective` (K1 over stacked ranks) and
:mod:`repro_torch.kernels.spmd_collective` (K2 per rank).

``resolve`` is the single soft-fallback point: ask for a backend by name,
get the default back (plus the capability-miss reason) when the plan is
outside the named backend's support — the engine counts those in
``EngineTelemetry.backend_fallbacks``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, Sequence, Tuple

import torch

from repro_torch.core.operators import AssocOp, get_operator
from repro_torch.core.scan_collective import _payload_bytes
from repro_torch.core.trees import tree_device, tree_map
from repro_torch.offload.planner import (
    CollectivePlan,
    build_plan,
    lower_sim,
    lower_spmd,
)

PyTree = Any

#: name the wire format / descriptors use for "whatever the mode default
#: is" — encodes as backend id 0, so default descriptors keep their bytes
DEFAULT_BACKEND = ""


class LoweringBackend(Protocol):
    """The contract a plan lowering plugs into the registry with."""

    name: str

    def capabilities(
        self,
        plan: CollectivePlan,
        axis_names: Optional[Sequence[str]] = None,
    ) -> Tuple[bool, str]:
        """``(ok, reason)`` — can this backend lower ``plan``? ``reason``
        is a stable telemetry token when it can't ("" when it can)."""
        ...

    def lower(
        self,
        plan: CollectivePlan,
        op: "AssocOp | str | None" = None,
        *,
        device: "torch.device | str" = "cuda",
        axis_names: Optional[Sequence[str]] = None,
        traced: bool = False,
    ) -> Callable:
        """Compile ``plan`` to a schedule callable: over stacked leaves on
        ``device``, or per rank under ``axis_names`` (whose mesh then
        decides the device). ``traced`` asks a stacked-leaf lowering for
        its span-emitting form (phase and round spans)."""
        ...

    def fingerprint(self) -> Tuple[Tuple[str, str], ...]:
        """Cache-key fields this backend adds. MUST be empty for the mode
        default (key stability); non-defaults return (("backend", name),)."""
        ...


@dataclasses.dataclass(frozen=True)
class SimLowering:
    """Op-per-round interpreter over stacked leaves (the engine's sim mode)."""

    name: str = "sim"

    def capabilities(self, plan, axis_names=None):
        if axis_names is not None:
            return False, "needs_stacked_input"
        return True, ""

    def lower(self, plan, op=None, *, device="cuda", axis_names=None,
              traced=False):
        if axis_names is not None:
            raise ValueError("the sim lowering takes stacked input, no axes")
        return lower_sim(plan, op, device=device, traced=traced)

    def fingerprint(self):
        return ()


@dataclasses.dataclass(frozen=True)
class SpmdLowering:
    """Op-per-round per-rank schedule inside shard_map (spmd/driver modes)."""

    name: str = "spmd"

    def capabilities(self, plan, axis_names=None):
        if axis_names is None:
            return False, "needs_axis_names"
        return True, ""

    def lower(self, plan, op=None, *, device="cuda", axis_names=None,
              traced=False):
        return lower_spmd(plan, axis_names, op)

    def fingerprint(self):
        return ()


@dataclasses.dataclass(frozen=True)
class FusedLowering:
    """Fused-kernel backend: every exchange round of a comm phase runs
    inside one kernel launch (``repro_torch.kernels.fused_collective``)."""

    name: str = "pallas"

    def capabilities(self, plan, axis_names=None):
        from repro_torch.kernels import fused_collective

        return fused_collective.supports_rank_plan(plan, axis_names)

    def lower(self, plan, op=None, *, device="cuda", axis_names=None,
              traced=False):
        from repro_torch.kernels import fused_collective

        return fused_collective.lower_fused(
            plan, op, device=device, axis_names=axis_names, traced=traced
        )

    def fingerprint(self):
        return (("backend", self.name),)


_REGISTRY: Dict[str, LoweringBackend] = {}


def register_backend(backend: LoweringBackend) -> LoweringBackend:
    _REGISTRY[backend.name] = backend
    return backend


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def default_backend_name(
    axis_names: Optional[Sequence[str]] = None,
) -> str:
    """The backend a mode resolves to when none is named: the op-per-round
    interpreter for stacked inputs, the per-rank schedule under named
    axes."""
    return "sim" if axis_names is None else "spmd"


def get_backend(name: str) -> LoweringBackend:
    key = name or DEFAULT_BACKEND
    if key == DEFAULT_BACKEND:
        raise ValueError(
            "the default backend is mode-dependent; resolve it with "
            "default_backend_name(axis_names)"
        )
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown lowering backend {name!r}; registered: "
            f"{', '.join(backend_names())}"
        ) from None


def resolve(
    name: str,
    plan: CollectivePlan,
    axis_names: Optional[Sequence[str]] = None,
) -> Tuple[LoweringBackend, str]:
    """Resolve ``name`` for ``plan``, soft-falling back to the mode default.

    Returns ``(backend, fallback_reason)``; ``fallback_reason`` is "" when
    the named backend (or the default, for ``name == ""``) was used, and
    the capability-miss token when the request fell back. Unknown names
    raise (a typo is a bug, a capability miss is not).
    """
    default = get_backend(default_backend_name(axis_names))
    if (name or DEFAULT_BACKEND) == DEFAULT_BACKEND:
        return default, ""
    backend = get_backend(name)
    if backend.name == default.name:
        return default, ""
    ok, reason = backend.capabilities(plan, axis_names)
    if ok:
        return backend, ""
    return default, reason or "unsupported"


register_backend(SimLowering())
register_backend(SpmdLowering())
register_backend(FusedLowering())


# ---------------------------------------------------------------------------
# Two-level hierarchical entry point: the classic block-scan decomposition
# (intra-row scan, carry exscan along the orthogonal axis, guarded local
# combine) as a 2-axis plan lowered through the registry default. With
# global rank order outer-major the result equals the flat single-axis scan
# over p_outer * p_inner ranks — bitwise, because carries always enter the
# combine on the left.
# ---------------------------------------------------------------------------


def _two_level_plan(op, sizes, payload_bytes, *, inclusive, algorithms):
    return build_plan(
        "SCAN" if inclusive else "EXSCAN",
        sizes,
        op,
        payload_bytes,
        order=(0, 1),
        level_algorithms=algorithms,
    )


def dist_hierarchical_scan(
    x: PyTree,
    op: "AssocOp | str",
    inner_axis: str,
    outer_axis: str,
    *,
    inclusive: bool = True,
    inner_algorithm: str = "auto",
    outer_algorithm: str = "auto",
) -> PyTree:
    """Two-level scan across ``outer_axis``-major ``inner_axis``-minor order.

    Call inside :func:`repro_torch.compat.shard_map` over a mesh with both
    axes. Equivalent to a flat scan over the p_outer * p_inner ranks in
    (outer, inner) order, but each phase's schedule only ever spans one
    axis.
    """
    from repro_torch import compat

    op = get_operator(op)
    axis_names = (outer_axis, inner_axis)
    plan = _two_level_plan(
        op,
        (compat.axis_size(outer_axis), compat.axis_size(inner_axis)),
        compat.per_rank_bytes(x, inner_axis),
        inclusive=inclusive,
        algorithms=(outer_algorithm, inner_algorithm),
    )
    backend, _ = resolve(DEFAULT_BACKEND, plan, axis_names)
    return backend.lower(plan, op, axis_names=axis_names)(x)


def sim_hierarchical_scan(
    stacked: PyTree,
    op: "AssocOp | str",
    p_outer: int,
    p_inner: int,
    *,
    inclusive: bool = True,
    inner_algorithm: str = "hillis_steele",
    outer_algorithm: str = "hillis_steele",
) -> PyTree:
    """Single-device realization over stacked (p_outer, p_inner, ...) leaves,
    on the device the leaves live on."""
    op = get_operator(op)
    plan = _two_level_plan(
        op,
        (p_outer, p_inner),
        _payload_bytes(stacked),
        inclusive=inclusive,
        algorithms=(outer_algorithm, inner_algorithm),
    )
    backend, _ = resolve(DEFAULT_BACKEND, plan)
    flat = flat_equivalent(stacked, p_outer, p_inner)
    out = backend.lower(plan, op, device=tree_device(stacked))(flat)
    return tree_map(
        lambda a: a.reshape((p_outer, p_inner) + tuple(a.shape[1:])), out
    )


def flat_equivalent(
    stacked_2d: PyTree, p_outer: int, p_inner: int
) -> PyTree:
    """Reshape a (p_outer, p_inner, ...) stacked pytree to the flat
    (p_outer * p_inner, ...) layout the hierarchical result must match."""
    return tree_map(
        lambda a: a.reshape((p_outer * p_inner,) + tuple(a.shape[2:])),
        stacked_2d,
    )
