"""Topology context: logical parallelism axes -> physical mesh axes (port of
``repro.sharding.specs``).

Model code names *logical* axes ("batch", "model", "seq", "expert", "vocab");
the topology maps them onto whatever mesh is active, or onto no mesh at all,
where every annotation is a no-op.

DP spans (pod, data); TP/EP/SP all live on the "model" axis, as in the
reference.

A :class:`Topology` over a :class:`repro_torch.compat.Mesh` (either kind of
rank group) is served: the model code's mesh paths run their regions
through :func:`repro_torch.compat.block_shard_map`. :func:`shard`, a GSPMD
placement constraint in the reference, is the identity in both: a value
outside a region is the whole global tensor (compat's global-value
contract), so a constraint that only places data changes nothing. A spec
is a :class:`repro_torch.compat.P`, the port's ``PartitionSpec``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

from repro_torch.compat import Mesh, P


@dataclasses.dataclass(frozen=True)
class Topology:
    mesh: Optional[Mesh]
    batch_axes: Tuple[str, ...] = ("data",)   # DP axes (pod folded in)
    model_axis: Optional[str] = "model"       # TP / EP / SP axis

    @property
    def dp(self):
        return self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]

    def _size(self, name: str) -> int:
        return self.mesh.shape[self.mesh.axis(name)]

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self._size(self.model_axis)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.batch_axes:
            n *= self._size(a)
        return n

    def spec(self, *logical: Optional[str]) -> P:
        """Translate logical axis names to a block spec."""
        out = []
        for name in logical:
            if name is None:
                out.append(None)
            elif name == "batch":
                out.append(self.dp)
            elif name in ("model", "seq", "expert", "vocab", "ff", "heads"):
                out.append(self.model_axis)
            else:
                raise ValueError(f"unknown logical axis {name!r}")
        return P(*out)


def _null_topology() -> Topology:
    return Topology(mesh=None, batch_axes=("data",), model_axis=None)


_current: contextvars.ContextVar[Topology] = contextvars.ContextVar(
    "repro_torch_topology", default=_null_topology()
)


def current_topology() -> Topology:
    return _current.get()


@contextlib.contextmanager
def use_topology(topo: Topology):
    if topo.mesh is not None and not isinstance(topo.mesh, Mesh):
        raise TypeError(f"a topology's mesh is a repro_torch.compat.Mesh, "
                        f"got {type(topo.mesh).__name__}")
    token = _current.set(topo)
    try:
        yield topo
    finally:
        _current.reset(token)


def make_topology(mesh: Optional[Mesh]) -> Topology:
    if mesh is None:
        return _null_topology()
    names = mesh.axis_names
    if "pod" in names:
        # pure-DP pod meshes (pod, data) carry no model axis
        model = "model" if "model" in names else None
        batch = ("pod", "data") if "data" in names else ("pod",)
        return Topology(mesh=mesh, batch_axes=batch, model_axis=model)
    if "model" in names:
        return Topology(mesh=mesh, batch_axes=("data",), model_axis="model")
    return Topology(mesh=mesh, batch_axes=tuple(names), model_axis=None)


def plan_spec(layout, axis_names, ndim: int = 1) -> P:
    """The block spec realising a collective plan's data layout.

    ``layout`` is anything with an ``order`` attribute (a
    :class:`repro_torch.offload.planner.PlanLayout` or ``CollectivePlan``).
    Dim 0 is split across the mesh axes named in ``axis_names`` *in the
    plan's logical order*: block ``i`` of a logical-rank-ordered value lands
    on the rank whose logical rank is ``i``."""
    order = tuple(layout.order)
    if len(order) != len(axis_names):
        raise ValueError(
            f"layout order {order!r} does not cover axes "
            f"{tuple(axis_names)!r}"
        )
    names = tuple(axis_names[i] for i in order)
    entry = names[0] if len(names) == 1 else names
    return P(entry, *([None] * (max(ndim, 1) - 1)))


def shard(x, *logical: Optional[str]):
    """A sharding constraint in logical axes: the identity, with a mesh or
    without (see the module docstring)."""
    return x
