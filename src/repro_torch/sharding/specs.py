"""Topology context: logical parallelism axes -> physical mesh axes (port of
``repro.sharding.specs``).

Model code names *logical* axes ("batch", "model", "seq", "expert", "vocab");
the topology maps them onto whatever mesh is active, or onto no mesh at all,
where every annotation is a no-op.

DP spans (pod, data); TP/EP/SP all live on the "model" axis, as in the
reference.

The port serves the null topology only. A :class:`Topology` over a
:class:`repro_torch.compat.Mesh` can be built and translates specs, but
entering it (:func:`use_topology`) raises ``NotImplementedError``: the model
code's mesh paths (explicit TP, the expert-parallel MoE region, the
sequence-parallel Mamba mixer, sequence-sharded decode attention) are the
next slice of the port, and a meshed topology must never quietly run the
local path in their place. A spec is a tuple of mesh-axis entries, the
port's ``PartitionSpec``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

#: what a meshed topology raises, naming where its paths come
MESH_PATHS_PENDING = (
    "the model code's mesh paths (explicit TP, the expert-parallel MoE "
    "region, the sequence-parallel Mamba mixer and sequence-sharded decode "
    "attention) are not ported yet: they are the next slice of the port "
    "(ROADMAP item 12b); only the null topology (mesh=None) is served"
)

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Topology:
    mesh: Optional[Any]
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

    def spec(self, *logical: Optional[str]) -> Spec:
        """Translate logical axis names to a spec (a tuple of entries)."""
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
        return tuple(out)


def _null_topology() -> Topology:
    return Topology(mesh=None, batch_axes=("data",), model_axis=None)


_current: contextvars.ContextVar[Topology] = contextvars.ContextVar(
    "repro_torch_topology", default=_null_topology()
)


def current_topology() -> Topology:
    return _current.get()


def require_local(what: str) -> None:
    """Raise ``NotImplementedError`` when the current topology has a mesh:
    ``what`` has only its local path in this port."""
    if current_topology().mesh is not None:
        raise NotImplementedError(f"{what}: {MESH_PATHS_PENDING}")


@contextlib.contextmanager
def use_topology(topo: Topology):
    if topo.mesh is not None:
        raise NotImplementedError(f"use_topology(mesh={topo.mesh!r}): "
                                  f"{MESH_PATHS_PENDING}")
    token = _current.set(topo)
    try:
        yield topo
    finally:
        _current.reset(token)


def make_topology(mesh: Optional[Any]) -> Topology:
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


def shard(x, *logical: Optional[str]):
    """A sharding constraint in logical axes: the identity without a mesh
    (the only topology this port serves); raises under a mesh."""
    require_local("shard")
    return x
