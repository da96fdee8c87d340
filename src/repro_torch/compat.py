"""Named rank axes for the per-rank (spmd) form: the port's ``shard_map``,
``axis_size`` and ``axis_index`` (counterpart of ``repro.compat``'s
``shard_map`` / ``axis_size`` and of ``jax.lax.axis_index``).

A :class:`Mesh` names the axes of a group of ranks. Two kinds of rank group
stand behind one interface:

* **co-resident** (``Mesh(shape, names, device=...)``): all ranks live on one
  device, the port's counterpart of a mesh of forced host devices. A per-rank
  value is a row of a stacked ``(P, ...)`` tensor (``P`` = every rank of the
  mesh, in row-major mesh order); ``axis_index`` is the rank column, a
  ``(P,)`` int32 tensor; a permute is a row gather with zero fill.
* **one rank per process** (``Mesh(shape, names, group=...)``): a
  ``torch.distributed`` group whose rank ``g`` sits at mesh coordinate
  ``unravel(g, shape)``. A per-rank value is the process's own tensor;
  ``axis_index`` is a 0-d int32 tensor; a permute is
  ``dist.batch_isend_irecv``, and a rank with no in-edge gets zeros.

:func:`shard_map` binds the mesh's axis names for one call of ``fn``. Its
contract maps *rows*, not blocks: every input leaf carries a leading axis of
one row per rank in the order its spec names (first name major), and rank
``r`` sees its own row; every output leaf is stacked back the same way. A
caller with ``k`` rows per rank reshapes to ``(P, k, ...)`` first.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.trees import (
    checked_device,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

PyTree = Any
Spec = "str | Sequence[str]"


class Mesh:
    """Named axes over a group of ranks.

    Either kind of group runs on the current CUDA device unless ``device``
    names another (``"cpu"`` for co-resident ranks on the CPU or a gloo
    group); without CUDA the default raises.

    ``devices`` is the rank id at each mesh coordinate (``np.ndarray`` of
    ``shape``): ``0..P-1`` for co-resident ranks, the global process ranks
    for a process group. The engine's driver-mode cache key hashes it, as
    the reference hashes its mesh's device ids.
    """

    def __init__(
        self,
        shape: Sequence[int],
        axis_names: Sequence[str],
        *,
        device: "torch.device | str | None" = None,
        group: Any = None,
    ) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(
                f"mesh shape {self.shape} and axis names {self.axis_names} "
                "differ in length"
            )
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")
        self.size = int(np.prod(self.shape, dtype=np.int64))
        self.group = group
        self.device = checked_device(
            "cuda" if device is None else device, "Mesh(device='cuda')"
        )
        if group is None:
            self.devices = np.arange(self.size).reshape(self.shape)
            self.ranks: "_RankGroup" = _CoResident(self)
        else:
            import torch.distributed as dist

            if dist.get_world_size(group) != self.size:
                raise ValueError(
                    f"process group of {dist.get_world_size(group)} ranks for "
                    f"a mesh of {self.size}"
                )
            self.devices = np.array(
                [_global_rank(group, g) for g in range(self.size)]
            ).reshape(self.shape)
            self.ranks = _PerProcess(self)

    @property
    def coresident(self) -> bool:
        return self.group is None

    def axis(self, name: str) -> int:
        try:
            return self.axis_names.index(name)
        except ValueError:
            raise ValueError(
                f"axis {name!r} not in mesh axes {self.axis_names}"
            ) from None


def _global_rank(group: Any, g: int) -> int:
    import torch.distributed as dist

    if group is None or group is dist.group.WORLD:
        return g
    return dist.get_global_rank(group, g)


def _coords(mesh: Mesh, flat: int) -> Tuple[int, ...]:
    return tuple(int(c) for c in np.unravel_index(flat, mesh.shape))


def _spec_names(spec: Spec) -> Tuple[str, ...]:
    return (spec,) if isinstance(spec, str) else tuple(spec)


def _logical_index(mesh: Mesh, flat: int, names: Tuple[str, ...]) -> int:
    """The row of rank ``flat`` in a leading axis split over ``names``
    (first name major)."""
    if sorted(names) != sorted(mesh.axis_names):
        raise ValueError(
            f"a spec must name every mesh axis once; got {names} for "
            f"{mesh.axis_names}"
        )
    coords = _coords(mesh, flat)
    row = 0
    for n in names:
        ax = mesh.axis(n)
        row = row * mesh.shape[ax] + coords[ax]
    return row


class _RankGroup:
    """What :class:`~repro_torch.core.algorithms.SpmdBackend` needs of a rank
    group: rank coordinates and one permutation with unique sources and
    destinations (``lax.ppermute``'s contract)."""

    mesh: Mesh
    #: leading dims a per-rank value carries beyond the rank's own shape
    rank_dims: int

    def axis_index(self, name: str) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def ppermute(self, tree: PyTree, name: str, perm) -> PyTree:  # pragma: no cover
        raise NotImplementedError

    def rank_ones(self, dtype: torch.dtype) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def enter(self, args: Sequence[PyTree], specs: Sequence[Spec]):  # pragma: no cover
        raise NotImplementedError

    def leave(self, out: PyTree, spec: Spec) -> PyTree:  # pragma: no cover
        raise NotImplementedError


class _CoResident(_RankGroup):
    rank_dims = 1

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self._index: Dict[Any, torch.Tensor] = {}

    def _cached(self, key, make):
        got = self._index.get(key)
        if got is None:
            got = make()
            self._index[key] = got
        return got

    def axis_index(self, name: str) -> torch.Tensor:
        mesh = self.mesh
        ax = mesh.axis(name)
        return self._cached(
            ("axis", name),
            lambda: torch.tensor(
                [_coords(mesh, f)[ax] for f in range(mesh.size)],
                dtype=torch.int32, device=mesh.device,
            ),
        )

    def _flat_pairs(self, name: str, perm) -> List[Tuple[int, int]]:
        """``perm`` along axis ``name`` as (source row, destination row)
        pairs over every rank of the mesh."""
        mesh = self.mesh
        ax = mesh.axis(name)
        stride = int(np.prod(mesh.shape[ax + 1:], dtype=np.int64))
        pairs = []
        for f in range(mesh.size):
            c = _coords(mesh, f)[ax]
            for s, d in perm:
                if s == c:
                    pairs.append((f, f + (d - c) * stride))
        return pairs

    def ppermute(self, tree: PyTree, name: str, perm) -> PyTree:
        # index tensors are made once per permutation: a repeat call copies
        # nothing from the host (as SimBackend keeps them)
        src, dst = self._cached(
            ("perm", name, tuple(map(tuple, perm))),
            lambda: torch.tensor(
                self._flat_pairs(name, perm), dtype=torch.int64,
                device=self.mesh.device,
            ).reshape(-1, 2).unbind(1),
        )

        def gather(a: torch.Tensor) -> torch.Tensor:
            out = torch.zeros_like(a)
            out[dst] = a[src]
            return out

        return tree_map(gather, tree)

    def rank_ones(self, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones((self.mesh.size,), dtype=dtype, device=self.mesh.device)

    def _order(self, names: Tuple[str, ...]) -> Optional[torch.Tensor]:
        """Row ``f`` of the stacked form is row ``order[f]`` of the spec's
        order; None when the two orders agree."""
        key = ("order", names)
        if key not in self._index:
            mesh = self.mesh
            rows = [_logical_index(mesh, f, names) for f in range(mesh.size)]
            self._index[key] = (
                None if rows == list(range(mesh.size))
                else torch.tensor(rows, device=mesh.device)
            )
        return self._index[key]

    def _check(self, a: torch.Tensor) -> None:
        if a.ndim < 1 or a.shape[0] != self.mesh.size:
            raise ValueError(
                f"leaves need a leading axis of one row per rank "
                f"({self.mesh.size}); got shape {tuple(a.shape)}"
            )
        if a.device != self.mesh.device:
            raise ValueError(
                f"payload lives on {a.device} but the mesh's ranks live on "
                f"{self.mesh.device}"
            )

    def enter(self, args, specs):
        out = []
        for arg, spec in zip(args, specs):
            order = self._order(_spec_names(spec))

            def leaf(a, order=order):
                self._check(a)
                return a if order is None else a.index_select(0, order)

            out.append(None if arg is None else tree_map(leaf, arg))
        return out

    def leave(self, out, spec):
        order = self._order(_spec_names(spec))
        if order is None:
            return out
        inverse = torch.empty_like(order)
        inverse[order] = torch.arange(order.numel(), device=order.device)
        return tree_map(lambda a: a.index_select(0, inverse), out)


class _PerProcess(_RankGroup):
    rank_dims = 0

    def __init__(self, mesh: Mesh) -> None:
        import torch.distributed as dist

        self.mesh = mesh
        self.group_rank = dist.get_rank(mesh.group)
        self.coords = _coords(mesh, self.group_rank)

    def axis_index(self, name: str) -> torch.Tensor:
        return torch.tensor(
            self.coords[self.mesh.axis(name)], dtype=torch.int32,
            device=self.mesh.device,
        )

    def _peer(self, ax: int, coord: int) -> int:
        c = list(self.coords)
        c[ax] = coord
        flat = int(np.ravel_multi_index(tuple(c), self.mesh.shape))
        return int(self.mesh.devices.flat[flat])

    def ppermute(self, tree: PyTree, name: str, perm) -> PyTree:
        import torch.distributed as dist

        ax = self.mesh.axis(name)
        me = self.coords[ax]
        leaves, spec = tree_flatten(tree)
        outs = [torch.zeros_like(a) for a in leaves]
        ops = []
        for s, d in perm:
            if s == me and d == me:
                outs = [a.clone() for a in leaves]
            elif s == me:
                peer = self._peer(ax, d)
                ops += [dist.P2POp(dist.isend, a.contiguous(), peer,
                                   self.mesh.group) for a in leaves]
            elif d == me:
                peer = self._peer(ax, s)
                ops += [dist.P2POp(dist.irecv, o, peer, self.mesh.group)
                        for o in outs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tree_unflatten(outs, spec)

    def rank_ones(self, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones((), dtype=dtype, device=self.mesh.device)

    def enter(self, args, specs):
        out = []
        for arg, spec in zip(args, specs):
            row = _logical_index(self.mesh, self.group_rank, _spec_names(spec))

            def leaf(a, row=row):
                if a.ndim < 1 or a.shape[0] != self.mesh.size:
                    raise ValueError(
                        f"leaves need a leading axis of one row per rank "
                        f"({self.mesh.size}); got shape {tuple(a.shape)}"
                    )
                return a[row]

            out.append(None if arg is None else tree_map(leaf, arg))
        return out

    def leave(self, out, spec):
        import torch.distributed as dist

        mesh = self.mesh
        names = _spec_names(spec)
        rows = [_logical_index(mesh, g, names) for g in range(mesh.size)]

        def gather(a: torch.Tensor) -> torch.Tensor:
            parts = [torch.empty_like(a) for _ in range(mesh.size)]
            dist.all_gather(parts, a.contiguous(), group=mesh.group)
            stacked = [None] * mesh.size
            for g, part in enumerate(parts):
                stacked[rows[g]] = part
            return torch.stack(stacked)

        return tree_map(gather, out)


# ---------------------------------------------------------------------------
# The axis scope
# ---------------------------------------------------------------------------

_SCOPE = threading.local()


def _stack() -> List[Mesh]:
    stack = getattr(_SCOPE, "meshes", None)
    if stack is None:
        stack = _SCOPE.meshes = []
    return stack


def mesh_of(axis_name: str) -> Mesh:
    """The innermost bound mesh that names ``axis_name`` (raises outside a
    :func:`shard_map` that binds it)."""
    for mesh in reversed(_stack()):
        if axis_name in mesh.axis_names:
            return mesh
    raise NameError(
        f"unbound axis name {axis_name!r}: call inside shard_map over a mesh "
        "that names it"
    )


def axis_size(axis_name: str) -> int:
    """Static size of a named mesh axis, from inside :func:`shard_map`."""
    mesh = mesh_of(axis_name)
    return mesh.shape[mesh.axis(axis_name)]


def axis_index(axis_name: str) -> torch.Tensor:
    """This rank's coordinate along ``axis_name``: a ``(P,)`` int32 tensor
    for co-resident ranks, a 0-d one for a process."""
    return mesh_of(axis_name).ranks.axis_index(axis_name)


def rank_dims(axis_name: str) -> int:
    """Leading dims a per-rank value carries under ``axis_name``'s mesh: 1
    for co-resident ranks (the stacked row axis), 0 for a process."""
    return mesh_of(axis_name).ranks.rank_dims


def per_rank_bytes(tree: PyTree, axis_name: str) -> int:
    """Payload bytes of ONE rank's value (the selector's and planner's
    ``payload_bytes``) under ``axis_name``'s mesh, in either kind of group."""
    total = sum(a.numel() * a.element_size() for a in tree_leaves(tree))
    mesh = mesh_of(axis_name)
    return total // mesh.size if mesh.coresident else total


def shard_map(
    fn: Callable[..., PyTree],
    mesh: Mesh,
    in_specs: Sequence[Spec],
    out_specs: Spec,
) -> Callable[..., PyTree]:
    """Run ``fn`` per rank with ``mesh``'s axis names bound.

    ``in_specs`` has one entry per positional argument: an axis name, or a
    tuple of names (first major), naming how the argument's leading axis is
    split one row per rank; a ``None`` argument passes through. ``out_specs``
    does the same for every output leaf. The whole call stays on ``mesh``'s
    device; nothing is timed or synchronized here.
    """
    in_specs = tuple(in_specs)

    def run(*args: PyTree) -> PyTree:
        if len(args) != len(in_specs):
            raise ValueError(
                f"{len(args)} arguments for {len(in_specs)} in_specs"
            )
        local = mesh.ranks.enter(args, in_specs)
        stack = _stack()
        stack.append(mesh)
        try:
            out = fn(*local)
        finally:
            stack.pop()
        return mesh.ranks.leave(out, out_specs)

    return run
