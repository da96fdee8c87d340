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
  ``dist.batch_isend_irecv`` (through host copies for CUDA leaves under
  gloo), and a rank with no in-edge gets zeros.

:func:`shard_map` binds the mesh's axis names for one call of ``fn``. Its
contract maps *rows*, not blocks: every input leaf carries a leading axis of
one row per rank in the order its spec names (first name major), and rank
``r`` sees its own row; every output leaf is stacked back the same way. A
caller with ``k`` rows per rank reshapes to ``(P, k, ...)`` first.

:func:`block_shard_map` is the reference's ``shard_map`` over block specs
(:class:`P`), the form the model code's mesh paths use. Its contract is the
**global value**: outside a region a value is the whole global tensor on
the mesh's device, in every process of a process group alike. Inside, each
leaf carries a leading axis ``R`` of rank rows: ``R = P`` for co-resident
ranks (row ``f`` is the block of the rank at flat mesh coordinate ``f``),
``R = 1`` for a process (its own block), so a region is written once over
``(R, ...)``.

The rank-group collectives :func:`psum`, :func:`pmax`, :func:`pmean` and
:func:`all_to_all` (``lax``'s) take one axis name or a tuple of names (one
group, first name major). A process builds them on ``ppermute``: ``p - 1``
cyclic shifts along each named axis bring it every group member's value,
then it combines them in group order ``0..p-1``. Co-resident ranks combine
the stacked rows directly in that same order, so the two kinds agree
bitwise.
"""

from __future__ import annotations

import contextlib
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
from repro_torch.roofline import op_cost

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
    (first name major). A spec names every mesh axis once; it may leave out
    an axis of size 1 (whose coordinate is always 0), as a reference spec
    over the surviving axes of a shrunken mesh does."""
    unnamed = [n for n in mesh.axis_names if n not in names]
    if (len(set(names)) != len(names)
            or any(n not in mesh.axis_names for n in names)
            or any(mesh.shape[mesh.axis(n)] != 1 for n in unnamed)):
        raise ValueError(
            f"a spec must name every mesh axis of more than one rank once; "
            f"got {names} for {mesh.axis_names} of {mesh.shape}"
        )
    coords = _coords(mesh, flat)
    row = 0
    for n in names:
        ax = mesh.axis(n)
        row = row * mesh.shape[ax] + coords[ax]
    return row


def own_rows(mesh: Mesh, spec: Spec) -> List[int]:
    """The rows of a leading axis split over ``spec`` (first name major)
    that this process holds: every row for co-resident ranks, its own for a
    process of a group."""
    names = _spec_names(spec)
    if mesh.coresident:
        _logical_index(mesh, 0, names)  # validates the spec
        return list(range(mesh.size))
    return [_logical_index(mesh, mesh.ranks.group_rank, names)]


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

    # the block form (:func:`block_shard_map`): leaves carry ``R`` rank rows

    #: rank rows a region's leaf carries (``R``)
    rows: int

    def combine(self, a: torch.Tensor, names: Tuple[str, ...],
                op: Callable) -> torch.Tensor:  # pragma: no cover
        """``op`` folded over the group's values in group order."""
        raise NotImplementedError

    def all_to_all(self, a: torch.Tensor, names: Tuple[str, ...],
                   split: int, concat: int) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def split_blocks(self, a: torch.Tensor,
                     dims: List[Tuple[str, ...]]) -> torch.Tensor:  # pragma: no cover
        """A global value as this group's ``(R, ...)`` rank rows."""
        raise NotImplementedError

    def join_blocks(self, a: torch.Tensor,
                    dims: List[Tuple[str, ...]]) -> torch.Tensor:  # pragma: no cover
        """``(R, ...)`` rank rows back into the global value."""
        raise NotImplementedError


class _CoResident(_RankGroup):
    rank_dims = 1

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self._index: Dict[Any, torch.Tensor] = {}

    def _cached(self, key, make):
        got = self._index.get(key)
        if got is None:
            # made outside inference mode: a cached index serves a serving
            # call under ``torch.inference_mode()`` and a training step alike
            with torch.inference_mode(False):
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
        def make():
            mesh = self.mesh
            rows = [_logical_index(mesh, f, names) for f in range(mesh.size)]
            return (None if rows == list(range(mesh.size))
                    else torch.tensor(rows, device=mesh.device))

        key = ("order", names)
        if key not in self._index:
            self._cached(key, make)
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

    @property
    def rows(self) -> int:
        return self.mesh.size

    def _by_group(self, a: torch.Tensor, names: Tuple[str, ...]):
        """``a``'s rows as ``(p, ...)``: the group's members in group order
        along dim 0, the other mesh axes (in mesh order) and the value
        after it; and how to put a value of that shape without dim 0 back
        as rows of every member."""
        mesh = self.mesh
        self._check(a)
        axes = [mesh.axis(n) for n in names]
        rest = a.shape[1:]
        v = a.reshape(mesh.shape + rest)
        v = torch.movedim(v, axes, list(range(len(axes))))
        others = v.shape[len(axes):]
        by_group = v.reshape((-1,) + others)

        def spread(r: torch.Tensor) -> torch.Tensor:
            for ax in sorted(axes):
                r = r.unsqueeze(ax)
            return r.expand(mesh.shape + rest).reshape(a.shape)

        return by_group, spread

    def combine(self, a, names, op):
        by_group, spread = self._by_group(a, names)
        acc = by_group[0]
        for j in range(1, by_group.shape[0]):
            acc = op(acc, by_group[j])
        return spread(acc)

    def all_to_all(self, a, names, split, concat):
        mesh = self.mesh
        self._check(a)
        rest = tuple(a.shape[1:])
        ls, lc = split - 1, concat - 1
        if ls < 0 or lc < 0:
            raise ValueError("all_to_all splits and concatenates the value's "
                             "own dims, not its rank rows (dim 0)")
        sizes = tuple(mesh.shape[mesh.axis(n)] for n in names)
        p = int(np.prod(sizes))
        if rest[ls] % p:
            raise ValueError(f"dim {split} of {tuple(a.shape)} does not split "
                             f"into {p} blocks")
        m, k = len(mesh.shape), len(names)
        # the split dim as (group coordinates..., chunk), then each group
        # axis swapped with its coordinate: a rank's split coordinates now
        # name the member whose chunk it holds
        v = a.reshape(mesh.shape + rest[:ls] + sizes + (rest[ls] // p,)
                      + rest[ls + 1:])
        perm = list(range(v.ndim))
        for i, n in enumerate(names):
            ax, sd = mesh.axis(n), m + ls + i
            perm[ax], perm[sd] = perm[sd], perm[ax]
        v = v.permute(perm)
        subs = [m + ls + i for i in range(k)]
        local = ([m + t for t in range(ls)] + [m + ls + k]
                 + [m + ls + k + 1 + t for t in range(len(rest) - ls - 1)])
        order = list(range(m)) + local[:lc] + subs + local[lc:]
        out = list(rest)
        out[ls] //= p
        out[lc] *= p
        return v.permute(order).reshape((self.mesh.size,) + tuple(out))

    def split_blocks(self, a, dims):
        return _blocks(self.mesh, a, dims)

    def join_blocks(self, a, dims):
        self._check(a)
        return _assemble(self.mesh, a, dims)


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

    def host_staged(self, leaves: Sequence[torch.Tensor]) -> bool:
        """Do point-to-point messages of ``leaves`` go through host copies?
        Gloo's send and receive take host memory only: given a CUDA tensor
        they read its device address as a host one and fail (``writev ...
        Bad address``, seen on an H100). NCCL takes device tensors."""
        import torch.distributed as dist

        return (any(a.device.type != "cpu" for a in leaves)
                and dist.get_backend(self.mesh.group) == "gloo")

    def ppermute(self, tree: PyTree, name: str, perm) -> PyTree:
        import torch.distributed as dist

        ax = self.mesh.axis(name)
        me = self.coords[ax]
        leaves, spec = tree_flatten(tree)
        staged = self.host_staged(leaves)
        wire = [a.cpu() for a in leaves] if staged else leaves
        outs = [torch.zeros_like(a, memory_format=torch.contiguous_format)
                for a in wire]  # gloo receives into contiguous buffers
        ops = []
        for s, d in perm:
            if s == me and d == me:
                outs = [a.clone() for a in wire]
            elif s == me:
                peer = self._peer(ax, d)
                ops += [dist.P2POp(dist.isend, a.contiguous(), peer,
                                   self.mesh.group) for a in wire]
            elif d == me:
                peer = self._peer(ax, s)
                ops += [dist.P2POp(dist.irecv, o, peer, self.mesh.group)
                        for o in outs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if staged:
            outs = [o.to(a.device) for o, a in zip(outs, leaves)]
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

    rows = 1

    def _gather(self, a: torch.Tensor, names: Tuple[str, ...]) -> List[torch.Tensor]:
        """Every group member's ``a``, in group order (first name major):
        ``p - 1`` cyclic shifts of :meth:`ppermute` along each named axis,
        the last name first."""
        vals = [a]
        for name in reversed(names):
            ax = self.mesh.axis(name)
            p, me = self.mesh.shape[ax], self.coords[ax]
            stacked = torch.stack(vals)
            got: List[Any] = [None] * p
            got[me] = stacked
            for s in range(1, p):
                got[(me - s) % p] = self.ppermute(
                    stacked, name, [(i, (i + s) % p) for i in range(p)])
            vals = [v for g in got for v in g.unbind(0)]
        return vals

    def _group_rank(self, names: Tuple[str, ...]) -> int:
        r = 0
        for n in names:
            ax = self.mesh.axis(n)
            r = r * self.mesh.shape[ax] + self.coords[ax]
        return r

    def combine(self, a, names, op):
        vals = self._gather(a, names)
        acc = vals[0]
        for v in vals[1:]:
            acc = op(acc, v)
        return acc

    def all_to_all(self, a, names, split, concat):
        vals = self._gather(a, names)
        p, me = len(vals), self._group_rank(names)
        if a.shape[split] % p:
            raise ValueError(f"dim {split} of {tuple(a.shape)} does not split "
                             f"into {p} blocks")
        return torch.cat([v.tensor_split(p, split)[me] for v in vals], concat)

    def split_blocks(self, a, dims):
        return _blocks(self.mesh, a, dims).narrow(0, self.group_rank, 1)

    def join_blocks(self, a, dims):
        import torch.distributed as dist

        parts = [torch.empty_like(a) for _ in range(self.mesh.size)]
        dist.all_gather(parts, a.contiguous(), group=self.mesh.group)
        return _assemble(self.mesh, torch.cat(parts), dims)


# ---------------------------------------------------------------------------
# Block specs (the reference's PartitionSpec over global values)
# ---------------------------------------------------------------------------


class P(tuple):
    """A block spec, the reference's ``PartitionSpec``: one entry per
    leading dim of a value, each ``None`` (not split), an axis name, or a
    tuple of names (split over their product, first name major); dims past
    the last entry are not split, and ``P()`` replicates the value."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _spec_dims(mesh: Mesh, spec: P, shape,
               whole: bool = True) -> List[Tuple[str, ...]]:
    """The axis names splitting each dim of a value of ``shape`` (a whole
    value, each named dim a multiple of its blocks; or one block)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} names {len(spec)} dims of a value "
                         f"of shape {tuple(shape)}")
    dims = [() if e is None else _spec_names(e) for e in spec]
    dims += [()] * (len(shape) - len(dims))
    used = [n for names in dims for n in names]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec!r} names an axis twice")
    for names, size in zip(dims, shape):
        blocks = int(np.prod([mesh.shape[mesh.axis(n)] for n in names]))
        if whole and size % blocks:
            raise ValueError(f"spec {spec!r}: a dim of {size} does not split "
                             f"into {blocks} blocks (shape {tuple(shape)})")
    return dims


def _blocks(mesh: Mesh, a: torch.Tensor, dims) -> torch.Tensor:
    """The global value ``a`` as ``(P, ...)`` rows, row ``f`` the block of
    the rank at flat mesh coordinate ``f``. A replicated value is a
    stride-0 ``expand`` of it, not a copy."""
    if not any(dims):
        return a.unsqueeze(0).expand((mesh.size,) + tuple(a.shape))
    split_shape, where, local = [], {}, []
    for names, size in zip(dims, a.shape):
        for n in names:
            where[n] = len(split_shape)
            split_shape.append(mesh.shape[mesh.axis(n)])
        local.append(len(split_shape))
        split_shape.append(size // int(np.prod(
            [mesh.shape[mesh.axis(n)] for n in names])))
    v = a.reshape(split_shape)
    order = []
    for n in mesh.axis_names:
        if n not in where:           # a stride-0 dim for an unnamed axis
            v = v.unsqueeze(-1)
            where[n] = v.ndim - 1
        order.append(where[n])
    v = v.permute(order + local)
    v = v.expand(mesh.shape + tuple(v.shape[len(order):]))
    return v.reshape((mesh.size,) + tuple(v.shape[len(order):]))


def _assemble(mesh: Mesh, rows: torch.Tensor, dims) -> torch.Tensor:
    """``(P, ...)`` rows back into the global value: the blocks of every
    named axis in place, the row of coordinate 0 along every axis ``dims``
    leaves unnamed."""
    local = tuple(rows.shape[1:])
    v = rows.reshape(mesh.shape + local)
    named = {n for names in dims for n in names}
    v = v[tuple(slice(None) if n in named else 0 for n in mesh.axis_names)]
    kept = [n for n in mesh.axis_names if n in named]
    order, shape = [], []
    for i, names in enumerate(dims):
        order += [kept.index(n) for n in names] + [len(kept) + i]
        shape.append(local[i] * int(np.prod(
            [mesh.shape[mesh.axis(n)] for n in names])))
    return v.permute(order).reshape(shape)


# ---------------------------------------------------------------------------
# The axis scope
# ---------------------------------------------------------------------------

_SCOPE = threading.local()


def _stack() -> List[Mesh]:
    stack = getattr(_SCOPE, "meshes", None)
    if stack is None:
        stack = _SCOPE.meshes = []
    return stack


def bound_meshes() -> Tuple[Mesh, ...]:
    """The meshes whose axis names are bound here, outermost first."""
    return tuple(_stack())


class bind_meshes:
    """Bind ``meshes`` (as :func:`bound_meshes` returned them) for a block:
    a recomputation that autograd runs after its region was left, or on its
    own thread, sees the axis names its forward saw."""

    def __init__(self, meshes: Sequence[Mesh]) -> None:
        self.meshes = tuple(meshes)

    def __enter__(self) -> None:
        stack = _stack()
        self.saved = list(stack)
        stack[:] = self.meshes

    def __exit__(self, *exc) -> None:
        _stack()[:] = self.saved


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


# ---------------------------------------------------------------------------
# Rank-group collectives and the block-spec shard_map
# ---------------------------------------------------------------------------


def _charged(kind: str, x: PyTree, axis_name: Spec):
    """One collective of ``kind`` over ``axis_name``'s group under a
    ``CostMode`` (:func:`repro_torch.roofline.op_cost.charged`): one rank's
    payload bytes and the group's size; the fold or row gather that carries
    it on co-resident ranks is no device arithmetic of the model's."""
    if op_cost.active() is None:
        return contextlib.nullcontext()
    mesh, names = _group(axis_name)
    ranks = mesh.size if mesh.coresident else 1
    total = sum(a.numel() * a.element_size() for a in tree_leaves(x))
    return op_cost.charged(
        kind, payload=total // ranks, ranks=ranks,
        group=int(np.prod([mesh.shape[mesh.axis(n)] for n in names])))


def ppermute(x: PyTree, axis_name: str, perm) -> PyTree:
    """``lax.ppermute``: ``(source, destination)`` pairs along one axis; a
    rank with no in-edge gets zeros. Counts as one collective-permute."""
    with _charged("collective-permute", x, axis_name):
        return mesh_of(axis_name).ranks.ppermute(x, axis_name, perm)


def _group(axis_name: Spec) -> Tuple[Mesh, Tuple[str, ...]]:
    names = _spec_names(axis_name)
    meshes = {id(mesh_of(n)): mesh_of(n) for n in names}
    if not names or len(meshes) != 1 or len(set(names)) != len(names):
        raise ValueError(f"axis names {names} must name distinct axes of one "
                         "bound mesh")
    return meshes.popitem()[1], names


def _combined(x: PyTree, axis_name: Spec, op: Callable) -> PyTree:
    mesh, names = _group(axis_name)
    with _charged("all-reduce", x, axis_name):
        return tree_map(lambda a: mesh.ranks.combine(a, names, op), x)


def psum(x: PyTree, axis_name: Spec) -> PyTree:
    """``lax.psum``: the sum over the group, added in group order. It, and
    :func:`pmax`, count as one all-reduce (:func:`pmean` as the psum and a
    divide)."""
    return _combined(x, axis_name, torch.add)


def pmax(x: PyTree, axis_name: Spec) -> PyTree:
    """``lax.pmax``: the elementwise maximum over the group."""
    return _combined(x, axis_name, torch.maximum)


def pmean(x: PyTree, axis_name: Spec) -> PyTree:
    """``lax.pmean``: :func:`psum` over the group's size."""
    mesh, names = _group(axis_name)
    p = int(np.prod([mesh.shape[mesh.axis(n)] for n in names]))
    return tree_map(lambda a: a / p, psum(x, axis_name))


def all_to_all(x: torch.Tensor, axis_name: Spec, split_axis: int,
               concat_axis: int, *, tiled: bool = True) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: dim ``split_axis`` splits into
    ``p`` blocks, block ``i`` goes to group member ``i``, and the blocks a
    member receives are concatenated along ``concat_axis`` in source order.
    Both axes count the dims of the value as the region holds it, its
    leading rank rows included (so never 0 inside :func:`block_shard_map`).
    Only the tiled form is ported."""
    if not tiled:
        raise NotImplementedError("all_to_all(tiled=False) is not ported")
    mesh, names = _group(axis_name)
    with _charged("all-to-all", x, axis_name):
        return mesh.ranks.all_to_all(x, names, split_axis, concat_axis)


def region_rows(axis_name: str) -> int:
    """``R``, the rank rows a :func:`block_shard_map` region's leaf carries
    under ``axis_name``'s mesh: every rank co-resident, 1 in a process."""
    return mesh_of(axis_name).ranks.rows


def axis_index_rows(axis_name: str, ndim: int) -> torch.Tensor:
    """:func:`axis_index` shaped to broadcast against a region's ``ndim``-d
    leaves (their rank rows leading)."""
    return axis_index(axis_name).reshape((-1,) + (1,) * (ndim - 1))


def _with_specs(fn: Callable, specs, tree) -> PyTree:
    """``fn(leaf, spec)`` over ``tree``; ``specs`` is a :class:`P` for the
    whole subtree, or a dict / tuple / list mirroring it."""
    if tree is None:
        return None
    if isinstance(specs, P):
        return tree_map(lambda a: fn(a, specs), tree)
    if isinstance(specs, dict):
        return {k: _with_specs(fn, specs[k], v) for k, v in tree.items()}
    if isinstance(specs, (tuple, list)):
        if len(specs) != len(tree):
            raise ValueError(f"{len(specs)} specs for {len(tree)} values")
        return type(tree)(_with_specs(fn, s, t) for s, t in zip(specs, tree))
    raise TypeError(f"a spec is a P or a dict/tuple/list of them, got {specs!r}")


def block_shard_map(
    fn: Callable[..., PyTree],
    mesh: Mesh,
    in_specs: Sequence[Any],
    out_specs: Any,
) -> Callable[..., PyTree]:
    """The reference's ``shard_map(fn, mesh, in_specs, out_specs,
    check_vma=False)`` over block specs (:class:`P`).

    Each argument is a global value on ``mesh``'s device (in every process
    of a process group); ``in_specs`` has one entry per argument, a
    :class:`P` for all its leaves or a dict / tuple / list of them; a
    ``None`` argument passes through. Each named dim splits into one block
    per coordinate of its axes, first name major. ``fn`` sees every leaf as
    ``(R, *block)`` rank rows (:func:`region_rows`), a replicated leaf as a
    stride-0 ``expand``, with the mesh's axis names bound. Each output leaf
    is joined back by ``out_specs``: the blocks of every named axis in
    place, the row of coordinate 0 along every axis the spec leaves
    unnamed (equal on every rank after a psum, as ``check_vma=False``
    assumes)."""
    in_specs = tuple(in_specs)
    ranks = mesh.ranks

    def enter(a: torch.Tensor, spec: P) -> torch.Tensor:
        if a.device != mesh.device:
            raise ValueError(f"a value on {a.device} for a mesh on "
                             f"{mesh.device}")
        return ranks.split_blocks(a, _spec_dims(mesh, spec, a.shape))

    def leave(a: torch.Tensor, spec: P) -> torch.Tensor:
        return ranks.join_blocks(a, _spec_dims(mesh, spec, a.shape[1:], False))

    def run(*args: PyTree) -> PyTree:
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             "in_specs")
        local = [_with_specs(enter, s, a) for s, a in zip(in_specs, args)]
        stack = _stack()
        stack.append(mesh)
        try:
            out = fn(*local)
        finally:
            stack.pop()
        return _with_specs(leave, out_specs, out)

    return run
