"""Op-level FLOP, byte and collective accounting of a PyTorch program (the
port's counterpart of ``repro.roofline.hlo_cost``).

The reference parses the optimized XLA HLO of a compiled step. The port
runs the step once under :class:`CostMode`, a ``TorchDispatchMode`` that
prices every aten op it sees with the reference's rules (the reference's
names in brackets):

* **FLOPs.** Matmuls, convolutions and attention ops take
  ``torch.utils.flop_counter.flop_registry``'s formula, 2 x out x
  contraction (``_dot_flops``); an arithmetic or transcendental
  elementwise op 1 per result element (``_ARITH_1FLOP``,
  ``_TRANSCENDENTAL``; silu 2, a logistic and a multiply in the HLO); a
  reduction or scan 1 per input element (softmax 5); views, copies,
  factories, random ops and index moves none (``_ZERO_COST``).
* **HBM bytes**, the reference's fusion-adjusted traffic model
  (``_traffic_bytes``), so that fusing elementwise chains later moves no
  bound: an anchor (matmul, convolution, reduction, softmax, sort / topk,
  ``cat``, ``constant_pad_nd``) pays its operands and its result; an
  elementwise op, a copy (``clone``, ``_to_copy``, ``copy_`` into a whole
  tensor) or a filled factory its result only, so every intermediate is
  counted once, as its producer's output; a view nothing; a gather
  (``index``, ``gather``, ``index_select``, ``embedding``) twice its
  result, the reference's ``gather`` / ``dynamic-slice`` rule; a scatter
  (``index_put_``, ``slice_scatter``, ``scatter``, ``copy_`` into a view)
  twice its update, the ``dynamic-update-slice`` rule.
* **Charged regions** (:func:`charged`). A kernel entry of K1-K5 records
  one charge at its own analytic cost
  (:func:`repro_torch.roofline.analysis.kernel_cost`: bytes in plus bytes
  out, and the kernel's FLOPs), whichever implementation runs; a
  rank-group collective of :mod:`repro_torch.compat` records its wire
  bytes. The aten ops inside a region (the plain version's arithmetic, a
  co-resident fold) are not counted, so a plain version that repeats the
  arithmetic step by step costs what the kernel costs.

Loops need no trip count: every iteration dispatches its ops. An op with
a CompositeImplicitAutograd decomposition is counted as the ops it
decomposes into, as autograd dispatches it: under ``inference_mode`` such
ops (``einsum``, ``matmul``) reach the mode whole. The count is
of every op the program ran, on whichever device (the ``meta`` device runs
none and is counted the same). An op that none of the tables names costs
its result bytes and no FLOPs, as an unknown HLO op does in the
reference, and is tallied in :attr:`CostMode.unpriced`.

Collective wire bytes, per rank, under the ring model
(``hlo_cost.py``'s):

    all-reduce 2B(g-1)/g | all-gather, reduce-scatter, all-to-all B(g-1)/g
    | collective-permute B

where ``B`` is one rank's payload and ``g`` the group's size.

The charged-region state lives on the mode object, not in a thread-local:
autograd runs the backward (and ``torch.utils.checkpoint``'s
recomputation) on a thread of its own on CUDA, and the dispatch-mode stack
travels there with autograd's thread-local state.

This module imports only the standard library and torch, because the
kernel wrappers and :mod:`repro_torch.compat` import it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class Cost:
    """The reference's ``Cost``: FLOPs and HBM bytes of the work counted,
    collective wire bytes and counts per rank, by kind."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES}
    )
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES}
    )

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k in COLLECTIVES:
            self.coll_bytes[k] += other.coll_bytes[k] * mult
            self.coll_counts[k] += other.coll_counts[k] * mult

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


@dataclasses.dataclass(frozen=True)
class Charge:
    """One charged region: its kind (``"k1"``-``"k5"`` or a collective),
    what the caller said of its shape, and what it added to the count."""

    kind: str
    shape: Dict[str, Any]
    flops: float
    bytes: float


def wire_bytes(kind: str, payload: float, group: int) -> float:
    """Wire bytes a rank sends for one collective of ``payload`` bytes a
    rank over a group of ``group`` ranks (the ring model above)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    if group <= 1:
        return 0.0
    if kind == "collective-permute":
        return float(payload)
    frac = (group - 1) / group
    if kind == "all-reduce":
        return 2.0 * payload * frac
    return payload * frac


# ---------------------------------------------------------------------------
# The op tables (by aten op name; an in-place variant's trailing ``_`` is
# dropped first)
# ---------------------------------------------------------------------------

#: no FLOPs, no bytes: reads of metadata, aliases, allocations
_FREE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "detach", "lift_fresh", "alias", "set", "resize",
    "_assert_async", "_assert_tensor_metadata", "record_stream", "is_nonzero",
    "_has_compatible_shallow_copy_type", "_unsafe_view", "_reshape_alias",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "promote_types",
})
#: writes of an update into a buffer: twice the update's bytes
#: (argument index of the update)
_SCATTERS = {
    "index_put": 2, "_index_put_impl": 2, "index_add": 3, "index_copy": 3,
    "scatter": 3, "scatter_add": 3, "scatter_reduce": 3, "slice_scatter": 1,
    "select_scatter": 1, "diagonal_scatter": 1, "as_strided_scatter": 1,
    "masked_scatter": 2, "embedding_dense_backward": 0,
}
#: reads of rows by index: twice the result's bytes
_GATHERS = frozenset({"index", "gather", "index_select", "embedding", "take",
                      "masked_select"})
#: reductions and scans: FLOPs per input element (softmax's max, subtract,
#: exp, sum and divide as the reference's HLO has them), operands + result
_REDUCTIONS = {
    "sum": 1, "mean": 1, "nansum": 1, "prod": 1, "amax": 1, "amin": 1,
    "max": 1, "min": 1, "aminmax": 1, "argmax": 1, "argmin": 1, "any": 1,
    "all": 1, "var": 1, "std": 1, "var_mean": 1, "std_mean": 1, "norm": 1,
    "linalg_vector_norm": 1, "logsumexp": 1, "cumsum": 1, "cumprod": 1,
    "cummax": 1, "cummin": 1, "logcumsumexp": 1, "count_nonzero": 1,
    "_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 3,
    "_log_softmax_backward_data": 3, "nll_loss_forward": 1,
    "nll_loss_backward": 1, "native_layer_norm": 1,
    "native_layer_norm_backward": 1,
}
#: anchors without arithmetic: operands + result, no FLOPs (a slice's or
#: select's gradient is a pad of it)
_MOVING_ANCHORS = frozenset({"cat", "stack", "constant_pad_nd", "sort",
                             "topk", "repeat", "repeat_interleave", "flip",
                             "slice_backward", "select_backward"})
#: copies, filled factories and random draws: their result's bytes only
_WRITES = frozenset({
    "clone", "_to_copy", "copy", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_zeros", "new_ones", "new_full", "fill", "zero",
    "arange", "linspace", "scalar_tensor", "eye", "rand", "randn", "randint",
    "rand_like", "randn_like", "randint_like", "normal", "uniform",
    "bernoulli", "exponential", "random", "randperm", "tril_indices",
    "triu_indices",
})
#: pointwise ops of more than 1 FLOP an element: the reference's HLO
#: spells silu out as a logistic and a multiply
_PER_ELEMENT = {"silu": 2}

_POINTWISE = torch.Tag.pointwise
_REDUCTION = getattr(torch.Tag, "reduction", None)  # a newer tag


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in ``tree`` (nested tuples, lists and dicts), in no
    particular order."""
    found, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return found


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_COMPOSITE: Dict[Any, bool] = {}


def _composite(func) -> bool:
    """Has ``func`` a CompositeImplicitAutograd decomposition?"""
    got = _COMPOSITE.get(func)
    if got is None:
        got = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return got


def _name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


class CostMode(TorchDispatchMode):
    """Count every aten op dispatched under it (see the module docstring).

    ``cost`` is the count; ``charges`` the charged regions in order;
    ``unpriced`` the ops no table names, by name; ``peak_bytes`` the most
    result storage alive at once during the run (storage an op creates,
    released when the last tensor that views it dies), ``live_bytes`` what
    is alive now; ``by_op`` the FLOPs and bytes counted, by aten op name
    (charged regions under their kind). ``paused`` is the depth of charged
    regions open."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.cost = Cost()
        self.charges: List[Charge] = []
        self.unpriced: Dict[str, int] = {}
        self.by_op: Dict[str, List[float]] = {}
        self.paused = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        # storage key -> [bytes, tensors alive that view it]
        self._storages: Dict[int, List[int]] = {}

    # -- the dispatch hook --------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # under inference mode composite ops (einsum, matmul, ...) reach
            # the mode whole: count the ops they decompose into, as outside
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._track(args, out)
        if not self.paused:
            name = _name(func)
            flops, nbytes = self._price(func, name, args, kwargs, out)
            if flops or nbytes:
                self._add(name, flops, nbytes)
        return out

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        self.cost.flops += flops
        self.cost.bytes += nbytes
        tally = self.by_op.get(name)
        if tally is None:
            tally = self.by_op[name] = [0.0, 0.0]
        tally[0] += flops
        tally[1] += nbytes

    def _price(self, func, name, args, kwargs, out) -> Tuple[float, float]:
        if func.is_view or name in _FREE:
            return 0.0, 0.0
        outs = _tensors(out)
        out_b = sum(_nbytes(t) for t in outs)
        out_n = sum(t.numel() for t in outs)
        ins = _tensors((args, kwargs))
        anchor_b = out_b + sum(_nbytes(t) for t in ins)
        tags = func.tags
        formula = self._flops.get(func.overloadpacket)
        if formula is not None:
            return float(formula(*args, **kwargs, out_val=out)), anchor_b
        if name == "copy":
            dst, src = args[0], args[1]
            if dst._is_view():
                return 0.0, 2.0 * _nbytes(src)
            return 0.0, float(out_b)
        if name in _SCATTERS:
            i = _SCATTERS[name]
            upd = args[i] if len(args) > i else None
            if not isinstance(upd, torch.Tensor):
                upd = args[2] if name.startswith("scatter") else outs[0]
            return 0.0, 2.0 * _nbytes(upd)
        if name in _GATHERS:
            return 0.0, 2.0 * out_b
        # max(a, b) and min(a, b) are elementwise, not reductions
        pairwise = name in ("max", "min") and func._overloadname == "other"
        if not pairwise and (name in _REDUCTIONS or _REDUCTION in tags):
            in_n = args[0].numel() if isinstance(args[0], torch.Tensor) else 0
            return float(_REDUCTIONS.get(name, 1) * in_n), anchor_b
        if name in _MOVING_ANCHORS:
            return 0.0, anchor_b
        if name in _WRITES:
            return 0.0, float(out_b)
        if pairwise or _POINTWISE in tags:
            return float(_PER_ELEMENT.get(name, 1) * out_n), float(out_b)
        self.unpriced[name] = self.unpriced.get(name, 0) + 1
        return 0.0, float(out_b)

    # -- result storage alive ----------------------------------------------

    def _track(self, args, out) -> None:
        inputs = None
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            entry = self._storages.get(key)
            if entry is None:
                if inputs is None:
                    inputs = {a.untyped_storage()._cdata
                              for a in _tensors(args) if _has_storage(a)}
                if key in inputs:        # an argument's storage: not a result
                    continue
                entry = self._storages[key] = [st.nbytes(), 0]
                self.live_bytes += entry[0]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    # -- charged regions ----------------------------------------------------

    def charge(self, kind: str, shape: Dict[str, Any]) -> None:
        """Record one region of ``kind`` (see :func:`charged`)."""
        if kind in COLLECTIVES:
            payload = shape["payload"]
            # every rank present reads its payload and writes its result
            flops, nbytes = 0.0, 2.0 * payload * shape.get("ranks", 1)
            self.cost.coll_bytes[kind] += wire_bytes(kind, payload,
                                                     shape["group"])
            self.cost.coll_counts[kind] += 1
        else:
            from repro_torch.roofline.analysis import kernel_cost

            kc = kernel_cost(kind, **shape)
            flops, nbytes = kc.flops, kc.bytes
        self._add(kind, flops, nbytes)
        self.charges.append(Charge(kind, dict(shape), flops, nbytes))


def _has_storage(t: torch.Tensor) -> bool:
    try:
        t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return False
    return True


def active() -> Optional[CostMode]:
    """The innermost :class:`CostMode` on this thread's dispatch-mode
    stack, or None (one check when no mode is on the stack)."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostMode):
            return mode
    return None


class _Region:
    __slots__ = ("mode", "kind", "shape")

    def __init__(self, mode: CostMode, kind: str, shape: Dict[str, Any]):
        self.mode, self.kind, self.shape = mode, kind, shape

    def __enter__(self) -> None:
        if not self.mode.paused:
            self.mode.charge(self.kind, self.shape)
        self.mode.paused += 1

    def __exit__(self, *exc) -> None:
        self.mode.paused -= 1


_NULL = contextlib.nullcontext()


def charged(kind: str, /, **shape):
    """A region that counts as one ``kind`` under an active
    :class:`CostMode`, and stops the counting of the aten ops inside it; a
    region inside another records nothing. With no counter active it does
    nothing.

    ``kind`` is a kernel (``"k1"``-``"k5"``, priced by
    :func:`repro_torch.roofline.analysis.kernel_cost` from ``shape``) or
    one of :data:`COLLECTIVES` with ``payload`` (one rank's bytes),
    ``group`` (the group's size) and ``ranks`` (the rank rows the call
    holds: every rank of a co-resident mesh, 1 in a process)."""
    mode = active()
    if mode is None:
        return _NULL
    return _Region(mode, kind, shape)


def op_cost(fn: Callable, *args, **kw):
    """``(fn(*args, **kw), Cost)``: one run of ``fn`` under a
    :class:`CostMode` (the counterpart of ``hlo_cost(text,
    default_group)``; a collective's group comes from the mesh it names)."""
    with CostMode() as mode:
        out = fn(*args, **kw)
    return out, mode.cost
