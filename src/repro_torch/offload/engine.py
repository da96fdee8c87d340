"""The offload engine: one descriptor in, one result out (PyTorch port of
``repro.offload.engine``).

This is the software analogue of the paper's NIC firmware loop. The NetFPGA
accepted a single self-describing packet (Fig. 1) and ran the whole collective
in hardware; here :class:`OffloadEngine` accepts a
:class:`~repro_torch.core.packet.CollectiveDescriptor` (or its encoded uint32
word vector straight off the wire), builds the described schedule once,
caches it keyed by the descriptor words, and dispatches every later identical
request straight from the cache, with hit/miss/latency telemetry standing in
for the paper's 8 ns on-NIC timer.

Three dispatch modes, as in the reference:

* **sim** (no ``axis_name``): the payload is a stacked ``(p, ...)`` tensor on
  the engine's device (a GPU unless the caller asks for the CPU);
* **spmd** (``axis_name``, no ``mesh``): the call runs per rank inside the
  caller's :func:`repro_torch.compat.shard_map`, untimed;
* **driver** (``axis_name`` and ``mesh``): the stacked payload goes in, and
  the engine wraps the per-rank schedule in its own ``shard_map`` over the
  mesh.

PyTorch runs eagerly, so a "compiled" schedule is the lowered callable.
Descriptors carrying a multi-axis topology
(``axes`` + ``split``) go through the collective planner, the pass pipeline
when the ``optimized`` flag is set, and the lowering-backend registry — where
``backend="pallas"`` selects the fused CUDA kernel — and cache under a
fingerprint of the plan, so descriptors whose plans converge share one
schedule.

:meth:`OffloadEngine.profile_offload` runs one dispatch under
``torch.profiler`` and feeds the device-side schedule time back into the
telemetry (``device_latency_by_coll_us``, the measured-on-device latency
source). Every dispatch opens ``engine`` spans (:mod:`repro_torch.obs.tracing`:
counted always, profiler ranges under a profiler); under a collecting tracer
a planned sim dispatch also runs the traced lowering (phase and round
spans). Every telemetry producer also publishes
into :mod:`repro_torch.obs.metrics` and :mod:`repro_torch.obs.events`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.core.operators import AssocOp, get_operator
from repro_torch.core.packet import (
    CollType,
    CollectiveDescriptor,
    WireDType,
    WireOp,
)
from repro_torch.core.reduce_ops import (
    allreduce_schedule,
    barrier_schedule,
    reduce_schedule,
)
from repro_torch.core.scan_collective import dist_exscan, dist_scan, sim_scan
from repro_torch.core.selector import select_algorithm
from repro_torch.core.trees import checked_device, tree_leaves
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.offload import planner
from repro_torch.runtime import chaos as runtime_chaos

PyTree = Any
#: one mesh axis name, or one per descriptor axis (planned requests)
AxisSpec = Optional["str | Sequence[str]"]

#: the coll kind each CollType tunes/selects against
COLL_KIND = {
    CollType.SCAN: "scan",
    CollType.EXSCAN: "exscan",
    CollType.REDUCE: "reduce",
    CollType.ALLREDUCE: "allreduce",
    CollType.BARRIER: "barrier",
}

_WIRE_OP_NAMES = {
    WireOp.SUM: "sum",
    WireOp.PROD: "prod",
    WireOp.MAX: "max",
    WireOp.MIN: "min",
    WireOp.SSD: "ssd",
    WireOp.FLASH: "flash",
}
_WIRE_OP_IDS = {v: k for k, v in _WIRE_OP_NAMES.items()}

_WIRE_DTYPES = {
    WireDType.INT32: torch.int32,
    WireDType.FLOAT32: torch.float32,
    WireDType.BFLOAT16: torch.bfloat16,
    WireDType.FLOAT16: torch.float16,
    WireDType.INT8: torch.int8,
}


def wire_op_name(op: WireOp) -> str:
    return _WIRE_OP_NAMES[WireOp(op)]


def wire_op_id(name: str) -> WireOp:
    try:
        return _WIRE_OP_IDS[name]
    except KeyError:
        raise ValueError(
            f"operator {name!r} has no wire id; known: {sorted(_WIRE_OP_IDS)}"
        ) from None


def wire_dtype(dt: WireDType) -> torch.dtype:
    return _WIRE_DTYPES[WireDType(dt)]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class _Meters:
    """The registry series a dispatch of one coll advances, bound to their
    labels (:meth:`~repro_torch.obs.metrics.Counter.child`) in the registry
    they were bound in."""

    registry: obs_metrics.MetricsRegistry
    hit: Callable[..., None]
    miss: Callable[..., None]
    dispatched: Callable[..., None]
    latency_us: Callable[[float], None]

    @classmethod
    def bind(cls, coll: str) -> "_Meters":
        reg = obs_metrics.get_registry()
        events = reg.counter(
            "repro_engine_cache_events_total",
            "compiled-schedule cache lookups",
            labelnames=("event",),
        )
        return cls(
            reg, events.child(event="hit"), events.child(event="miss"),
            reg.counter(
                "repro_engine_dispatches_total",
                "engine offload dispatches",
                labelnames=("coll",),
            ).child(coll=coll),
            reg.histogram(
                "repro_engine_dispatch_latency_us",
                "wall-clock latency of timed engine dispatches",
                labelnames=("coll",),
            ).child(coll=coll),
        )


@dataclasses.dataclass
class EngineTelemetry:
    """Counters the engine maintains per dispatch (the NIC status registers).

    Each producer also publishes into the shared metrics registry
    (:mod:`repro_torch.obs.metrics`) and, for fallbacks, the flight recorder
    (:mod:`repro_torch.obs.events`), under the reference's names.
    """

    hits: int = 0
    misses: int = 0
    dispatches: int = 0
    compiles: int = 0
    errors: int = 0
    calls_by_coll: Dict[str, int] = dataclasses.field(default_factory=dict)
    total_latency_s: float = 0.0
    last_latency_s: float = 0.0
    timed_dispatches: int = 0
    cache_size: int = 0
    cache_clears: int = 0
    latency_by_coll: Dict[str, Tuple[float, int]] = dataclasses.field(
        default_factory=dict
    )
    device_latency_by_coll: Dict[str, Tuple[float, int]] = dataclasses.field(
        default_factory=dict
    )
    latency_source_by_coll: Dict[str, str] = dataclasses.field(
        default_factory=dict
    )
    profiler_fallbacks: int = 0
    profiler_fallback_reasons: Dict[str, int] = dataclasses.field(
        default_factory=dict
    )
    backend_fallbacks: int = 0
    backend_fallback_reasons: Dict[str, int] = dataclasses.field(
        default_factory=dict
    )
    _meters: Dict[str, _Meters] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def meters(self, coll: str) -> _Meters:
        """The registry series of ``coll``, bound once in the registry in
        use (again once it was swapped)."""
        got = self._meters.get(coll)
        if got is None or got.registry is not obs_metrics.get_registry():
            got = self._meters[coll] = _Meters.bind(coll)
        return got

    def record_dispatch(self, coll: str, latency_s: Optional[float]) -> None:
        """One dispatch of ``coll``, timed when ``latency_s`` is given."""
        meters = self.meters(coll)
        self.dispatches += 1
        self.calls_by_coll[coll] = self.calls_by_coll.get(coll, 0) + 1
        meters.dispatched()
        if latency_s is not None:
            self.timed_dispatches += 1
            self.total_latency_s += latency_s
            self.last_latency_s = latency_s
            tot, n = self.latency_by_coll.get(coll, (0.0, 0))
            self.latency_by_coll[coll] = (tot + latency_s, n + 1)
            self.latency_source_by_coll.setdefault(coll, "wall")
            meters.latency_us(latency_s * 1e6)

    def record_device_latency(
        self, coll: str, latency_s: float, *, source: str = "profiler"
    ) -> None:
        """A per-schedule device timing from a profiler trace (or, when the
        trace could not be parsed, the wall fallback — labelled as such).
        The accumulated mean is never mixed-source: the first trace-derived
        sample evicts any wall fallbacks, and wall fallbacks never dilute a
        profiler-labelled mean."""
        prior = self.latency_source_by_coll.get(coll)
        if source == "profiler":
            if prior != "profiler":
                self.device_latency_by_coll.pop(coll, None)
            self.latency_source_by_coll[coll] = "profiler"
        elif prior == "profiler":
            return  # keep the device-only mean; drop the wall sample
        elif prior is None:
            self.latency_source_by_coll[coll] = source
        tot, n = self.device_latency_by_coll.get(coll, (0.0, 0))
        self.device_latency_by_coll[coll] = (tot + latency_s, n + 1)
        if source == "profiler":
            obs_metrics.get_registry().histogram(
                "repro_engine_device_latency_us",
                "profiler-derived device-side schedule latency",
                labelnames=("coll",),
            ).observe(latency_s * 1e6, coll=coll)

    def record_profiler_fallback(self, coll: str, reason: str) -> None:
        """A ``profile_offload`` run degraded to ``source="wall"`` — count
        it and the why, so dashboards can alert on profiler degradation
        instead of quietly trusting wall numbers."""
        self.profiler_fallbacks += 1
        self.profiler_fallback_reasons[reason] = (
            self.profiler_fallback_reasons.get(reason, 0) + 1
        )
        obs_metrics.get_registry().counter(
            "repro_engine_profiler_fallbacks_total",
            "profile_offload runs that fell back to wall-clock timing",
            labelnames=("coll", "reason"),
        ).inc(coll=coll, reason=reason)
        obs_events.record("profiler_fallback", coll=coll, reason=reason)

    def record_backend_fallback(self, coll: str, reason: str) -> None:
        """A descriptor named a lowering backend whose capability check
        missed for its plan, and the dispatch fell back to the registry
        default. Counted once per unique resolution, not per dispatch."""
        self.backend_fallbacks += 1
        self.backend_fallback_reasons[reason] = (
            self.backend_fallback_reasons.get(reason, 0) + 1
        )
        obs_metrics.get_registry().counter(
            "repro_engine_backend_fallbacks_total",
            "lowering-backend requests that fell back to the default",
            labelnames=("coll", "reason"),
        ).inc(coll=coll, reason=reason)
        obs_events.record("backend_fallback", coll=coll, reason=reason)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def mean_latency_s(self) -> float:
        return (
            self.total_latency_s / self.timed_dispatches
            if self.timed_dispatches
            else 0.0
        )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "dispatches": self.dispatches,
            "compiles": self.compiles,
            "errors": self.errors,
            "cache_size": self.cache_size,
            "cache_clears": self.cache_clears,
            "calls_by_coll": dict(self.calls_by_coll),
            "mean_latency_us": self.mean_latency_s * 1e6,
            "last_latency_us": self.last_latency_s * 1e6,
            "latency_by_coll_us": {
                coll: (tot / n) * 1e6 if n else 0.0
                for coll, (tot, n) in self.latency_by_coll.items()
            },
            "device_latency_by_coll_us": {
                coll: (tot / n) * 1e6 if n else 0.0
                for coll, (tot, n) in self.device_latency_by_coll.items()
            },
            "latency_source_by_coll": dict(self.latency_source_by_coll),
            "profiler_fallbacks": self.profiler_fallbacks,
            "profiler_fallback_reasons": dict(self.profiler_fallback_reasons),
            "backend_fallbacks": self.backend_fallbacks,
            "backend_fallback_reasons": dict(self.backend_fallback_reasons),
        }


@dataclasses.dataclass(frozen=True)
class CompiledSchedule:
    """A cache entry: the closure that runs one descriptor's collective."""

    key: bytes
    coll: str
    algo: str
    op_name: str
    p: int
    fn: Callable[[PyTree], PyTree]


#: the wire words' dtype, whose bytes key a prepared dispatch
_WORD = np.dtype(np.uint32)
#: prepared dispatches an engine keeps (the oldest makes room)
PREPARED_MAX = 256


class OffloadEngine:
    """Descriptor-driven collective dispatch with a compiled-schedule cache.

    The cache key is the encoded descriptor word vector with the per-rank
    fields (rank, msg_type) normalized away — every rank of a communicator,
    and every repeat offload, shares one schedule, which is exactly the
    "program the NIC once, stream requests" contract of the paper.

    A repeat sim-mode request skips the key's derivation too: once a
    dispatch of the same wire bytes (or descriptor object) and payload
    signature has succeeded, the next one finds its schedule in one lookup
    (:meth:`_reuse_key`; the span ``engine.reuse``). The memo holds at most
    :data:`PREPARED_MAX` entries.

    ``device`` defaults to ``"cuda"``; on a machine without CUDA that raises
    rather than quietly running on the CPU, so CPU runs pass
    ``device="cpu"``. Sim-mode payloads must already live on the engine's
    device; spmd and driver modes run on their mesh's device.
    """

    def __init__(self, device: "torch.device | str" = "cuda") -> None:
        self.device = checked_device(device, "OffloadEngine(device='cuda')")
        self._cache: Dict[bytes, CompiledSchedule] = {}
        # planned descriptors cache-key on the *optimized plan*, not the raw
        # words: _plan_memo maps normalized words -> plan; _fp_memo memoizes
        # the plan fingerprint per words; _plans stashes the plan under the
        # final key for _compile.
        self._plan_memo: Dict[bytes, Any] = {}
        self._fp_memo: Dict[Tuple[bytes, Tuple], bytes] = {}
        self._plans: Dict[bytes, Any] = {}
        # memoized lowering-backend resolution per (requested name, plan):
        # repeat dispatches neither re-run the capability check nor re-count
        # a fallback in telemetry
        self._backend_memo: Dict[Tuple[str, Any], Tuple] = {}
        # prepared sim-mode dispatches, keyed on the request as it came in
        # (its wire bytes, or the descriptor object) and the payload's
        # signature; written only after a full dispatch of the same request
        # and signature succeeded
        self._prepared: Dict[Tuple[Any, Any], CompiledSchedule] = {}
        self.telemetry = EngineTelemetry()

    # -- descriptor helpers ------------------------------------------------

    @staticmethod
    def _as_descriptor(
        descriptor: "CollectiveDescriptor | np.ndarray",
    ) -> CollectiveDescriptor:
        if isinstance(descriptor, CollectiveDescriptor):
            return descriptor
        return CollectiveDescriptor.decode(np.asarray(descriptor))

    @staticmethod
    def _mode_tag(axis_name: AxisSpec, mesh: Any = None) -> str:
        """The reference's mode string (part of every cache key): ``<sim>``,
        the axis name(s), or ``driver[shape@device-hash]|names``."""
        if axis_name is None:
            mode = "<sim>"
        elif isinstance(axis_name, str):
            mode = axis_name
        else:
            mode = "|".join(axis_name)
        if mesh is not None:
            shape = ",".join(
                f"{n}={s}" for n, s in zip(mesh.axis_names, mesh.devices.shape)
            )
            # rank identity matters: two same-shape meshes over different
            # (or reordered) ranks must not share a schedule
            devs = hashlib.blake2s(
                ",".join(
                    str(getattr(d, "id", d)) for d in mesh.devices.flat
                ).encode("utf-8")
            ).hexdigest()[:12]
            mode = f"driver[{shape}@{devs}]|{mode}"
        return mode

    @classmethod
    def _cache_key(
        cls, desc: CollectiveDescriptor, axis_name: AxisSpec = None,
        mesh: Any = None,
    ) -> bytes:
        normalized = desc.normalized()
        mode = cls._mode_tag(axis_name, mesh)
        return normalized.encode().tobytes() + b"|" + mode.encode("utf-8")

    def _plan_for(self, desc: CollectiveDescriptor):
        """The (optimized, when flagged) plan a multi-axis descriptor names
        plus its normalized wire words, memoized on those words."""
        words = desc.normalized().encode().tobytes()
        plan = self._plan_memo.get(words)
        if plan is None:
            itemsize = _itemsize(wire_dtype(desc.data_type))
            payload_bytes = max(1, int(desc.count)) * itemsize
            plan = planner.build_plan(
                desc.coll_type,
                desc.axes,
                get_operator(wire_op_name(desc.operation)),
                payload_bytes,
                order=desc.split,
                root=int(desc.root),
            )
            if desc.optimized:
                from repro_torch.offload import passes

                plan = passes.optimize_plan(plan)
            if desc.chunks > 1:
                # the descriptor's chunk word is authoritative: resolved at
                # make_descriptor time, never re-derived here
                plan = dataclasses.replace(plan, chunking=int(desc.chunks))
            self._plan_memo[words] = plan
        return plan, words

    def _resolve_backend(
        self, desc: CollectiveDescriptor, plan, axis_name: AxisSpec = None
    ) -> Tuple[str, Tuple]:
        """Resolve the descriptor's lowering-backend request through the
        registry for this plan and axis binding; returns ``(name,
        fingerprint_fields)``. Soft capability misses fall back to the mode
        default and are counted in telemetry exactly once per unique
        resolution."""
        names = None
        if axis_name is not None:
            names = (
                (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
            )
        memo_key = (desc.backend, plan, names)
        cached = self._backend_memo.get(memo_key)
        if cached is None:
            from repro_torch.offload import backends

            backend, reason = backends.resolve(desc.backend, plan, names)
            if reason:
                self.telemetry.record_backend_fallback(
                    desc.coll_type.name.lower(), reason
                )
            cached = (backend.name, backend.fingerprint())
            self._backend_memo[memo_key] = cached
        return cached

    def _planned_cache_key(
        self,
        words: bytes,
        plan,
        axis_name: AxisSpec = None,
        mesh: Any = None,
        backend_fields: Tuple = (),
    ) -> bytes:
        """Key a planned request on everything its lowering reads — the
        logical structure, the physical axis name of each logical level (in
        spmd/driver modes) and the backend fingerprint. The fields and their
        digest are the reference's, so the keys are byte-identical across
        the two packages."""
        names_l: Optional[Tuple[str, ...]] = None
        if axis_name is not None:
            names = (
                (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
            )
            if len(names) == len(plan.sizes):
                names_l = tuple(names[i] for i in plan.order)
            else:  # malformed; _compile raises with its clear error
                names_l = names
        digest = self._fp_memo.get((words, names_l, backend_fields))
        if digest is None:
            fields = (
                plan.coll.name,
                plan.op_name,
                plan.logical_sizes,
                plan.result,
                plan.optimized,
                names_l,
                tuple(
                    (
                        int(ph.kind), ph.level, ph.algorithm,
                        ph.inclusive, ph.root, ph.src, ph.dst, ph.dst2,
                        ph.guard_levels,
                    )
                    for ph in plan.phases
                ),
            )
            # chunked plans get an extra fingerprint field; C=1 keeps the
            # pre-chunking digest bit-for-bit (cache-key stability)
            if plan.chunking > 1:
                fields = fields + (("chunks", int(plan.chunking)),)
            # the default backend contributes no fields
            fields = fields + backend_fields
            digest = hashlib.blake2s(repr(fields).encode("utf-8")).digest()
            self._fp_memo[(words, names_l, backend_fields)] = digest
        mode = self._mode_tag(axis_name, mesh)
        return b"plan|" + digest + b"|" + mode.encode("utf-8")

    def make_descriptor(
        self,
        coll: "CollType | str",
        *,
        p: Optional[int] = None,
        payload_bytes: int,
        op: "AssocOp | str" = "sum",
        algorithm: str = "auto",
        comm_id: int = 0,
        root: int = 0,
        data_type: WireDType = WireDType.FLOAT32,
        count: Optional[int] = None,
        axes: Optional[Sequence[int]] = None,
        split: "str | Sequence[int]" = "auto",
        optimize: "str | bool" = "auto",
        chunks: "str | int" = "auto",
        backend: str = "auto",
    ) -> CollectiveDescriptor:
        """Build an offload request, resolving ``algorithm="auto"`` through
        the (tuning-table-aware) selector of the *requested* coll kind.

        With ``axes`` (2-3 mesh-axis sizes, outermost first), the request is
        a planned hierarchical collective: ``split="auto"`` asks the planner
        for the tuned logical axis order, and the resolved ``algo_type``
        names the innermost intra-phase schedule. ``optimize`` controls the
        plan-optimizer pass pipeline (``"auto"`` consults the measured
        winner / cost model; True/False force it). ``chunks`` is the
        chunked-streaming chunk count (``"auto"`` resolves through the
        schedule winner / pipelined cost model, an int forces it).
        ``backend`` names the lowering backend for planned requests:
        ``"auto"`` consults the tuner's measured winner (the default when
        untuned), ``"pallas"`` pins the fused kernel — subject to the soft
        capability fallback at compile time. Resolution is identical to the
        reference's, so the descriptor words are too.
        """
        if isinstance(coll, str):
            coll = CollType[coll.upper()]
        op = get_operator(op)
        if axes is not None:
            axes = tuple(int(a) for a in axes)
            if p is None:
                p = int(np.prod(axes))
        if p is None:
            raise ValueError("either p or axes is required")
        order: "tuple[int, ...]" = ()
        optimized = False
        chunk_count = 1
        backend_name = "" if backend == "auto" else str(backend)
        if axes is not None and len(axes) > 1:
            from repro_torch.offload import passes

            if backend == "auto":
                backend_name = passes.choose_backend(
                    coll, axes, payload_bytes, op
                )

            if optimize == "auto" and chunks == "auto":
                optimized, chunk_count = passes.choose_schedule(
                    coll, axes, payload_bytes, op
                )
            else:
                if optimize == "auto":
                    optimized = passes.choose_optimization(
                        coll, axes, payload_bytes, op
                    )
                else:
                    optimized = bool(optimize)
                if chunks == "auto":
                    plan = planner.build_plan(
                        coll, axes, op, payload_bytes, optimize=optimized
                    )
                    chunk_count = (
                        plan.chunking
                        if optimized
                        else passes.select_chunking(
                            plan, payload_bytes
                        ).chunking
                    )
                else:
                    chunk_count = int(chunks)
            order = (
                planner.plan_axis_order(
                    coll, axes, payload_bytes, op, optimize=optimized
                )
                if split == "auto"
                else tuple(int(i) for i in split)
            )
            if algorithm == "auto":
                # the innermost intra phase's schedule, for the wire field
                inner_p = axes[order[-1]]
                algorithm = select_algorithm(
                    inner_p, payload_bytes, op, coll=COLL_KIND[coll]
                )
        else:
            if chunks != "auto" and int(chunks) > 1:
                raise ValueError(
                    "chunked streaming requires a multi-axis (planned) "
                    f"request; got chunks={chunks} without axes"
                )
            if algorithm == "auto":
                algorithm = select_algorithm(
                    p, payload_bytes, op, coll=COLL_KIND[coll]
                )
        itemsize = _itemsize(wire_dtype(data_type))
        if count is None:
            count = max(1, payload_bytes // itemsize)
        elif count * itemsize != payload_bytes:
            raise ValueError(
                f"count={count} x {itemsize}B contradicts "
                f"payload_bytes={payload_bytes}"
            )
        return CollectiveDescriptor(
            comm_id=comm_id,
            comm_size=p,
            coll_type=coll,
            algo_type=algorithm,
            root=root,
            operation=wire_op_id(op.name),
            data_type=data_type,
            count=count,
            axes=axes if (axes is not None and len(axes) > 1) else (),
            split=order,
            optimized=optimized,
            chunks=chunk_count,
            backend=backend_name,
        )

    # -- dispatch ----------------------------------------------------------

    def offload(
        self,
        descriptor: "CollectiveDescriptor | np.ndarray",
        x: Optional[PyTree] = None,
        axis_name: AxisSpec = None,
        mesh: Any = None,
    ) -> PyTree:
        """Run the collective the descriptor describes; return its result.

        ``x`` is the per-rank contribution: a stacked ``(p, ...)`` pytree in
        sim and driver modes (leading axis in the plan's *logical* rank
        order), this rank's value inside :func:`repro_torch.compat.shard_map`
        in spmd mode. BARRIER ignores ``x``. For a planned multi-axis
        descriptor, ``axis_name`` is the tuple of physical mesh-axis names in
        descriptor ``axes`` order. Passing ``mesh`` (a
        :class:`repro_torch.compat.Mesh`, with ``axis_name``) selects driver
        mode: the engine wraps the schedule in its own ``shard_map``. Sim and
        driver dispatches are timed on the host clock, bracketed by
        ``torch.cuda.synchronize()`` on a GPU; spmd dispatches run inside
        the caller's program and are not timed.

        Every dispatch runs inside ``engine.offload`` and its children
        (``engine.prepare``, which holds ``engine.compile`` on a miss and
        ``engine.reuse`` on a prepared dispatch, ``engine.drain``,
        ``engine.schedule``, ``engine.wait``, ``engine.record``: spans of
        :mod:`repro_torch.obs.tracing`, counted always and ranges under a
        profiler).

        A sim-mode request repeated with a payload of the same signature
        is a prepared dispatch: the cached schedule runs without the
        descriptor's decode, key derivation and payload checks, which give
        the same result as before for such a request; telemetry, registry
        series and flight-recorder events read as after a full dispatch.
        A collecting tracer, a chaos scope, spmd or driver mode, a payload
        other than one tensor (or none), or another signature takes the
        full path. (Under a ``CostMode`` the schedule still charges each
        kernel it runs: what a prepared dispatch skips runs no aten op.)

        Only a collecting tracer changes what runs: planned
        *sim*-mode requests then take the traced lowering — cached under a
        separate key (``|traced``), so the untraced schedule is untouched —
        emitting one span per plan phase and one per communication round
        (K1's rounds split its phase evenly). Driver and spmd dispatches only
        get the spans around the dispatch.
        """
        with obs_tracing.span("engine.offload", "engine") as span:
            return self._offload(descriptor, x, axis_name, mesh, span)

    def _offload(
        self,
        descriptor: "CollectiveDescriptor | np.ndarray",
        x: Optional[PyTree],
        axis_name: AxisSpec,
        mesh: Any,
        span: Any,
    ) -> PyTree:
        collected = span.span_id is not None
        with obs_tracing.span("engine.prepare", "engine"):
            reuse = sched = None
            if not collected and axis_name is None and mesh is None:
                reuse = self._reuse_key(descriptor, x)
            if reuse is not None:
                sched = self._prepared.get(reuse)
            prepared = sched is not None
            if prepared:
                with obs_tracing.span("engine.reuse", "engine"):
                    self.telemetry.hits += 1
                    self.telemetry.meters(sched.coll).hit()
                cache_state, timed, device = "hit", True, self.device
            else:
                sched, cache_state, timed, device, x = self._prepare(
                    descriptor, x, axis_name, mesh, span, collected
                )

        if timed:
            on_gpu = device.type == "cuda"
            with obs_tracing.span("engine.drain", "engine"):
                if on_gpu:
                    torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with obs_tracing.span("engine.schedule", "engine"):
                out = sched.fn(x)
            with obs_tracing.span("engine.wait", "engine"):
                if on_gpu:
                    torch.cuda.synchronize(device)
            latency = time.perf_counter() - t0
        else:
            with obs_tracing.span("engine.schedule", "engine"):
                out = sched.fn(x)
            latency = None  # inside the caller's program: not timed
        with obs_tracing.span("engine.record", "engine"):
            self.telemetry.record_dispatch(sched.coll, latency)
            obs_events.record(
                "dispatch",
                coll=sched.coll,
                cache=cache_state,
                latency_us=None if latency is None else round(latency * 1e6, 1),
            )
        if reuse is not None and not prepared:
            self._remember(reuse, sched)
        return out

    def _reuse_key(
        self, descriptor: "CollectiveDescriptor | np.ndarray", x: Any,
    ) -> Optional[Tuple[Any, Any]]:
        """The memo key of a sim-mode request that may be prepared, or
        None: ``(request, payload signature)``, the request being the wire
        words' bytes (a 1-D uint32 array) or the descriptor object itself,
        the signature the one tensor's shape, dtype, device and
        contiguity, or None without a payload. A payload of any other form
        and a chaos scope (which must see each message) take the full
        path."""
        if type(x) is torch.Tensor:
            sig = (x.shape, x.dtype, x.device, x.is_contiguous())
        elif x is None:
            sig = None
        else:
            return None
        if type(descriptor) is np.ndarray:
            if descriptor.ndim != 1 or descriptor.dtype != _WORD:
                return None
            key = descriptor.tobytes()
        elif type(descriptor) is CollectiveDescriptor:
            key = descriptor
        else:
            return None
        if runtime_chaos.active():
            return None
        return key, sig

    def _remember(self, reuse: Tuple[Any, Any], sched: CompiledSchedule) -> None:
        """Prepare the request and signature ``reuse`` names, after their
        full dispatch succeeded; the oldest entry makes room."""
        if reuse not in self._prepared \
                and len(self._prepared) >= PREPARED_MAX:
            del self._prepared[next(iter(self._prepared))]
        self._prepared[reuse] = sched

    def _prepare(
        self,
        descriptor: "CollectiveDescriptor | np.ndarray",
        x: Optional[PyTree],
        axis_name: AxisSpec,
        mesh: Any,
        span: Any,
        collected: bool,
    ) -> Tuple[CompiledSchedule, str, bool, torch.device, Optional[PyTree]]:
        """The full path of ``engine.prepare``: decode, plan, key, cache
        lookup (and compile on a miss), payload checks. Returns ``(schedule,
        "hit" or "miss", timed, device, payload)``."""
        try:
            desc = self._as_descriptor(descriptor)
        except Exception:
            self.telemetry.errors += 1
            raise
        if axis_name is not None and not isinstance(axis_name, str):
            axis_name = tuple(axis_name) or None
        if mesh is not None and axis_name is None:
            raise ValueError("driver mode (mesh=...) requires axis_name")
        # planned sim requests run the traced lowering under a collecting
        # tracer; it lives under its own cache key so the untraced
        # schedule is never evicted or shadowed
        traced = collected and axis_name is None and mesh is None
        if len(desc.axes) > 1:
            try:
                plan, words = self._plan_for(desc)
            except Exception:
                self.telemetry.errors += 1
                raise
            _, bfields = self._resolve_backend(desc, plan, axis_name)
            key = self._planned_cache_key(
                words, plan, axis_name, mesh, backend_fields=bfields
            )
            if not traced and axis_name is None and mesh is None \
                    and runtime_chaos.active():
                # a chaos scope must see (and be able to fail) individual
                # messages, which a cached schedule would not expose:
                # route the dispatch onto the same traced lowering — and
                # the same cache key — the tracer uses (a fused-backend
                # descriptor still runs its kernel there, free of faults)
                traced = True
            if traced:
                key += b"|traced"
            self._plans.setdefault(key, plan)
        else:
            traced = False
            key = self._cache_key(desc, axis_name, mesh)
        if collected:
            span.set(
                coll=desc.coll_type.name.lower(),
                mode=self._mode_tag(axis_name, mesh),
                p=int(desc.comm_size),
                traced_plan=traced,
            )
        sched = self._cache.get(key)
        if sched is None:
            try:
                with obs_tracing.span(
                    "engine.compile", "engine",
                    coll=desc.coll_type.name.lower(),
                ):
                    sched = self._compile(
                        desc, key, axis_name, mesh, traced=traced
                    )
            except Exception:
                self.telemetry.errors += 1
                raise
            self._cache[key] = sched
            self.telemetry.misses += 1
            self.telemetry.compiles += 1
            self.telemetry.cache_size = len(self._cache)
            cache_state = "miss"
            if collected:
                span.set(cache="miss")
            self.telemetry.meters(sched.coll).miss()
            obs_events.record(
                "cache_miss", coll=sched.coll, scope="schedule"
            )
        else:
            self.telemetry.hits += 1
            cache_state = "hit"
            if collected:
                span.set(cache="hit")
            self.telemetry.meters(sched.coll).hit()

        timed = axis_name is None or mesh is not None
        device = self.device if mesh is None else mesh.device
        if desc.coll_type == CollType.BARRIER:
            if mesh is not None and x is None:
                x = torch.zeros((desc.comm_size,), device=device)
        elif timed:
            self._validate_payload(desc, x, device)
        return sched, cache_state, timed, device, x

    def profile_offload(
        self,
        descriptor: "CollectiveDescriptor | np.ndarray",
        x: Optional[PyTree] = None,
        *,
        axis_name: AxisSpec = None,
        mesh: Any = None,
        warmup: int = 1,
        trace_dir: Optional[str] = None,
    ):
        """Dispatch once under a ``torch.profiler`` trace and record the
        device-side schedule time into the telemetry. Returns a
        :class:`repro_torch.offload.profiling.DeviceTiming`. Pass
        ``trace_dir`` to keep the chrome trace on disk (e.g. for
        :func:`repro_torch.obs.export.merge_device_trace`).
        """
        from repro_torch.offload.profiling import profile_offload as _profile

        return _profile(
            self, descriptor, x, axis_name=axis_name, mesh=mesh,
            warmup=warmup, trace_dir=trace_dir,
        )

    def cache_size(self) -> int:
        return len(self._cache)

    def clear(self) -> None:
        # reset the gauge at clear time, and the plan memos: a retune can
        # change the per-phase algorithms a plan compiles to
        self._cache.clear()
        self._plan_memo.clear()
        self._fp_memo.clear()
        self._plans.clear()
        self._backend_memo.clear()
        self._prepared.clear()
        self.telemetry.cache_size = 0
        self.telemetry.cache_clears += 1

    # -- internals ---------------------------------------------------------

    def _validate_payload(
        self, desc: CollectiveDescriptor, x: PyTree, device: torch.device
    ) -> None:
        if x is None:
            raise ValueError(
                f"{desc.coll_type.name} offload requires a payload"
            )
        for leaf in tree_leaves(x):
            if leaf.ndim < 1 or leaf.shape[0] != desc.comm_size:
                raise ValueError(
                    "sim-mode payload leaves need a leading rank axis of "
                    f"comm_size={desc.comm_size}; got shape {tuple(leaf.shape)}"
                )
            if leaf.device != device:
                raise ValueError(
                    f"payload lives on {leaf.device} but the engine runs on "
                    f"{device}; move it explicitly"
                )

    def _compile(
        self,
        desc: CollectiveDescriptor,
        key: bytes,
        axis_name: AxisSpec = None,
        mesh: Any = None,
        *,
        traced: bool = False,
    ) -> CompiledSchedule:
        op = get_operator(wire_op_name(desc.operation))
        algo = desc.algo_type
        coll = desc.coll_type
        p = int(desc.comm_size)
        root = int(desc.root)
        if coll == CollType.REDUCE and not 0 <= root < p:
            raise ValueError(
                f"REDUCE root={root} out of range for comm_size={p}"
            )

        if len(desc.axes) > 1:
            fn, bname = self._build_planned(
                desc, op, axis_name, plan=self._plans.get(key),
                traced=traced,
            )
            algo = f"plan{desc.split}:{algo}"
            if desc.optimized:
                algo = f"opt:{algo}"
            if desc.chunks > 1:
                algo = f"chunk{desc.chunks}:{algo}"
            if bname is not None:
                # only non-default backends tag the schedule
                algo = f"{bname}:{algo}"
            if traced:
                algo = f"traced:{algo}"
        elif axis_name is not None:
            one = axis_name
            if not isinstance(one, str):
                if len(one) != 1:
                    raise ValueError(
                        f"descriptor has no multi-axis topology; pass one "
                        f"mesh axis name, not {one!r}"
                    )
                (one,) = one
            fn = self._build_spmd(coll, op, algo, one, root)
        else:
            fn = self._build_sim(coll, op, algo, p, root, self.device)
        if mesh is not None:
            fn = self._build_driver(desc, fn, axis_name, mesh)
        return CompiledSchedule(
            key=key,
            coll=coll.name.lower(),
            algo=algo,
            op_name=op.name,
            p=p,
            fn=fn,
        )

    @staticmethod
    def _build_driver(
        desc: CollectiveDescriptor,
        inner: Callable[[PyTree], PyTree],
        axis_name: AxisSpec,
        mesh: Any,
    ) -> Callable[[PyTree], PyTree]:
        """Wrap a per-rank schedule in the engine's own ``shard_map``.

        The payload is the sim-mode stacked ``(p, ...)`` contract with the
        leading axis in *logical* rank order; the spec splits it over the
        physical axes in the descriptor split's logical order (first name
        major), so rank r of the plan sees row r.
        """
        from repro_torch.compat import shard_map

        names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        missing = [n for n in names if n not in mesh.axis_names]
        if missing:
            raise ValueError(
                f"axes {missing} not in mesh axes {mesh.axis_names}"
            )
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        expect = desc.axes if len(desc.axes) > 1 else (desc.comm_size,)
        for n, want in zip(names, expect):
            if int(sizes[n]) != int(want):
                raise ValueError(
                    f"descriptor axis size {want} != mesh axis "
                    f"{n!r} size {sizes[n]}"
                )
        if len(desc.axes) > 1:
            order = desc.split or tuple(range(len(desc.axes)))
            names_l = tuple(names[i] for i in order)
        else:
            names_l = names
        return shard_map(inner, mesh, in_specs=(names_l,), out_specs=names_l)

    def _build_planned(
        self, desc: CollectiveDescriptor, op: AssocOp, axis_name: AxisSpec,
        plan, traced: bool = False,
    ) -> "Tuple[Callable[[PyTree], PyTree], Optional[str]]":
        """Lower a multi-axis descriptor through the lowering-backend
        registry; returns ``(fn, backend_tag)`` where the tag is the
        resolved backend's name for non-defaults and ``None`` when the mode
        default lowered the plan. ``traced`` builds the span-emitting sim
        lowering."""
        from repro_torch.offload import backends

        if plan is None:
            raise ValueError(
                "planned compile without a stashed plan; dispatch through "
                "offload(), which builds it via _plan_for"
            )
        if axis_name is not None and (
            isinstance(axis_name, str) or len(axis_name) != len(desc.axes)
        ):
            raise ValueError(
                f"planned descriptor spans axes {desc.axes}; pass one mesh "
                f"axis name per axis (got {axis_name!r})"
            )
        bname, _ = self._resolve_backend(desc, plan, axis_name)
        backend = backends.get_backend(bname)
        tag = (
            bname
            if bname != backends.default_backend_name(axis_name)
            else None
        )
        if axis_name is None:
            return backend.lower(
                plan, op, device=self.device, traced=traced
            ), tag
        return backend.lower(plan, op, axis_names=tuple(axis_name)), tag

    @staticmethod
    def _build_sim(
        coll: CollType, op: AssocOp, algo: str, p: int, root: int,
        device: torch.device,
    ) -> Callable[[PyTree], PyTree]:
        if coll == CollType.SCAN:
            return lambda x: sim_scan(x, op, p, algorithm=algo, inclusive=True)
        if coll == CollType.EXSCAN:
            return lambda x: sim_scan(
                x, op, p, algorithm=algo, inclusive=False
            )
        if coll == CollType.REDUCE:
            return lambda x: reduce_schedule(
                alg.SimBackend(p, device), x, op, root=root, algorithm=algo
            )
        if coll == CollType.ALLREDUCE:
            return lambda x: allreduce_schedule(
                alg.SimBackend(p, device), x, op, algorithm=algo
            )
        if coll == CollType.BARRIER:
            return lambda _x: barrier_schedule(
                alg.SimBackend(p, device), algorithm=algo
            )
        raise ValueError(f"unknown coll_type {coll!r}")

    @staticmethod
    def _build_spmd(
        coll: CollType, op: AssocOp, algo: str, axis_name: str, root: int
    ) -> Callable[[PyTree], PyTree]:
        if coll == CollType.SCAN:
            return lambda x: dist_scan(x, op, axis_name, algorithm=algo)
        if coll == CollType.EXSCAN:
            return lambda x: dist_exscan(x, op, axis_name, algorithm=algo)
        if coll == CollType.REDUCE:
            return lambda x: reduce_schedule(
                alg.SpmdBackend(axis_name), x, op, root=root, algorithm=algo
            )
        if coll == CollType.ALLREDUCE:
            return lambda x: allreduce_schedule(
                alg.SpmdBackend(axis_name), x, op, algorithm=algo
            )
        if coll == CollType.BARRIER:
            return lambda _x: barrier_schedule(
                alg.SpmdBackend(axis_name), algorithm=algo
            )
        raise ValueError(f"unknown coll_type {coll!r}")
