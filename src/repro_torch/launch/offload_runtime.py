"""Launch-time construction of the offload engine + tuning-table plumbing
(port of ``repro.launch.offload_runtime``).

The port's tables, env names and cache live apart from the reference's:
the default table is ``$REPRO_TORCH_CACHE_DIR/tuning_table.json`` (default
directory ``~/.cache/repro_torch``), read or written only when a launch
asks for it, never the reference's ``~/.cache/repro``; the ambient table is
``$REPRO_TORCH_TUNING_TABLE``, tracing ``$REPRO_TORCH_TRACE``, the registry
``$REPRO_TORCH_TUNING_REGISTRY``. A table's fingerprint names a torch
device, so a JAX table is never loaded. Every entry point takes ``device``:
the card unless the caller names another.

Every launcher that issues collective descriptors goes through here:

  * :func:`build_offload_engine` loads (or, on request, generates) the tuning
    table for the current backend, activates it underneath
    ``select_algorithm``, and returns a ready :class:`OffloadEngine` — the
    process-wide "NIC". Ambient tables (``$REPRO_TORCH_TUNING_TABLE`` or the
    default cache path) are backend-fingerprint-checked and ignored with a
    warning on mismatch; an explicitly passed path is trusted verbatim.
  * The engine is wired to ``runtime.fault``: when a shrunken mesh is
    *adopted* (the trainer's recovery path fires ``fault.notify_remesh``),
    the registered listener clears the engine's compiled-plan cache (plans
    key on axis sizes) and runs a budgeted re-tune
    (``autotune(time_budget_s=...)``) on the surviving topology, hot-swapping
    the active tuning table. Disable with ``retune_on_remesh=False``; detach
    a built engine's hook with :func:`detach_remesh_hook`.
  * :func:`build_offload_service` stacks the multi-tenant
    :class:`~repro_torch.service.DescriptorBroker` on top of the engine (service
    mode): many client streams, coalesced dispatches, per-tenant telemetry,
    and a shared tuning-table registry — a fresh tune (or an ambient table)
    is *published* to the registry so every worker pointing at the same
    registry directory (``$REPRO_TORCH_TUNING_REGISTRY`` / ``--registry``)
    inherits the merged winners instead of re-measuring.
  * ``python -m repro_torch.launch.offload_runtime --tune`` is the operator-facing
    way to produce a tuning table once (including the planner's axis-split
    winners via ``--splits``) and reuse it across launches via
    ``$REPRO_TORCH_TUNING_TABLE``; add ``--registry DIR`` to also merge it into a
    shared registry keyed by backend fingerprint.
  * Observability: ``build_offload_engine(tracing=True)`` (or
    ``$REPRO_TORCH_TRACE=1``) installs a collecting span tracer
    (:mod:`repro_torch.obs.tracing`) before the engine is built, so every
    dispatch in the launch emits broker/engine/phase/round spans; and
    ``python -m repro_torch.launch.offload_runtime --trace OUT.json`` runs one
    traced+profiled smoke dispatch and writes the merged host+device
    Perfetto trace — the quickest way to *see* where a round's time goes
    (open the file at https://ui.perfetto.dev).
  * Operations: ``--dashboard`` runs a smoke dispatch through
    engine+broker+health monitor and prints the text dashboard
    (:mod:`repro_torch.obs.dashboard`); ``--serve PORT`` exposes ``/healthz``,
    ``/metrics``, ``/events`` over HTTP; ``--flight-record OUT.json``
    dumps the always-on flight recorder (:mod:`repro_torch.obs.events`) at run
    end and arms the crash/recovery auto-dump.
"""

from __future__ import annotations

import argparse
import os
import weakref
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from repro_torch.obs import events as obs_events
from repro_torch.offload import (
    TUNING_TABLE_ENV,
    OffloadEngine,
    TuningCache,
    autotune,
    tune_splits,
)
from repro_torch.core.trees import checked_device
from repro_torch.runtime import fault

CACHE_DIR_ENV = "REPRO_TORCH_CACHE_DIR"


def cache_dir() -> Path:
    """``$REPRO_TORCH_CACHE_DIR``, or ``~/.cache/repro_torch``."""
    return Path(os.environ.get(CACHE_DIR_ENV)
                or os.path.expanduser("~/.cache/repro_torch"))


def default_table_path() -> Path:
    """The port's default tuning table: ``cache_dir()/tuning_table.json``."""
    return cache_dir() / "tuning_table.json"

_ENGINE: Optional[OffloadEngine] = None


def _remesh_ps(new_axes: Tuple[int, ...]) -> Tuple[int, ...]:
    """The (p) grid worth re-measuring after a re-mesh: every surviving axis
    size plus the flat total, doubles included up to the total."""
    total = 1
    for s in new_axes:
        total *= max(1, int(s))
    ps = {int(s) for s in new_axes if int(s) > 1}
    p = 2
    while p <= total:
        ps.add(p)
        p *= 2
    if total > 1:
        ps.add(total)
    return tuple(sorted(ps)) or (2,)


# One module-level listener serves every engine: a re-mesh clears each live
# engine's plan cache but runs the budgeted re-tune exactly once (the tuning
# table is process-global state), under the largest budget any live engine
# asked for. Engines are held by weakref so subscribing never extends their
# lifetime.
_HOOKED_ENGINES: List[Tuple["weakref.ref[OffloadEngine]", float]] = []


def _on_remesh(old_axes, new_axes):
    alive = []
    device = None
    for ref, budget_s in _HOOKED_ENGINES:
        engine = ref()
        if engine is not None:
            # stale on two levels: compiled plans key on the old axis sizes,
            # and the active table was measured on the old (p, payload) grid
            engine.clear()
            alive.append((ref, budget_s))
            device = device or engine.device
    _HOOKED_ENGINES[:] = alive
    if not alive:
        fault.unregister_remesh_listener(_on_remesh)
        return
    budget_s = max(b for _, b in alive)
    obs_events.record(
        "retune", axes=tuple(int(a) for a in new_axes), budget_s=budget_s
    )
    cache = autotune(
        ps=_remesh_ps(tuple(new_axes)),
        payloads=(1024, 65536),
        iters=2,
        time_budget_s=budget_s,
        device=device,
    )
    cache.activate()


def _attach_remesh_hook(
    engine: OffloadEngine, tune_budget_s: float
) -> OffloadEngine:
    if not _HOOKED_ENGINES:
        fault.register_remesh_listener(_on_remesh)
    else:  # drop entries for engines that were garbage-collected
        _HOOKED_ENGINES[:] = [
            (ref, b) for ref, b in _HOOKED_ENGINES if ref() is not None
        ]
    _HOOKED_ENGINES.append((weakref.ref(engine), float(tune_budget_s)))
    return engine


def detach_remesh_hook(engine: OffloadEngine) -> None:
    """Unsubscribe an engine built with ``retune_on_remesh=True``."""
    _HOOKED_ENGINES[:] = [
        (ref, b) for ref, b in _HOOKED_ENGINES
        if ref() is not None and ref() is not engine
    ]
    if not _HOOKED_ENGINES:
        fault.unregister_remesh_listener(_on_remesh)


TRACE_ENV = "REPRO_TORCH_TRACE"


def build_offload_engine(
    *,
    tuning_table: "str | Path | None" = None,
    autotune_if_missing: bool = False,
    tune_budget_s: float = 30.0,
    retune_on_remesh: bool = True,
    remesh_tune_budget_s: float = 5.0,
    tracing: Optional[bool] = None,
    device: "torch.device | str | None" = None,
) -> OffloadEngine:
    """Construct the launch's engine on ``device`` (the card unless the
    caller names another), with the tuning table resolved from (in order):
    the explicit argument (which must exist), ``$REPRO_TORCH_TUNING_TABLE``,
    the default cache path (:func:`default_table_path`), or — when
    ``autotune_if_missing`` — a fresh budgeted tuning run persisted to the
    default path for the next launch. An ambient table (the env var's or the
    default path's) measured on another device is ignored with a warning.

    ``tracing=True`` (default: on when ``$REPRO_TORCH_TRACE`` is a non-empty
    value other than ``0``) installs a process-wide collecting span tracer
    before the engine is built; read it back with
    :func:`repro_torch.obs.tracing.get_tracer` and export via
    :mod:`repro_torch.obs.export`. The default no-op tracer costs nothing.
    """
    device = checked_device("cuda" if device is None else device,
                            "build_offload_engine(device='cuda')")
    if tracing is None:
        tracing = os.environ.get(TRACE_ENV, "") not in ("", "0", "false")
    if tracing:
        from repro_torch.obs import tracing as obs_tracing

        if not obs_tracing.get_tracer().enabled:
            obs_tracing.install_tracer()
    cache: Optional[TuningCache] = None
    if tuning_table:
        # An explicitly named table must exist: silently falling through to
        # a different (or no) table would tune against the wrong cost model.
        if not Path(tuning_table).exists():
            raise FileNotFoundError(
                f"tuning table {str(tuning_table)!r} does not exist"
            )
        cache = TuningCache.load(tuning_table)
    elif os.environ.get(TUNING_TABLE_ENV):
        env_path = os.environ[TUNING_TABLE_ENV]
        if not Path(env_path).exists():
            raise FileNotFoundError(
                f"tuning table {env_path!r} (from ${TUNING_TABLE_ENV}) "
                "does not exist"
            )
        cache = TuningCache.load_compatible(env_path, device=device)
    elif default_table_path().exists():
        cache = TuningCache.load_compatible(default_table_path(),
                                            device=device)
    if cache is None and autotune_if_missing:
        # also the recovery path for an ambient table the fingerprint check
        # rejected: the caller asked for a usable table, so measure one
        cache = autotune(
            ps=(2, 4, 8),
            payloads=(1024, 65536),
            iters=3,
            time_budget_s=tune_budget_s,
            device=device,
        )
        cache.save(default_table_path())
    if cache is not None:
        cache.activate()
    engine = OffloadEngine(device)
    if retune_on_remesh:
        _attach_remesh_hook(engine, remesh_tune_budget_s)
    return engine


def get_engine() -> OffloadEngine:
    """Process-wide engine singleton (built lazily on first use)."""
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = build_offload_engine()
    return _ENGINE


_SERVICE = None


def build_offload_service(
    *,
    axis_name=None,
    mesh=None,
    registry: "object | str | Path | None" = None,
    publish_active_table: bool = True,
    flush_interval_s: float = 0.002,
    max_coalesce: int = 64,
    max_pending: int = 1024,
    max_tenants: int = 64,
    start: bool = True,
    **engine_kw,
):
    """Service mode: a started :class:`~repro_torch.service.DescriptorBroker`
    front end over a freshly built engine.

    The registry resolves from (in order): the explicit argument (a registry
    object or a directory path), ``$REPRO_TORCH_TUNING_REGISTRY``, the default
    cache-dir registry. The broker fetches the registry's merged table for
    this backend and activates it; when ``publish_active_table`` and this
    process also tuned (or loaded) its own table, that table is merged back
    in, so workers converge on one pod-wide table instead of each keeping a
    private one.
    """
    from repro_torch.core.selector import get_active_tuning
    from repro_torch.service import DescriptorBroker, FileTuningRegistry
    from repro_torch.service.registry import default_registry

    if registry is None:
        registry = default_registry() or FileTuningRegistry(
            cache_dir() / "tuning_registry"
        )
    elif isinstance(registry, (str, Path)):
        registry = FileTuningRegistry(registry)
    engine = build_offload_engine(**engine_kw)
    active = get_active_tuning()
    if publish_active_table and isinstance(active, TuningCache):
        registry.publish(active)
    broker = DescriptorBroker(
        engine,
        axis_name=axis_name,
        mesh=mesh,
        flush_interval_s=flush_interval_s,
        max_coalesce=max_coalesce,
        max_pending=max_pending,
        max_tenants=max_tenants,
        registry=registry,
    )
    return broker.start() if start else broker


def get_service():
    """Process-wide broker singleton (sim-mode engine, default registry)."""
    global _SERVICE
    if _SERVICE is None:
        _SERVICE = build_offload_service()
    return _SERVICE


def write_traced_smoke_trace(
    out: "str | Path",
    *,
    axes: Tuple[int, ...] = (2, 4),
    payload_floats: int = 256,
    coll: str = "scan",
    device: "torch.device | str | None" = None,
) -> Path:
    """Run one traced + profiled smoke dispatch and write the merged
    host+device Perfetto trace to ``out``. The attribution workflow's
    one-command entry point (see README's Observability section)."""
    import math as _math
    import tempfile

    from repro_torch.obs import export as obs_export
    from repro_torch.obs import tracing as obs_tracing

    engine = OffloadEngine("cuda" if device is None else device)
    desc = engine.make_descriptor(
        coll, axes=tuple(axes), payload_bytes=payload_floats * 4, op="sum"
    )
    p = _math.prod(axes)
    x = torch.arange(p * payload_floats, dtype=torch.float32,
                     device=engine.device).reshape(p, payload_floats)
    with tempfile.TemporaryDirectory() as td:
        with obs_tracing.tracing() as tracer:
            timing = engine.profile_offload(desc, x, trace_dir=td)
        host = obs_export.spans_to_chrome(tracer.spans())
        if timing.trace_path is not None:
            merged = obs_export.merge_device_trace(host, timing.trace_path)
        else:
            merged = host
        path = obs_export.write_trace(out, merged)
    n_spans = len(tracer.spans())
    print(
        f"traced {coll} over {tuple(axes)}: {n_spans} host spans, "
        f"{merged.get('deviceEventsMerged', 0)} device events "
        f"(aligned={merged.get('deviceClockAligned', False)}, "
        f"device source={timing.source})"
    )
    print(f"merged trace written to {path} — open at https://ui.perfetto.dev")
    return path


def run_dashboard_smoke(
    *, axes: Tuple[int, ...] = (2, 4), payload_floats: int = 256,
    device: "torch.device | str | None" = None,
) -> None:
    """Drive a few dispatches through an engine + broker + health monitor
    and print the text dashboard — the ``--dashboard`` entry point."""
    from repro_torch.obs import dashboard as obs_dashboard
    from repro_torch.obs import health as obs_health
    from repro_torch.service import DescriptorBroker

    engine = build_offload_engine(retune_on_remesh=False, device=device)
    broker = DescriptorBroker(engine).start()
    monitor = obs_health.HealthMonitor()
    p = 1
    for a in axes:
        p *= int(a)
    x = torch.arange(p * payload_floats, dtype=torch.float32,
                     device=engine.device).reshape(p, payload_floats)
    try:
        client = broker.client("dashboard")
        desc = engine.make_descriptor(
            "scan", axes=tuple(axes), payload_bytes=payload_floats * 4,
            op="sum",
        )
        for _ in range(4):
            client.submit(desc, x).result(timeout=60.0)
    finally:
        broker.stop()
    monitor.ingest(service=broker.telemetry, engine=engine.telemetry)
    monitor.evaluate()
    print(
        obs_dashboard.render_dashboard(
            engine=engine, broker=broker, monitor=monitor
        )
    )


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--tune", action="store_true", help="run the autotuner")
    ap.add_argument(
        "--dashboard",
        action="store_true",
        help="run a smoke dispatch through engine+broker+health monitor "
        "and print the text dashboard",
    )
    ap.add_argument(
        "--serve",
        metavar="PORT",
        type=int,
        default=None,
        help="after other actions, serve /healthz, /metrics, /events and "
        "the dashboard over HTTP on PORT until interrupted",
    )
    ap.add_argument(
        "--flight-record",
        metavar="OUT.json",
        default=None,
        help="dump the flight recorder's event ring to OUT.json when the "
        "run ends (and automatically on crash/recovery paths)",
    )
    ap.add_argument(
        "--trace",
        metavar="OUT.json",
        default=None,
        help="run one traced smoke dispatch and write the merged "
        "host+device Perfetto trace",
    )
    ap.add_argument(
        "--trace-axes",
        default="2,4",
        help="mesh axes for --trace (comma-separated, default 2,4)",
    )
    ap.add_argument(
        "--splits",
        action="store_true",
        help="also measure planner axis-split winners per mesh shape",
    )
    ap.add_argument(
        "--fusion",
        action="store_true",
        help="also measure plan-optimizer fused-vs-unfused winners per "
        "mesh shape (feeds make_descriptor's optimize='auto')",
    )
    ap.add_argument(
        "--chunks",
        metavar="C,C,...",
        default=None,
        help="with --fusion, widen the measured grid to these chunked-"
        "streaming chunk counts per (fused, unfused) schedule (e.g. "
        "1,2,4,8 — feeds make_descriptor's chunks='auto')",
    )
    ap.add_argument(
        "--backend",
        metavar="NAME,NAME,...",
        default=None,
        help="with --fusion, race each schedule variant across these "
        "lowering backends ('' or 'default' = the op-per-round default, "
        "'pallas' = the fused-kernel lowering; e.g. default,pallas — "
        "feeds make_descriptor's backend='auto'). Variants outside a "
        "named backend's capabilities are skipped, not mis-measured",
    )
    ap.add_argument("--out", default=None,
                    help="where to write the table (default: "
                    "$REPRO_TORCH_CACHE_DIR/tuning_table.json)")
    ap.add_argument("--budget-s", type=float, default=60.0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument(
        "--registry",
        metavar="DIR",
        default=None,
        help="also merge the tuned table into a shared file registry "
        "(keyed by backend fingerprint) so other workers inherit it",
    )
    args = ap.parse_args(argv)
    if not (
        args.tune or args.trace or args.dashboard or args.serve is not None
    ):
        ap.error(
            "nothing to do; pass --tune, --trace, --dashboard, or --serve"
        )
    if args.chunks and not args.fusion:
        ap.error("--chunks widens the --fusion grid; pass --fusion too")
    if args.backend and not args.fusion:
        ap.error("--backend races the --fusion grid; pass --fusion too")
    if args.flight_record:
        # also arms the crash/recovery auto-dump for the rest of the run
        obs_events.set_auto_dump_path(args.flight_record)
    if args.trace:
        axes = tuple(int(a) for a in args.trace_axes.split(","))
        write_traced_smoke_trace(args.trace, axes=axes, device=args.device)
    if args.dashboard:
        run_dashboard_smoke(device=args.device)
    if args.tune:
        _run_tune(args)
    if args.serve is not None:
        from repro_torch.obs import dashboard as obs_dashboard

        server = obs_dashboard.start_http_server(port=args.serve)
        print(
            f"serving /healthz /metrics /events and the dashboard at "
            f"{server.url} (Ctrl-C to stop)"
        )
        try:
            server.thread.join()
        except KeyboardInterrupt:
            server.close()
    if args.flight_record:
        snap = obs_events.get_recorder().dump(
            args.flight_record, reason="run_end"
        )
        print(
            f"flight recorder: {len(snap['events'])} events "
            f"({snap['recorded']} recorded) -> {args.flight_record}"
        )


def _run_tune(args) -> None:
    device = "cuda" if args.device is None else args.device
    cache = autotune(
        iters=args.iters, time_budget_s=args.budget_s, verbose=True,
        device=device,
    )
    if args.splits:
        tune_splits(
            iters=args.iters,
            time_budget_s=args.budget_s,
            cache=cache,
            verbose=True,
            device=device,
        )
    if args.fusion:
        from repro_torch.offload import tune_schedule

        chunk_grid = (
            tuple(int(c) for c in args.chunks.split(","))
            if args.chunks
            else (1,)
        )
        backend_grid = (
            tuple(
                "" if b in ("", "default") else b
                for b in args.backend.split(",")
            )
            if args.backend
            else ("",)
        )
        tune_schedule(
            chunks=chunk_grid,
            backends=backend_grid,
            iters=args.iters,
            time_budget_s=args.budget_s,
            cache=cache,
            verbose=True,
            device=device,
        )
    if args.registry:
        from repro_torch.service import FileTuningRegistry

        merged = FileTuningRegistry(args.registry).publish(cache)
        print(
            f"merged into registry {args.registry} "
            f"[{cache.backend}]: {len(merged.measurements)} measurements, "
            f"{len(merged.split_measurements)} split samples"
        )
    out = cache.save(args.out or default_table_path())
    fitted = cache.fitted_model()
    print(f"tuning table written to {out}")
    if fitted is not None:
        print(
            f"fitted LinkModel: alpha={fitted.alpha:.3e}s "
            f"beta={fitted.beta:.3e}s/B gamma={fitted.gamma:.3e}s"
        )
    if cache.split_winners:
        print(f"axis-split winners: {len(cache.split_winners)} shapes")
    if cache.fusion_winners:
        print(f"fusion winners: {len(cache.fusion_winners)} shapes")
        chunked = sum(
            1 for _opt, c in cache.schedule_winners.values() if c > 1
        )
        if chunked:
            print(f"chunked-streaming winners: {chunked} grid points")
    if cache.backend_winners:
        print(
            f"lowering-backend winners: {len(cache.backend_winners)} "
            f"grid points"
        )
    print(f"export {TUNING_TABLE_ENV}={out}  # to use it in later launches")


if __name__ == "__main__":
    main()
