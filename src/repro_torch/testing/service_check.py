"""Validation of the multi-tenant offload service in driver mode
(counterpart of ``repro.testing.service_check``).

    python -m repro_torch.testing.service_check [OUTER INNER] [--clients N]
        [--requests N] [--device cpu]

Four scenarios over an (OUTER, INNER) co-resident
:class:`repro_torch.compat.Mesh` (default (2, 2)) on the card, or on the
CPU with ``--device cpu``:

  1. **Concurrent bitwise equivalence** — N >= 4 client threads stream
     planned 2-axis descriptors (SCAN / ALLREDUCE / EXSCAN over the (pod,
     data) mesh, one with a non-identity split) through a started
     :class:`DescriptorBroker` in the engine's **driver mode**; every result
     must be bitwise equal to a direct per-client dispatch through an
     independent engine, and the measured coalesce factor must exceed 1.
  2. **Backpressure isolation** — one tenant with a tiny queue bound
     overruns it and observes rejection while the other tenants' in-flight
     results stay bitwise correct and their telemetry clean.
  3. **Registry inheritance** — two disjoint tuning tables merge under the
     shared registry and the broker plans a split winner contributed by the
     table this "worker" never measured.
  4. **Deadline flush** — a lone request completes within a bounded wait
     (no companion traffic needed).

Emits ``service_check`` CSV rows and a final ALL-OK; exits nonzero on any
mismatch.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import threading
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.compat import Mesh
from repro_torch.core.selector import set_active_tuning
from repro_torch.offload import OffloadEngine, TuningCache
from repro_torch.service import (
    DescriptorBroker,
    FileTuningRegistry,
    QueueFullError,
)

AXIS_NAMES = ("pod", "data")
N = 32  # payload columns per request

FAILURES = 0


def check(name: str, ok: bool) -> None:
    global FAILURES
    print(f"service_check {name:42s} {'OK' if ok else 'FAIL'}")
    FAILURES += 0 if ok else 1


#: (mesh shape, device), set by main
_AXES: Tuple[int, ...] = (2, 2)
_NDEV = 4
_DEVICE = torch.device("cpu")


def _mesh() -> Mesh:
    return Mesh(_AXES, AXIS_NAMES, device=_DEVICE)


def _engine() -> OffloadEngine:
    return OffloadEngine(device=_DEVICE)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(_DEVICE)


def _descriptors(eng: OffloadEngine):
    """The request mix every tenant streams (planned 2-axis descriptors,
    one with a non-identity split)."""
    mk = eng.make_descriptor
    return [
        mk("SCAN", axes=_AXES, payload_bytes=N * 4, op="sum",
           split=(0, 1)),
        mk("ALLREDUCE", axes=_AXES, payload_bytes=N * 4, op="sum",
           split=(0, 1)),
        mk("EXSCAN", axes=_AXES, payload_bytes=N * 4, op="sum",
           split=(1, 0)),
    ]


def concurrent_bitwise_scenario(n_clients: int, n_requests: int) -> None:
    mesh = _mesh()
    broker = DescriptorBroker(
        _engine(),
        axis_name=AXIS_NAMES,
        mesh=mesh,
        flush_interval_s=0.25,
    ).start()
    direct = _engine()
    descs = _descriptors(broker.engine)
    rng = np.random.default_rng(11)
    payloads = {
        (c, r): _tensor(
            rng.integers(-4, 5, size=(_NDEV, N)).astype(np.float32)
        )
        for c in range(n_clients)
        for r in range(n_requests)
    }
    clients = [broker.client(f"tenant{c}") for c in range(n_clients)]
    barrier = threading.Barrier(n_clients)
    results: dict = {}
    errors: list = []

    def work(c: int) -> None:
        try:
            for r in range(n_requests):
                # all tenants post the same round's descriptor inside one
                # flush window: the broker coalesces across tenants
                barrier.wait()
                ticket = clients[c].submit(
                    descs[r % len(descs)].encode(), payloads[(c, r)]
                )
                results[(c, r)] = ticket.result(60)
        except Exception as e:  # noqa: BLE001
            errors.append((c, e))

    threads = [
        threading.Thread(target=work, args=(c,)) for c in range(n_clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    broker.stop()
    check("no client errors", not errors)
    if errors:
        print(f"  first error: {errors[0]}")

    bitwise = True
    for (c, r), got in results.items():
        desc = descs[r % len(descs)]
        want = direct.offload(
            desc, payloads[(c, r)], axis_name=AXIS_NAMES, mesh=mesh
        )
        bitwise &= torch.equal(got, want)
    check(
        "all results bitwise == direct dispatch",
        bitwise and len(results) == n_clients * n_requests,
    )
    snap = broker.telemetry.snapshot()
    factor = snap["coalesce_factor"]
    check("coalesce factor > 1", factor > 1.0)
    check(
        "every tenant completed every request",
        all(
            t["completed"] == n_requests and t["rejected"] == 0
            for t in snap["tenants"].values()
        ),
    )
    total = n_clients * n_requests
    print(
        f"service_check_stats,clients,{n_clients},requests,{total},"
        f"dispatches,{snap['fused_dispatches']},"
        f"coalesce_factor,{factor:.2f},"
        f"engine_cache_size,{snap['engine']['cache_size']},"
        f"wall_s,{wall_s:.2f}"
    )
    print(
        f"service_check_summary,bitwise_equal,{int(bitwise)},"
        f"coalesce_gt1,{int(factor > 1.0)},"
        f"coalesce_factor,{factor:.2f}"
    )


def backpressure_scenario() -> None:
    """One tenant overruns a 2-deep queue; rejection is observed and the
    other tenants' results stay bitwise correct."""
    mesh = _mesh()
    broker = DescriptorBroker(
        _engine(), axis_name=AXIS_NAMES, mesh=mesh
    )
    direct = _engine()
    desc = broker.engine.make_descriptor(
        "ALLREDUCE", axes=_AXES, payload_bytes=N * 4, op="sum", split=(0, 1)
    )
    rng = np.random.default_rng(5)
    xs = [
        _tensor(rng.integers(-4, 5, size=(_NDEV, N)).astype(np.float32))
        for _ in range(5)
    ]
    small = broker.client("small", max_queue_depth=2)
    others = [broker.client(f"ok{i}") for i in range(2)]
    tickets = [c.submit(desc.encode(), x) for c, x in zip(others, xs)]
    small.submit(desc.encode(), xs[2])
    small.submit(desc.encode(), xs[3])
    rejected = False
    try:
        small.submit(desc.encode(), xs[4])
    except QueueFullError:
        rejected = True
    check("overrun tenant observes backpressure", rejected)
    broker.drain()
    ok = True
    for t, x in zip(tickets, xs):
        want = direct.offload(desc, x, axis_name=AXIS_NAMES, mesh=mesh)
        ok &= torch.equal(t.result(30), want)
    check("other tenants' results uncorrupted", ok)
    snap = broker.telemetry.snapshot()
    check(
        "rejection localized to the overrun tenant",
        snap["tenants"]["small"]["rejected"] == 1
        and snap["tenants"]["small"]["completed"] == 2
        and all(
            snap["tenants"][f"ok{i}"]["rejected"] == 0 for i in range(2)
        ),
    )


def registry_scenario() -> None:
    """Disjoint tables merge in the shared registry; the broker's planner
    adopts the split winner the *other* worker measured."""
    with tempfile.TemporaryDirectory() as root:
        mine = TuningCache(device=_DEVICE)
        theirs = TuningCache(device=_DEVICE)
        mine.record_split("scan", _AXES, (0, 1), N * 4, 5e-3)
        theirs.record_split("scan", _AXES, (1, 0), N * 4, 1e-3)
        reg = FileTuningRegistry(root)
        reg.publish(mine)
        reg.publish(theirs)
        set_active_tuning(None)
        broker = DescriptorBroker(_engine(), registry=reg)
        desc = broker.make_descriptor(
            "SCAN", axes=_AXES, payload_bytes=N * 4, op="sum", split="auto"
        )
        check(
            "broker inherits other worker's split winner",
            desc.split == (1, 0) and broker.tuning_table is not None,
        )
        set_active_tuning(None)


def deadline_flush_scenario() -> None:
    """A lone request (no companion traffic) completes within a bounded
    wait: the deadline flush dispatches it alone."""
    mesh = _mesh()
    with DescriptorBroker(
        _engine(),
        axis_name=AXIS_NAMES,
        mesh=mesh,
        flush_interval_s=0.05,
    ) as broker:
        c = broker.client("lone")
        desc = broker.engine.make_descriptor(
            "SCAN", axes=_AXES, payload_bytes=N * 4, op="sum", split=(0, 1)
        )
        x = torch.ones((_NDEV, N), dtype=torch.float32, device=_DEVICE)
        t0 = time.perf_counter()
        out = c.offload(desc.encode(), x, timeout=30)
        waited = time.perf_counter() - t0
        want = np.cumsum(np.ones((_NDEV, N), np.float32), axis=0)
        check(
            "lone request not starved",
            np.array_equal(out.cpu().numpy(), want),
        )
        # generous bound: one flush window + one driver-mode compile
        print(f"service_check lone-request wait: {waited:.2f}s")


def main(argv: List[str]) -> int:
    global FAILURES, _AXES, _NDEV, _DEVICE
    FAILURES = 0
    ap = argparse.ArgumentParser(prog="repro_torch.testing.service_check")
    ap.add_argument("axes", nargs="*", type=int, default=[2, 2])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.clients < 4:
        raise SystemExit("acceptance requires >= 4 concurrent clients")
    _AXES = tuple(args.axes)
    _NDEV = int(np.prod(_AXES))
    _DEVICE = OffloadEngine(device=args.device).device

    concurrent_bitwise_scenario(args.clients, args.requests)
    backpressure_scenario()
    registry_scenario()
    deadline_flush_scenario()

    if FAILURES:
        print(f"FAILURES: {FAILURES}")
        return 1
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
