"""Reliability-stack validation: chaos, checksums, bisection, breakers
(counterpart of ``repro.testing.chaos_check``).

    python -m repro_torch.testing.chaos_check [OUTER INNER] [--device cpu]

One seeded run over an (OUTER, INNER) mesh shape (default (2, 2)) on the
card, or on the CPU with ``--device cpu``, exercises the dispatch
reliability contract end to end:

  1. **Bitwise recovery under chaos** — with a seeded
     :class:`~repro_torch.runtime.chaos.ChaosInjector` dropping AND
     corrupting 5% of individual messages, all five CollTypes submitted
     through a reliability-enabled
     :class:`~repro_torch.service.DescriptorBroker` must complete
     **bitwise-equal** to their fault-free dispatches, purely via retries
     (chaos decisions advance per message, so retried dispatches draw fresh
     ones). At least one fault must actually have been injected and at
     least one retry taken — a clean run proves nothing.
  2. **Quarantine by bisection** — four tenants coalesce into one fused
     group; one queued payload is corrupted *at rest* (post-submit, so
     its submit-time checksum is stale). The drain must fail exactly the
     poisoned ticket with an attributed
     :class:`~repro_torch.core.packet.IntegrityError` while the three clean
     neighbors complete bitwise-correct, with ``bisect`` and
     ``quarantine`` flight events recorded.
  3. **Breaker trip, degrade, recover** — under 100% drop chaos the
     engine stage exhausts retries; after ``failure_threshold``
     consecutive failures the (backend, coll) breaker opens, dispatches
     degrade to :func:`~repro_torch.offload.reliability.reference_collective`
     (still bitwise-correct for the int32 payload), and ``/healthz`` flips
     to "alert" naming the open circuit. With chaos lifted and the
     (injected) clock past the cooldown, a half-open probe must close the
     breaker and ``/healthz`` must return to "ok".

Emits a ``chaos_check_summary`` CSV row and a final ALL-OK; exits
nonzero on any violation.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from repro_torch.core.packet import (
    CollType,
    CollectiveDescriptor,
    IntegrityError,
    WireDType,
)
from repro_torch.obs import events as obs_events
from repro_torch.obs import health as obs_health
from repro_torch.offload import OffloadEngine
from repro_torch.offload.reliability import (
    CircuitBreaker,
    ReliabilityPolicy,
    ReliableDispatcher,
    RetryPolicy,
)
from repro_torch.runtime.chaos import ChaosInjector
from repro_torch.service import DescriptorBroker

N = 64          # payload columns (int32: exact arithmetic -> bitwise gates)
SEED = 20140409  # the paper's year+month+day; any seed must work
CHAOS_RATE = 0.05

FAILURES = 0


def check(name: str, ok: bool) -> None:
    global FAILURES
    print(f"chaos {name:46s} {'OK' if ok else 'FAIL'}")
    FAILURES += 0 if ok else 1


def main(argv: List[str]) -> int:
    global FAILURES
    FAILURES = 0
    parser = argparse.ArgumentParser(prog="repro_torch.testing.chaos_check")
    parser.add_argument("sizes", nargs="*", type=int, default=[2, 2])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    axes = tuple(args.sizes)
    ndev = int(np.prod(axes))
    device = OffloadEngine(device=args.device).device

    def make_desc(coll: CollType) -> CollectiveDescriptor:
        return CollectiveDescriptor(
            comm_size=ndev,
            axes=axes,
            coll_type=coll,
            count=N,
            data_type=WireDType.INT32,
        )

    def payload(i: int = 0) -> torch.Tensor:
        return torch.arange(
            ndev * N, dtype=torch.int32, device=device
        ).reshape(ndev, N) + i

    # ---- 1. five CollTypes, bitwise through 5% drop+corrupt chaos --------
    policy = ReliabilityPolicy(
        retry=RetryPolicy(max_attempts=40, backoff_s=1e-5, max_backoff_s=1e-3)
    )
    broker = DescriptorBroker(OffloadEngine(device=device), reliability=policy)
    eng = broker.engine
    colls = [
        CollType.SCAN, CollType.EXSCAN, CollType.REDUCE,
        CollType.ALLREDUCE, CollType.BARRIER,
    ]
    # fault-free references first (the planned cached path; the chaos-path
    # interpreter is bitwise-gated against it here)
    refs = {
        c: eng.offload(make_desc(c), None if c == CollType.BARRIER
                       else payload())
        for c in colls
    }
    injector = ChaosInjector(SEED, drop=CHAOS_RATE, corrupt=CHAOS_RATE)
    client = broker.client("chaotic")
    bitwise_ok = True
    with injector.scope():
        for c in colls:
            t = client.submit(
                make_desc(c),
                None if c == CollType.BARRIER else payload(),
            )
            broker.drain()
            out = t.result(timeout=120.0)
            same = torch.equal(out, refs[c])
            check(f"{c.name} bitwise under chaos", same)
            bitwise_ok = bitwise_ok and same
    faults = injector.faults_injected()
    retries = broker._dispatcher.counts["retries"]
    check("chaos actually injected faults", faults > 0)
    check("recovery actually took retries", retries > 0)
    bitwise_ok = bitwise_ok and faults > 0 and retries > 0

    # ---- 2. a poisoned request is quarantined by bisection ---------------
    quarantine_broker = DescriptorBroker(
        OffloadEngine(device=device), reliability=policy
    )
    qeng = quarantine_broker.engine
    desc = make_desc(CollType.SCAN)
    clients = [quarantine_broker.client(f"t{i}") for i in range(4)]
    tickets = [c.submit(desc, payload(i)) for i, c in enumerate(clients)]
    poisoned = 2
    bad = quarantine_broker._queue[poisoned].payload.clone()
    bad[1, 5] ^= 1  # one bit, at rest, after the submit-time checksum
    quarantine_broker._queue[poisoned].payload = bad
    quarantine_broker.drain()
    quarantine_ok = True
    for i, t in enumerate(tickets):
        if i == poisoned:
            try:
                t.result(timeout=10.0)
                ok = False
            except IntegrityError as e:
                ok = e.request == f"t{poisoned}#0"
            check("poisoned ticket fails with IntegrityError", ok)
        else:
            out = t.result(timeout=10.0)
            ok = torch.equal(out, qeng.offload(desc, payload(i)))
            check(f"clean neighbor t{i} bitwise-correct", ok)
        quarantine_ok = quarantine_ok and ok
    counts = obs_events.get_recorder().counts()
    check("bisect events recorded", counts.get("bisect", 0) >= 1)
    check("quarantine event recorded", counts.get("quarantine", 0) >= 1)
    quarantine_ok = quarantine_ok and (
        counts.get("bisect", 0) >= 1 and counts.get("quarantine", 0) >= 1
    )

    # ---- 3. breaker trips under sustained loss, degrades, recovers -------
    clk = {"t": 0.0}
    breaker = CircuitBreaker(
        failure_threshold=3, cooldown_s=5.0, clock=lambda: clk["t"]
    )
    dispatcher = ReliableDispatcher(
        OffloadEngine(device=device),
        retry=RetryPolicy(max_attempts=2, backoff_s=0.0),
        breaker=breaker,
        clock=lambda: clk["t"],
        sleep=lambda s: None,
    )
    monitor = obs_health.HealthMonitor(breaker=breaker)
    desc = make_desc(CollType.SCAN)
    key = ("default", "scan")
    storm = ChaosInjector(SEED + 1, drop=1.0)
    breaker_ok = True
    with storm.scope():
        for _ in range(4):
            out = dispatcher.offload(desc, payload())
            same = torch.equal(out, refs[CollType.SCAN])
            breaker_ok = breaker_ok and same
    check("degraded dispatches stay bitwise-correct", breaker_ok)
    opened = breaker.state(key) == "open"
    check("breaker opened after consecutive failures", opened)
    check("dispatches degraded to reference", (
        dispatcher.counts["degrades"] >= 3
        and dispatcher.counts["reference_dispatches"] == 4
        and dispatcher.counts["breaker_skips"] >= 1
    ))
    hz = monitor.healthz()
    healthz_alert = (
        hz["status"] == "alert"
        and hz["breakers"].get("default|scan", {}).get("state") == "open"
    )
    check("healthz reflects the open breaker", healthz_alert)
    breaker_ok = breaker_ok and opened and healthz_alert

    # chaos lifted + cooldown elapsed: half-open probe must close it
    clk["t"] += 10.0
    out = dispatcher.offload(desc, payload())
    recovered = (
        torch.equal(out, refs[CollType.SCAN])
        and breaker.state(key) == "closed"
    )
    check("half-open probe closes the breaker", recovered)
    hz = monitor.healthz()
    healthz_ok = (
        hz["status"] == "ok"
        and hz["breakers"].get("default|scan", {}).get("state") == "closed"
    )
    check("healthz back to ok after recovery", healthz_ok)
    breaker_ok = breaker_ok and recovered
    counts = obs_events.get_recorder().counts()
    check("breaker transitions recorded", (
        counts.get("breaker_open", 0) >= 1
        and counts.get("breaker_half_open", 0) >= 1
        and counts.get("breaker_closed", 0) >= 1
    ))

    print(
        f"chaos_check_summary,bitwise_equal,{int(bitwise_ok)},"
        f"faults,{faults},retries,{retries},"
        f"quarantine_ok,{int(quarantine_ok)},"
        f"breaker_ok,{int(breaker_ok)},"
        f"healthz_ok,{int(healthz_alert and healthz_ok)}"
    )
    if FAILURES:
        print(f"FAILURES: {FAILURES}")
        return 1
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
