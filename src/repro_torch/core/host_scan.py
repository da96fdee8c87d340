"""Host-orchestrated scan — the "software MPI" baseline (PyTorch port of
``repro.core.host_scan``).

The paper's comparison axis is *who drives the schedule*: software MPI has the
host CPU issue every send/recv (one dispatch per hop, protocol stack in the
loop), while the offloaded version hands the NIC one descriptor and receives
one result.

On one GPU the *software* path below re-enters Python between every schedule
step: each hop is its own dispatch followed by ``torch.cuda.synchronize()``,
the host's synchronous involvement, exactly the dispatch pattern of an
un-offloaded MPI progress engine. The *offloaded* counterpart,
:func:`time_offloaded_scan`, captures the whole schedule once into a CUDA
graph and replays it: one launch per scan, like one offload packet. Both run
the same :class:`~repro_torch.core.algorithms.SimBackend` arithmetic, so
their results are bitwise equal.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List

import torch

from repro_torch.core import algorithms as alg
from repro_torch.core.operators import AssocOp, get_operator
from repro_torch.core.scan_collective import sim_scan
from repro_torch.core.trees import tree_device

PyTree = Any


class _RecordingBackend(alg.SimBackend):
    """SimBackend that records the permutation of every schedule step."""

    def __init__(self, p: int):
        super().__init__(p, "cpu")
        self.steps: List[alg.Perm] = []

    def permute(self, tree, perm):
        self.steps.append(list(perm))
        return super().permute(tree, perm)


def schedule_trace(algorithm: str, p: int) -> List[alg.Perm]:
    """Extract the hop list of a schedule (used by benches + latency model)."""
    backend = _RecordingBackend(p)
    op = get_operator("sum")
    x = torch.zeros((p, 1), dtype=torch.float32)
    alg.get_algorithm(algorithm)(backend, x, op)
    return backend.steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _HostSteppedBackend(alg.SimBackend):
    """Each permute is its own dispatch + host sync (the un-offloaded path)."""

    def permute(self, tree, perm):
        out = super().permute(tree, perm)
        _sync(self.device)
        return out


def host_scan(
    stacked: PyTree,
    op: "AssocOp | str",
    p: int,
    *,
    algorithm: str,
) -> PyTree:
    """Run the schedule with the host in the loop (one dispatch per step).

    ``stacked`` carries a leading rank axis of size p on a single device —
    logically one buffer per rank, as on the paper's 8 hosts. The host
    synchronizes after every step and at the end. The result equals
    ``sim_scan`` bit-for-bit.
    """
    op = get_operator(op)
    device = tree_device(stacked)
    backend = _HostSteppedBackend(p, device)
    out = alg.get_algorithm(algorithm)(backend, stacked, op)
    _sync(device)
    return out


def _median_seconds(fn: Callable[[], None], iters: int) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def time_host_scan(
    stacked: PyTree, op, p: int, *, algorithm: str, iters: int = 20
) -> float:
    """Median wall-clock seconds per host-orchestrated scan."""
    host_scan(stacked, op, p, algorithm=algorithm)  # warm the allocator
    return _median_seconds(
        lambda: host_scan(stacked, op, p, algorithm=algorithm), iters
    )


def offloaded_scan(stacked: PyTree, op, p: int, *, algorithm: str):
    """The whole schedule as one replayable unit: returns ``(replay, out)``.

    On a CUDA tensor the schedule runs once eagerly (which also makes the
    backend's index tensors), then is captured into a ``torch.cuda.CUDAGraph``;
    ``replay()`` launches the graph, which rewrites ``out`` from ``stacked``'s
    current values. Capture failures raise. On a CPU tensor ``replay()`` runs
    ``sim_scan`` eagerly and ``out`` is its first result.
    """
    op = get_operator(op)
    device = tree_device(stacked)
    backend = alg.SimBackend(p, device)

    def run():
        return sim_scan(stacked, op, p, algorithm=algorithm, inclusive=True,
                        backend=backend)

    if device.type != "cuda":
        return run, run()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run()  # warm-up off the default stream, as graph capture wants
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    return graph.replay, out


def time_offloaded_scan(
    stacked: PyTree, op, p: int, *, algorithm: str, iters: int = 20
) -> float:
    """Median wall-clock seconds for the fused (single-launch) schedule.

    Same simulator semantics, but the whole schedule is one CUDA graph —
    one launch per scan, like one offload packet (one eager ``sim_scan``
    per call on the CPU).
    """
    device = tree_device(stacked)
    replay, out = offloaded_scan(stacked, op, p, algorithm=algorithm)

    def once():
        replay()
        _sync(device)

    once()
    del out
    return _median_seconds(once, iters)
