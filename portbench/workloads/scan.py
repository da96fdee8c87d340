"""Back-to-back blocking MPI_Scan calls through the port's offload engine.

Every rank is stacked ``(p, n)`` on one card, in the engine's sim mode (K1
under ``backend="pallas"``). The mix gives the operation, the type, the
bytes a rank and how many seeded inputs rotate. A call is timed from its
start to its result being ready on the card. The results of calls drawn
from the seed are kept and, once the window has closed and the engine is
freed, held to the float64 reference (``reference/scan.py``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from portbench.bench import Check
from portbench.reference.scan import control_scan, scan_error
from portbench.workloads import Workload, sub_seed


class ScanWorkload(Workload):
    def __init__(self, cell, seed, device, fault=None):
        super().__init__(cell, seed, device, fault)
        self.p = int(self.config["ranks"])
        self.dtype = getattr(torch, self.mix["dtype"])
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        self.n = int(self.mix["bytes_per_rank"]) // self.itemsize
        self.kept: List[tuple] = []

    # -- inputs -------------------------------------------------------------

    def row(self, k: int, r: int) -> torch.Tensor:
        """Rank ``r``'s ``k``-th input, from the seed alone."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(self.seed, "input", k, r))
        return torch.randn(self.n, generator=gen, device=self.device).to(self.dtype)

    def stacked(self, k: int) -> torch.Tensor:
        return torch.stack([self.row(k, r) for r in range(self.p)])

    # -- the program --------------------------------------------------------

    def setup(self) -> None:
        from repro_torch import OffloadEngine
        from repro_torch.kernels import fused_collective

        self.plant()
        self.k1 = fused_collective
        self.eng = OffloadEngine(device=self.device)
        d = self.config["descriptor"]
        desc = self.eng.make_descriptor(
            self.mix["coll"], axes=tuple(d["axes"]),
            payload_bytes=self.n * self.itemsize, op=self.mix["op"],
            backend=d["backend"], chunks=d["chunks"])
        self.words = desc.encode()
        self.inputs = [self.stacked(k) for k in range(int(self.mix["inputs"]))]
        self.k1_before = self.k1.launches
        # warm every input, then hold as many results as the window keeps,
        # so that keeping them there takes blocks the allocator holds
        times = []
        held = []
        for i in range(max(int(self.mix["warmup_calls"]), len(self.inputs))):
            t = time.perf_counter()
            held.append(self._dispatch(self.inputs[i % len(self.inputs)]))
            self.sync()
            times.append(time.perf_counter() - t)
        for i in range(int(self.mix.get("checked", 1)) + 1 - len(held)):
            held.append(self._dispatch(self.inputs[0]))
        self.sync()
        del held
        self.est_call_s = sorted(times[-3:])[len(times[-3:]) // 2]

    def _dispatch(self, x):
        return self.eng.offload(self.words, x)

    def call(self, i: int) -> None:
        k = i % len(self.inputs)
        out = self._dispatch(self.inputs[k])
        if i in self.samples:
            self.kept.append((k, out))

    def ready(self) -> None:
        self.sync()

    def units(self, calls: int) -> Dict[str, float]:
        return {"bytes": float(self.p * self.n * self.itemsize * calls)}

    def facts(self) -> Dict[str, Any]:
        return {"ranks": self.p, "count": self.n, "itemsize": self.itemsize}

    def counters(self) -> Dict[str, Any]:
        tel = self.eng.telemetry
        return {
            "k1_launches": self.k1.launches - self.k1_before,
            "backend_fallbacks": tel.backend_fallbacks,
        }

    def release(self) -> None:
        self.eng = None
        super().release()

    # -- correct ------------------------------------------------------------

    def readings(self, outputs) -> List[Check]:
        limit = float(self.cell.limits["scan_rel_err"])
        errs = [scan_error(out, self.inputs[k]) for k, out in outputs]
        return [Check("scan_rel_err", max(errs) if errs else float("inf"), limit)]

    def check(self) -> List[Check]:
        kept, self.kept = self.kept, []
        return self.readings(kept)

    def control(self) -> List[Check]:
        """The reference in bfloat16 put in the program's place, on the
        inputs of the calls the window kept."""
        outs = [(k, control_scan(self.inputs[k])) for k, _ in self.kept]
        self.kept = []
        return self.readings(outs)


def make(cell, seed, device, fault=None):
    return ScanWorkload(cell, seed, device, fault)
