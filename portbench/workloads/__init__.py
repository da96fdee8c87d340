"""The general generators and runners, one a traffic ``kind``: ``scan``
(back-to-back MPI_Scan calls), ``train`` (optimizer steps), ``prefill``.
A mix's data file names its kind and holds every parameter of it."""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional


def sub_seed(seed: int, *parts: Any) -> int:
    """A seed for one stream of the run, from the run's seed and a name."""
    return random.Random(f"{seed}:" + ":".join(map(str, parts))).getrandbits(63)


class Workload:
    """A cell's timed path: its set-up, its calls, and what decides
    ``correct``. The harness (``bench.run_local``) calls
    ``setup``, then ``call(i)`` back to back, then ``release`` and
    ``check``."""

    def __init__(self, cell, seed: int, device, fault: Optional[str] = None):
        import torch

        self.cell, self.seed = cell, int(seed)
        self.config, self.mix = cell.config, cell.mix
        self.device = torch.device(device)
        self.fault = fault
        self.samples: List[int] = []
        self.est_call_s = 0.0
        #: calls made in earlier windows of this run (a traced run has three)
        self.calls_done = 0
        self._unplant = None

    def plant(self) -> None:
        """Plant the run's fault, if it has one (``faults.py``); it is
        taken out again in :meth:`release`."""
        from portbench import faults

        self._unplant = faults.apply(self.fault)

    # -- the window ---------------------------------------------------------

    def setup(self) -> None:
        raise NotImplementedError

    def call(self, i: int) -> None:
        raise NotImplementedError

    def ready(self) -> None:
        """Wait for the last call's result. The default does not: steps
        queue on the card as a training or serving loop queues them, and
        ``drain`` waits for them all before the window closes."""

    def drain(self) -> None:
        self.sync()

    def stop(self, calls: int, elapsed: bool) -> bool:
        return elapsed

    def units(self, calls: int) -> Dict[str, float]:
        return {}

    def facts(self) -> Dict[str, Any]:
        return {}

    def plan_samples(self, seconds: float) -> None:
        """Draw from the seed the calls whose results are compared: the
        first, and ``checked - 1`` more spread over the calls the window is
        expected to hold (from the set-up's timing)."""
        n = int(self.mix.get("checked", 1))
        expect = max(1, int(0.8 * seconds / self.est_call_s)) if self.est_call_s else 1
        rng = random.Random(f"{self.seed}:samples:{self.calls_done}")
        self.samples = sorted({self.calls_done + i for i in
                               {0, *(rng.randrange(expect) for _ in range(n - 1))}})

    def primer(self) -> None:
        import torch

        torch.ones(1, device=self.device).add_(1)
        self.sync()

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- after the window ---------------------------------------------------

    def memory_peak(self) -> int:
        """The peak of the set-up and the window (the reference runs later)."""
        import torch

        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def counters(self) -> Dict[str, Any]:
        return {}

    def failures(self) -> int:
        return 0

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        import gc

        import torch

        if self._unplant is not None:
            self._unplant()
            self._unplant = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        raise NotImplementedError

