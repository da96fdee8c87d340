"""Optimizer steps of the program's training path, back to back.

The mix gives the batch and the sequence length; every step takes a new
packed batch of token ids drawn from the seed (labels: the next ids), so
that no two rows repeat. Set-up builds the step once
(``launch.steps.build_train_step``) and warms it up on a copy of the
benchmark's weights and a fresh optimizer state, which it then drops. The
window drives the model that holds the benchmark's weights, with a fresh
optimizer state, from its first step. What decides ``correct`` is read
from the window's first three steps: each step's loss, the norm of each
leaf's first gradient as the optimizer got it (from its first moment after
one step), and the norm of each leaf's change after three, all held to the
float32 reference of the same three steps (``reference/mamba2.py``,
``reference/adamw.py``) run once the window has closed and the program's
state is freed.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List

import torch

from portbench.bench import Check, family_modules
from portbench.reference import adamw as ref_adamw
from portbench.reference import flops
from portbench.workloads import Workload, sub_seed

FIRST_STEPS = 3
#: a leaf whose reference gradient is below this share of the median
#: leaf's is moved by round-off alone (a key's bias under softmax, say):
#: it is left out of the change's comparison
ZERO_GRAD_SHARE = 1e-3


def batch(seed: int, step: int, B: int, S: int, vocab: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s packed batch: ``B`` rows of ``S + 1`` ids from the
    seed, the last ``S`` of each row its labels."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "batch", step))
    ids = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device,
                        dtype=torch.int64)
    return {"tokens": ids[:, :-1].to(torch.int32), "labels": ids[:, 1:].to(torch.int32)}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    """The worst leaf's ``|prog - ref|`` over the larger of the reference
    leaf's norm and the median leaf's."""
    keys = [k for k in ref if keep(k)]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


class TrainWorkload(Workload):
    def __init__(self, cell, seed, device, fault=None):
        super().__init__(cell, seed, device, fault)
        self.B, self.S = int(self.mix["batch"]), int(self.mix["seq_len"])
        self.family, self.ref = family_modules(self.config["family"])
        self.vocab = int(self.config["vocab_size"])

    def batch(self, step: int):
        return batch(self.seed, step, self.B, self.S, self.vocab, self.device)

    def setup(self) -> None:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.steps import build_train_step
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.sharding.specs import Topology

        self.plant()
        self.w0 = self.ref.make_weights(self.config, sub_seed(self.seed, "weights"), self.device)
        # the warm-up's model: the step updates its weights in place
        api, warm = self.family.load_program(
            self.config, {k: v.clone() for k, v in self.w0.items()})
        self.step_fn, _, _ = build_train_step(
            api, Topology(mesh=None),
            ShapeConfig("portbench", self.S, self.B, "train"),
            AdamWConfig(**self.config["optimizer"]))
        opt = init_opt_state(warm)
        times = []
        for step in range(1, FIRST_STEPS + 1):
            t = time.perf_counter()
            # batches the window never draws
            warm, opt, _ = self.step_fn(warm, opt, self.batch(-step))
            self.sync()
            times.append(time.perf_counter() - t)
        del warm, opt
        self.est_call_s = statistics.median(times[1:])
        self.api, self.model = self.family.load_program(
            self.config, {k: v.clone() for k, v in self.w0.items()})
        self.opt = init_opt_state(self.model)
        self.b1 = float(self.config["optimizer"]["b1"])
        self.window_losses: List[torch.Tensor] = []
        #: the first moment after the window's first step, the master
        #: weights after its third (device copies, read after the window)
        self.kept: Dict[str, Dict[str, torch.Tensor]] = {}
        self.first: Dict[str, Any] = {}

    def call(self, i: int) -> None:
        self.model, self.opt, m = self.step_fn(self.model, self.opt, self.batch(i + 1))
        self.window_losses.append(m["loss"])
        if i == 0:
            self.kept["m"] = {k: v.clone() for k, v in self.opt["m"].items()}
        elif i == FIRST_STEPS - 1:
            self.kept["master"] = {k: v.clone() for k, v in self.opt["master"].items()}

    def stop(self, calls: int, elapsed: bool) -> bool:
        return elapsed and calls >= FIRST_STEPS

    def units(self, calls: int) -> Dict[str, float]:
        return {"tokens": float(calls * self.B * self.S)}

    def facts(self) -> Dict[str, Any]:
        return {"flops_per_call": flops.mamba2_train_flops(self.config, self.B, self.S),
                "tokens_per_call": self.B * self.S}

    def failures(self) -> int:
        """Window steps whose loss is not finite."""
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.window_losses))).sum())

    def release(self) -> None:
        """Read the window's first steps into numbers, then free the
        program's state."""
        if "master" in self.kept:
            self.first = {
                "loss": [float(x) for x in self.window_losses[:FIRST_STEPS]],
                "grad": {k: float(torch.linalg.vector_norm(v.double())) / (1 - self.b1)
                         for k, v in self.kept["m"].items()},
                "moved": {k: float(torch.linalg.vector_norm(v.double() - self.w0[k].double()))
                          for k, v in self.kept["master"].items()},
            }
        self.model = self.opt = self.step_fn = self.api = None
        self.window_losses, self.kept = [], {}
        super().release()

    # -- correct ------------------------------------------------------------

    def reference_steps(self, precision: str = "f32") -> Dict[str, Any]:
        """The reference's first steps from the same weights and batches."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = {k: v.to(torch.float32, copy=True) for k, v in self.w0.items()}
        opt = ref_adamw.AdamW(params, self.config["optimizer"])
        rows = int(self.mix.get("reference_rows", 1))
        out: Dict[str, Any] = {"loss": []}
        for step in range(1, FIRST_STEPS + 1):
            b = self.batch(step)
            loss, grads = self.ref.loss_and_grads(params, b["tokens"], b["labels"],
                                                  self.config, rows, precision)
            clipped = opt.step(grads)
            del grads
            out["loss"].append(loss)
            if step == 1:
                out["grad"] = {k: float(torch.linalg.vector_norm(g.double()))
                               for k, g in clipped.items()}
            del clipped
        out["moved"] = {k: float(torch.linalg.vector_norm(v.double() - self.w0[k].double()))
                        for k, v in params.items()}
        return out

    def readings(self, got: Dict[str, Any], want: Dict[str, Any]) -> List[Check]:
        lim = self.cell.limits
        med = statistics.median(want["grad"].values())
        moving = lambda k: want["grad"][k] >= ZERO_GRAD_SHARE * med  # noqa: E731
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
        return [
            Check("loss_rel_gap", loss_gap, float(lim["loss_rel_gap"])),
            Check("grad_norm_gap", leaf_gaps(got["grad"], want["grad"], lambda k: True),
                  float(lim["grad_norm_gap"])),
            Check("update_norm_gap", leaf_gaps(got["moved"], want["moved"], moving),
                  float(lim["update_norm_gap"])),
        ]

    def check(self) -> List[Check]:
        if not self.first:
            raise RuntimeError(f"the window ran fewer than {FIRST_STEPS} steps")
        return self.readings(self.first, self.reference_steps())

    def control(self) -> List[Check]:
        """The reference in float8 e4m3 put in the program's place."""
        return self.readings(self.reference_steps("fp8"), self.reference_steps())


def make(cell, seed, device, fault=None):
    return TrainWorkload(cell, seed, device, fault)
