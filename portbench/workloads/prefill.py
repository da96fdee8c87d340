"""Prefills of the program's serving path, back to back.

The mix gives the prompts a prefill takes and their length; a few pools of
prompt ids drawn from the seed rotate. A call is
``launch.steps.build_prefill_step``'s ``prefill(model, batch)``: the
last-position logits and every layer's decode state. The results of calls
drawn from the seed are kept and, once the window has closed and the model
is freed, held to the float32 reference's forward over the same prompts
(``reference/mamba2.py``): the logits (their relative error, and their
widest gap, which one altered logit moves), the SSM states and the conv
tails (the worst layer's relative error).
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List

import torch

from portbench.bench import Check, family_modules
from portbench.reference import flops
from portbench.workloads import Workload, sub_seed


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``||got - want|| / ||want||``, in float64."""
    want = want.double()
    return float(torch.linalg.vector_norm(got.double() - want)
                 / torch.linalg.vector_norm(want))


def max_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest ``|got - want|`` over the root mean square of ``want``."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.pow(2).mean().sqrt())


def worst_layer(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest :func:`rel_err` over the leading (layer) axis."""
    return max(rel_err(g, w) for g, w in zip(got, want))


class PrefillWorkload(Workload):
    def __init__(self, cell, seed, device, fault=None):
        super().__init__(cell, seed, device, fault)
        self.B, self.S = int(self.mix["batch"]), int(self.mix["seq_len"])
        self.family, self.ref = family_modules(self.config["family"])
        self.kept: List[tuple] = []

    def prompts(self, k: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(self.seed, "prompts", k))
        return torch.randint(0, int(self.config["vocab_size"]), (self.B, self.S),
                             generator=gen, device=self.device, dtype=torch.int32)

    def weights(self):
        return self.ref.make_weights(self.config, sub_seed(self.seed, "weights"), self.device)

    def setup(self) -> None:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch.steps import build_prefill_step
        from repro_torch.sharding.specs import Topology

        self.plant()
        self.api, self.model = self.family.load_program(self.config, self.weights())
        self.step_fn, _, _ = build_prefill_step(
            self.api, Topology(mesh=None), ShapeConfig("portbench", self.S, self.B, "prefill"))
        self.pool = [self.prompts(k) for k in range(int(self.mix["inputs"]))]
        times = []
        for i in range(int(self.mix["warmup_calls"])):
            t = time.perf_counter()
            self.step_fn(self.model, {"tokens": self.pool[i % len(self.pool)]})
            self.sync()
            times.append(time.perf_counter() - t)
        self.est_call_s = statistics.median(times[1:] or times)

    def call(self, i: int) -> None:
        k = i % len(self.pool)
        out = self.step_fn(self.model, {"tokens": self.pool[k]})
        if i in self.samples:
            self.kept.append((k, out))

    def units(self, calls: int) -> Dict[str, float]:
        return {"tokens": float(calls * self.B * self.S)}

    def facts(self) -> Dict[str, Any]:
        return {"flops_per_call": flops.mamba2_forward_flops(self.config, self.B, self.S, 1),
                "tokens_per_call": self.B * self.S}

    def release(self) -> None:
        self.model = self.step_fn = self.api = None
        super().release()

    # -- correct ------------------------------------------------------------

    def readings(self, outputs, precision: str = "f32") -> List[Check]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        lim = self.cell.limits
        p = {k: v.float() for k, v in self.weights().items()}
        rows = int(self.mix.get("reference_rows", 1))
        logit, widest, ssm, conv = [], [], [], []
        for k, (last, states) in outputs:
            want_last, want = self.ref.prefill(p, self.pool[k], self.config, rows)
            logit.append(rel_err(last.reshape(want_last.shape), want_last))
            widest.append(max_gap(last.reshape(want_last.shape), want_last))
            ssm.append(worst_layer(states["ssm"], want["ssm"]))
            conv.append(max(worst_layer(states["conv_x"], want["conv_x"]),
                            worst_layer(states["conv_bc"], want["conv_bc"])))
        inf = [float("inf")]
        return [Check("logit_rel_err", max(logit or inf), float(lim["logit_rel_err"])),
                Check("logit_max_gap", max(widest or inf), float(lim["logit_max_gap"])),
                Check("ssm_rel_err", max(ssm or inf), float(lim["ssm_rel_err"])),
                Check("conv_rel_err", max(conv or inf), float(lim["conv_rel_err"]))]

    def check(self) -> List[Check]:
        kept, self.kept = self.kept, []
        return self.readings([(k, (last, caches["mamba"])) for k, (last, caches) in kept])

    def control(self) -> List[Check]:
        """The reference in float8 e4m3 put in the program's place."""
        p = {k: v.float() for k, v in self.weights().items()}
        rows = int(self.mix.get("reference_rows", 1))
        outs = [(k, self.ref.prefill(p, self.pool[k], self.config, rows, "fp8"))
                for k, _ in self.kept]
        self.kept = []
        return self.readings(outs)


def make(cell, seed, device, fault=None):
    return PrefillWorkload(cell, seed, device, fault)
