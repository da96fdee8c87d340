"""Prefills of a hybrid model (Mamba2 and attention layers, an MoE after
every mixer) through the program's serving path, back to back.

The ``prefill`` runner's calls, prompts and window, with what a hybrid adds:
its FLOPs (``reference/<family>.py``'s count), and what decides ``correct``:
the kept calls' last-position logits (relative error and widest gap), the
Mamba layers' SSM states and conv tails, and the attention layers' K and V
(the worst layer's relative error each), held to the float32 reference's
forward over the same prompts once the model is freed.

The program's hybrid caches nest as ``{"k", "v": (periods, B, S, kv heads,
hd), "mamba": {name: (periods, Mamba layers a period, B, ...)}}``; the
comparison flattens them to one leading layer axis, as the reference
stacks its states. ``faults.py`` plants its prefill faults over the flat
caches of the Mamba2 family; where one of them is planted, this runner
plants the same fault for the hybrid's caches in its place
(:func:`hybrid_fault`), so that the control readings see it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from portbench.bench import Check
from portbench.workloads.prefill import PrefillWorkload, max_gap, rel_err, worst_layer

def flat_states(caches: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The program's hybrid caches, or the reference's states, as
    ``{name: (layers, B, ...)}``."""
    if "ssm" in caches:
        return caches
    m = caches["mamba"]
    out = {n: v.reshape((-1,) + tuple(v.shape[2:])) for n, v in m.items()}
    out["k"], out["v"] = caches["k"], caches["v"]
    return out


def _half(last, caches):
    rows = last.shape[0] // 2
    last = last.clone()
    last[rows:] = 0

    def cut(v, axis):
        keep = v.narrow(axis, 0, rows)
        return torch.cat([keep, torch.zeros_like(v.narrow(axis, rows, v.shape[axis] - rows))],
                         axis)

    return last, {"k": cut(caches["k"], 1), "v": cut(caches["v"], 1),
                  "mamba": {n: cut(v, 2) for n, v in caches["mamba"].items()}}


def _unchanged(last, caches):
    return last, {"k": torch.zeros_like(caches["k"]), "v": torch.zeros_like(caches["v"]),
                  "mamba": {n: torch.zeros_like(v) for n, v in caches["mamba"].items()}}


#: ``faults.py``'s prefill wrappers by name, and the hybrid form of each
HYBRID_FAULTS: Dict[str, Callable] = {"zero_states": _unchanged, "half_prefill": _half}


def hybrid_fault() -> Optional[Callable[[], None]]:
    """Where ``faults.py`` has planted a prefill fault that rewrites the
    caches, plant its hybrid form over it and return what takes that out
    (the fault's own undo restores the program beneath); else None."""
    from repro_torch.models import transformer as T

    planted = T.lm_prefill
    form = HYBRID_FAULTS.get(getattr(planted, "__name__", ""))
    if form is None or getattr(planted, "__closure__", None) is None:
        return None
    program = next(cell.cell_contents for cell in planted.__closure__
                   if getattr(cell.cell_contents, "__name__", "") == "lm_prefill")

    def faulty(model, tokens, cfg, **kw):
        return form(*program(model, tokens, cfg, **kw))

    T.lm_prefill = faulty

    def undo():
        if T.lm_prefill is faulty:
            T.lm_prefill = planted

    return undo


class HybridPrefillWorkload(PrefillWorkload):
    #: takes out the hybrid form of a planted fault (:func:`hybrid_fault`)
    _hybrid_undo: Optional[Callable[[], None]] = None

    def plant(self) -> None:
        super().plant()
        self._hybrid_undo = hybrid_fault()

    def call(self, i: int) -> None:
        k = i % len(self.pool)
        last, caches = self.step_fn(self.model, {"tokens": self.pool[k]})
        if i in self.samples:
            # the last position's logits are a view of every position's
            # (B, S, Vp): a kept call holds a copy of its own
            self.kept.append((k, (last.clone(), caches)))

    def facts(self) -> Dict[str, Any]:
        return {"flops_per_call": self.ref.forward_flops(self.config, self.B, self.S, 1),
                "moe_expert_flops_per_call": self.ref.routed_expert_flops(
                    self.config, self.B, self.S),
                "tokens_per_call": self.B * self.S}

    def release(self) -> None:
        if self._hybrid_undo is not None:
            self._hybrid_undo()
            self._hybrid_undo = None
        super().release()

    # -- correct ------------------------------------------------------------

    def reference_weights(self) -> Dict[str, torch.Tensor]:
        """The weights in float32, converted a leaf at a time."""
        w = self.weights()
        return {k: w.pop(k).float() for k in list(w)}

    def readings(self, outputs, precision: str = "f32") -> List[Check]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        lim = self.cell.limits
        p = self.reference_weights()
        rows = int(self.mix.get("reference_rows", 1))
        got: Dict[str, List[float]] = {n: [] for n in
                                       ("logit", "widest", "ssm", "conv", "kv")}
        for k, (last, caches) in outputs:
            want_last, want = self.ref.prefill(p, self.pool[k], self.config, rows)
            states = flat_states(caches)
            last = last.reshape(want_last.shape)
            got["logit"].append(rel_err(last, want_last))
            got["widest"].append(max_gap(last, want_last))
            got["ssm"].append(worst_layer(states["ssm"], want["ssm"]))
            got["conv"].append(max(worst_layer(states["conv_x"], want["conv_x"]),
                                   worst_layer(states["conv_bc"], want["conv_bc"])))
            got["kv"].append(max(worst_layer(states["k"], want["k"]),
                                 worst_layer(states["v"], want["v"])))
        inf = [float("inf")]
        names = {"logit": "logit_rel_err", "widest": "logit_max_gap",
                 "ssm": "ssm_rel_err", "conv": "conv_rel_err", "kv": "kv_rel_err"}
        return [Check(names[n], max(v or inf), float(lim[names[n]])) for n, v in got.items()]

    def check(self) -> List[Check]:
        kept, self.kept = self.kept, []
        return self.readings(kept)

    def control(self) -> List[Check]:
        """The reference in float8 e4m3 put in the program's place."""
        p = self.reference_weights()
        rows = int(self.mix.get("reference_rows", 1))
        outs = [(k, self.ref.prefill(p, self.pool[k], self.config, rows, "fp8"))
                for k, _ in self.kept]
        del p
        self.kept = []
        return self.readings(outs)


def make(cell, seed, device, fault=None):
    return HybridPrefillWorkload(cell, seed, device, fault)
