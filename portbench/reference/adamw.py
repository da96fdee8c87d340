"""Plain AdamW with global-norm clipping and a linear-warmup cosine schedule,
in float32 over a ``{name: tensor}`` dict: the optimizer the training
configuration states (``optimizer`` in its file)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def learning_rate(step: int, c: Dict[str, float]) -> float:
    if step < c["warmup_steps"]:
        return c["lr"] * step / max(c["warmup_steps"], 1)
    prog = min(max((step - c["warmup_steps"]) / max(c["total_steps"] - c["warmup_steps"], 1), 0.0), 1.0)
    return c["lr"] * (c["min_lr_ratio"] + (1 - c["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """``step(grads)`` updates ``params`` (float32) in place."""

    def __init__(self, params: Dict[str, torch.Tensor], c: Dict[str, float]):
        self.params, self.c = params, c
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns each leaf's gradient as clipped."""
        c = self.c
        self.count += 1
        norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
        scale = min(1.0, c["clip_norm"] / max(norm, 1e-9))
        lr = learning_rate(self.count, c)
        b1c = 1 - c["b1"] ** self.count
        b2c = 1 - c["b2"] ** self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.m[k].mul_(c["b1"]).add_(g, alpha=1 - c["b1"])
            self.v[k].mul_(c["b2"]).add_(g * g, alpha=1 - c["b2"])
            upd = (self.m[k] / b1c) / (torch.sqrt(self.v[k] / b2c) + c["eps"])
            p.sub_(lr * (upd + c["weight_decay"] * p))
        return clipped
