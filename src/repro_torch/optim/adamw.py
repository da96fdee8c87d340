"""AdamW with float32 master weights, global-norm clipping and a cosine
schedule (port of ``repro.optim.adamw``).

Parameters are a module's ``named_parameters`` (or a ``{name: tensor}``
dict); optimizer state is ``{"m", "v", "master"}``, each a ``{name:
float32 tensor}`` dict under the same names, and ``"count"`` (0-d int32).
The update is the reference's, leaf by leaf, in float32. Where the
reference returns new working parameters (``master.astype(p.dtype)``), the
port copies ``master`` cast to each parameter's dtype into the parameter
itself under ``torch.no_grad()``: the module keeps its tensors and stays
what the caller holds.

ZeRO-1 is a sharding of this state (:func:`repro_torch.sharding.rules.
zero1_specs`); on one card it is metadata and the state stays whole.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Dict[str, torch.Tensor]]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named(params: Params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_at(step: torch.Tensor, c: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in float32."""
    step = torch.as_tensor(step).float()
    warm = c.lr * step / max(c.warmup_steps, 1)
    prog = torch.clamp(
        (step - c.warmup_steps) / max(c.total_steps - c.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = c.lr * (
        c.min_lr_ratio
        + (1 - c.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    )
    return torch.where(step < c.warmup_steps, warm, cos)


def init_opt_state(params: Params) -> Dict[str, Any]:
    """Zero moments and a float32 copy of every parameter (never aliasing
    it), on the parameters' device."""
    ps = named(params)
    with torch.no_grad():
        return {
            "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in ps.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in ps.items()},
            "master": {k: p.detach().float().clone() for k, p in ps.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device_of(ps)),
        }


def _device_of(ps: Dict[str, torch.Tensor]) -> torch.device:
    for p in ps.values():
        return p.device
    return torch.device("cpu")


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


@torch.no_grad()
def adamw_update(
    grads: Dict[str, torch.Tensor],
    opt_state: Dict[str, Any],
    params: Params,
    cfg: AdamWConfig,
) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns ``(params, new_opt_state, stats)``:
    ``params`` updated in place (``master`` cast to each parameter's dtype),
    ``stats`` = ``{grad_norm, lr}`` with the raw norm before clipping."""
    ps = named(params)
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(count, cfg)
    cf = count.float()
    b1c = 1 - cfg.b1 ** cf
    b2c = 1 - cfg.b2 ** cf
    new_m, new_v, new_master = {}, {}, {}
    for k, g in grads.items():
        g = g.float() * scale
        m = cfg.b1 * opt_state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * opt_state["v"][k] + (1 - cfg.b2) * torch.square(g)
        mhat = m / b1c
        vhat = v / b2c
        master = opt_state["master"][k]
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * master
        new_m[k], new_v[k] = m, v
        new_master[k] = master - lr * step
        ps[k].copy_(new_master[k].to(ps[k].dtype))
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": new_m, "v": new_v, "master": new_master,
                    "count": count}, stats
