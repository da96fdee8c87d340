"""Expert-parallel MoE against the dropless dense dispatch (counterpart of
``repro.testing.moe_check``).

With a generous capacity factor (8.0: no drops) the EP sort / ``all_to_all``
path must reproduce ``_dense_moe``: outputs within atol = rtol = 2e-4,
``load_balance`` within 1e-3. At capacity factor 0.25 the result must be
finite, and at ``DROP_SHAPE`` some picks are dropped (:func:`dropped_picks`).

    python -m repro_torch.testing.moe_check [--device cpu|cuda] [--gloo WORKDIR]

runs the reduced OLMoE block with 8 experts, top-2, on a co-resident
``(2, 4)`` mesh on the device (the card unless ``--device cpu``), in the
four token layouts of ``moe_block`` (sequence over the model axis; the
model axis folded into the batch; batch over data only; replicated); with
``--gloo`` also in 8 processes joined in one gloo group on the CPU, held
bitwise against the co-resident run. Prints ALL-OK.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

MESH = ((2, 4), ("data", "model"))
#: (B, S) of each of moe_block's token layouts on a (2, 4) mesh
LAYOUTS = {"seq": (4, 16), "batch_fold": (8, 1), "batch": (2, 1),
           "replicated": (1, 1)}
#: (B, S) of the capacity-0.25 run: 64 picks a rank for 8 experts of
#: capacity 8, so some are dropped
DROP_SHAPE = (4, 64)
TOL = 2e-4
LB_TOL = 1e-3


def reduced_cfg(capacity_factor: float = 8.0):
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("olmoe_1b_7b").reduced(), moe_num_experts=8, moe_top_k=2,
        capacity_factor=capacity_factor,
    )


def make_inputs(cfg, device, shape, seed: int = 0):
    """The block's weights from ``torch.Generator().manual_seed(seed)`` and
    ``x`` of ``shape`` from ``numpy.random.default_rng(seed)``."""
    import torch

    from repro_torch.models.moe import init_moe

    p = init_moe(torch.Generator().manual_seed(seed), cfg, torch.float32,
                 device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.normal(size=tuple(shape) + (cfg.d_model,)).astype(np.float32))
    return p, x.to(device)


def ep_block(p, x, cfg, mesh):
    """``moe_block`` under ``mesh``'s topology: (y, aux)."""
    from repro_torch.models.moe import moe_block
    from repro_torch.sharding import make_topology, use_topology

    with use_topology(make_topology(mesh)):
        return moe_block(p, x, cfg, act="silu")


def dropped_picks(p, x, cfg, mesh) -> int:
    """The top-k picks the EP region drops under ``mesh``, summed over the
    ranks: each rank's block of tokens routed as the region routes it, the
    picks past an expert's capacity counted."""
    import torch
    import torch.nn.functional as F

    from repro_torch import compat
    from repro_torch.compat import P
    from repro_torch.models.moe import _router, token_spec
    from repro_torch.sharding import make_topology

    E, k = cfg.moe_num_experts, cfg.moe_top_k

    def region(x_l):
        R, B, S, d = x_l.shape
        n = B * S
        C = int(math.ceil(n * k / E * cfg.capacity_factor))
        C = max(8, -(-C // 8) * 8)
        logits = x_l.reshape(R, n, d).float() @ p.router
        experts = _router(logits, k)[1].reshape(R, -1)
        return torch.clamp(F.one_hot(experts, E).sum(1) - C, min=0).sum(1, keepdim=True)

    per_rank = compat.block_shard_map(
        region, mesh, (token_spec(make_topology(mesh), *x.shape[:2]),),
        P(mesh.axis_names))(x)
    return int(per_rank.sum())


def run_layouts(p, cfg, mesh, device) -> Dict[str, Any]:
    """Every layout's EP result at ``cfg``'s capacity: name -> (y, lb, z)."""
    out = {}
    for name, shape in LAYOUTS.items():
        _, x = make_inputs(cfg, device, shape)
        y, aux = ep_block(p, x, cfg, mesh)
        out[name] = (y, aux["load_balance"], aux["router_z"])
    return out


def _gloo_body(make_mesh) -> Dict[str, Any]:
    cfg = reduced_cfg()
    p, _ = make_inputs(cfg, "cpu", LAYOUTS["seq"])
    mesh = make_mesh(*MESH)
    got = run_layouts(p, cfg, mesh, "cpu")
    drop_cfg = reduced_cfg(0.25)
    _, x = make_inputs(drop_cfg, "cpu", DROP_SHAPE)
    got["drop"] = ep_block(p, x, drop_cfg, mesh)[0]
    return got


def run_gloo(workdir, *, timeout: float = 120.0) -> Dict[str, Any]:
    """Every layout (and the capacity-0.25 run, ``"drop"``) in 8 processes
    joined in one gloo group: rank 0's global results."""
    from repro_torch.testing.spmd_check import spawn_gloo

    return spawn_gloo("repro_torch.testing.moe_check", ["--worker"],
                      int(np.prod(MESH[0])), workdir, timeout=timeout)


def main(argv: List[str]) -> int:
    if argv[:1] == ["--worker"]:
        from repro_torch.testing.spmd_check import gloo_worker

        gloo_worker(int(argv[1]), int(argv[3]), Path(argv[2]), _gloo_body)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--gloo", default=None, metavar="WORKDIR",
                    help="also run in 8 gloo processes on the CPU")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import compat
    from repro_torch.models.model import model_device
    from repro_torch.models.moe import _dense_moe

    device = model_device(args.device)
    cfg = reduced_cfg()
    p, _ = make_inputs(cfg, device, LAYOUTS["seq"])
    mesh = compat.Mesh(*MESH, device=device)
    got = run_layouts(p, cfg, mesh, device)
    checks = []
    for name, shape in LAYOUTS.items():
        _, x = make_inputs(cfg, device, shape)
        want, aux = _dense_moe(p, x, cfg, "silu")
        y, lb, _ = got[name]
        checks.append((f"ep-vs-dense outputs ({name} {shape})",
                       bool(torch.allclose(y, want, atol=TOL, rtol=TOL)),
                       float((y - want).abs().max())))
        checks.append((f"aux load_balance ({name})",
                       abs(float(lb) - float(aux["load_balance"])) < LB_TOL,
                       abs(float(lb) - float(aux["load_balance"]))))
    drop_cfg = reduced_cfg(0.25)
    _, x = make_inputs(drop_cfg, device, DROP_SHAPE)
    y_drop, _ = ep_block(p, x, drop_cfg, mesh)
    dropped = dropped_picks(p, x, drop_cfg, mesh)
    checks.append(("capacity-drop finite, picks dropped",
                   bool(torch.isfinite(y_drop).all()) and dropped > 0, dropped))
    if args.gloo:
        res = run_gloo(args.gloo)
        same = all(torch.equal(a.cpu(), b) for name in LAYOUTS
                   for a, b in zip(got[name], res[name]))
        same = same and torch.equal(y_drop.cpu(), res["drop"])
        checks.append(("gloo bitwise == co-resident", same, 0.0))
    for name, ok, err in checks:
        print(f"{name}:", "OK" if ok else "FAIL", err)
    if all(ok for _, ok, _ in checks):
        print("ALL-OK")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
