"""Sequence-parallel Mamba2 (``dist_exscan`` across shards) against the
unsharded mixer (counterpart of ``repro.testing.mamba_sp_check``).

The SP path shards the sequence over an 8-way model axis; its output and
final SSD state must match the unsharded mixer. Inter-chunk state crosses
shards through the offloaded scan collective, and the conv halo through a
neighbour ``ppermute``. The reference's three numeric checks, at its
tolerances: output and final SSD state within atol = rtol = 2e-3, conv
tail within 1e-4. Its fourth, a gradient through ``dist_exscan``: the
gradient of ``sum(y * y)`` with respect to the mixer's parameters, taken
through the SP mixer on the co-resident mesh, must be finite and nonzero
(the reference's check) and, beyond the reference, within ``GRAD_TOL`` of
each leaf's largest magnitude of the unsharded mixer's gradient.

    python -m repro_torch.testing.mamba_sp_check [--device cpu|cuda] [--gloo WORKDIR]

runs the reduced Mamba2-130m mixer at ``(B, S) = (2, 128)`` (8 shards of
16 tokens, chunk 16) on a co-resident ``(1, 8)`` mesh on the device (the
card unless ``--device cpu``); with ``--gloo`` also its forward in 8
processes joined in one gloo group on the CPU, held bitwise against the
co-resident run (a process group's collectives carry no gradient).
Prints ALL-OK.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

MESH = ((1, 8), ("data", "model"))
SHAPE = (2, 128)
#: (atol, rtol) of the output and the final SSD state; the conv tail's atol
TOL = 2e-3
CONV_TOL = 1e-4
#: the SP gradient's gap to the unsharded one, relative to each leaf's
#: largest magnitude
GRAD_TOL = 2e-3


def make_inputs(cfg, device, shape=SHAPE, seed: int = 0):
    """The mixer's weights from ``torch.Generator().manual_seed(seed)`` and
    ``x`` from ``numpy.random.default_rng(seed)`` (times 0.1, as the
    reference's check draws it), on ``device``."""
    import torch

    from repro_torch.models.mamba import init_mamba

    p = init_mamba(torch.Generator().manual_seed(seed), cfg, torch.float32,
                   device)
    rng = np.random.default_rng(seed)
    B, S = shape
    x = torch.from_numpy(
        rng.normal(size=(B, S, cfg.d_model)).astype(np.float32) * 0.1)
    return p, x.to(device)


def sp_mixer(p, x, cfg, mesh):
    """``mamba_mixer(seq_parallel=True)`` under ``mesh``'s topology."""
    from repro_torch.models.mamba import mamba_mixer
    from repro_torch.sharding import make_topology, use_topology

    with use_topology(make_topology(mesh)):
        return mamba_mixer(p, x, cfg, seq_parallel=True)


def compare(torch, y_ref, cache_ref, y_sp, cache_sp) -> List[tuple]:
    """The reference check's three comparisons: (name, ok, max error)."""
    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    return [
        ("seq-parallel output",
         bool(torch.allclose(y_sp, y_ref, atol=TOL, rtol=TOL)),
         err(y_sp, y_ref)),
        ("final SSD state",
         bool(torch.allclose(cache_sp["ssm"], cache_ref["ssm"], atol=TOL,
                             rtol=TOL)),
         err(cache_sp["ssm"], cache_ref["ssm"])),
        ("conv tail",
         bool(torch.allclose(cache_sp["conv_x"], cache_ref["conv_x"],
                             atol=CONV_TOL, rtol=0.0)),
         err(cache_sp["conv_x"], cache_ref["conv_x"])),
    ]


def mixer_grads(torch, p, fn):
    """``{name: d sum(y*y) / d param}`` of the mixer ``p`` through ``fn()``
    (which returns ``(y, cache)``)."""
    p.requires_grad_(True)
    names, params = zip(*p.named_parameters())
    with torch.enable_grad():
        y, _ = fn()
        grads = torch.autograd.grad((y * y).sum(), params)
    return dict(zip(names, grads))


def compare_grads(torch, g_sp, g_ref):
    """The fourth check: (name, ok, worst leaf's gap over its largest
    magnitude) for a finite, nonzero SP gradient held to the unsharded
    one."""
    total = sum(float(g.double().abs().sum()) for g in g_sp.values())
    finite = all(bool(torch.isfinite(g).all()) for g in g_sp.values())
    worst = max(float((g_sp[k].double() - g.double()).abs().max())
                / max(float(g.double().abs().max()), 1e-30)
                for k, g in g_ref.items())
    return [("grad through dist_exscan", finite and total > 0.0, total),
            ("grad == unsharded mixer's", worst <= GRAD_TOL, worst)]


def _reduced_cfg():
    from repro_torch.configs import get_config

    return get_config("mamba2_130m").reduced()


def _gloo_body(make_mesh) -> Dict[str, Any]:
    cfg = _reduced_cfg()
    p, x = make_inputs(cfg, "cpu")
    y, cache = sp_mixer(p, x, cfg, make_mesh(*MESH))
    return {"y": y, **cache}


def run_gloo(workdir, *, timeout: float = 120.0) -> Dict[str, Any]:
    """The SP mixer in 8 processes joined in one gloo group: rank 0's
    global output and cache."""
    from repro_torch.testing.spmd_check import spawn_gloo

    return spawn_gloo("repro_torch.testing.mamba_sp_check", ["--worker"],
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
    from repro_torch.models.mamba import mamba_mixer
    from repro_torch.models.model import model_device

    device = model_device(args.device)
    cfg = _reduced_cfg()
    p, x = make_inputs(cfg, device)
    y_ref, cache_ref = mamba_mixer(p, x, cfg, seq_parallel=False)
    mesh = compat.Mesh(*MESH, device=device)
    y_sp, cache_sp = sp_mixer(p, x, cfg, mesh)
    checks = compare(torch, y_ref, cache_ref, y_sp, cache_sp)
    checks += compare_grads(
        torch, mixer_grads(torch, p, lambda: sp_mixer(p, x, cfg, mesh)),
        mixer_grads(torch, p, lambda: mamba_mixer(p, x, cfg,
                                                  seq_parallel=False)))
    if args.gloo:
        got = run_gloo(args.gloo)
        want = {"y": y_sp, **cache_sp}
        checks.append(("gloo bitwise == co-resident",
                       all(torch.equal(got[k], want[k].cpu()) for k in want),
                       max(float((got[k] - want[k].cpu()).abs().max())
                           for k in want)))
    for name, ok, err in checks:
        print(f"{name}:", "OK" if ok else "FAIL", err)
    if all(ok for _, ok, _ in checks):
        print("ALL-OK")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
