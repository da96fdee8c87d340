"""int8 + error-feedback gradient sync: convergence parity against float32
data parallelism (counterpart of ``repro.testing.compressed_dp_check``).

An 8-way data-parallel toy regression trained twice on a co-resident
``("dp",)`` mesh — an exact ``compat.pmean`` against
``compressed_allreduce_mean`` — inside ``compat.block_shard_map``, as the
reference runs it in ``shard_map``: both final losses must reach 5e-3. As
in the reference, the error-feedback buffer leaves the region under
``P()``, so every rank starts the next step from rank 0's residual.

    python -m repro_torch.testing.compressed_dp_check [--device cpu|cuda]

Prints ALL-OK.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np

RANKS = 8
STEPS = 150
TOL = 5e-3


def run(device) -> Dict[bool, float]:
    """The final mse of the float32 run (False) and the compressed one
    (True)."""
    import torch

    from repro_torch import compat
    from repro_torch.compat import P
    from repro_torch.optim.compression import compressed_allreduce_mean

    mesh = compat.Mesh((RANKS,), ("dp",), device=device)
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(16,)).astype(np.float32)
    X = rng.normal(size=(RANKS, 64, 16)).astype(np.float32)  # per-rank shards
    y = X @ w_true + 0.01 * rng.normal(size=(RANKS, 64)).astype(np.float32)
    Xt, yt = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)

    def make_train(compressed: bool):
        def step(w, err, Xl, yl):
            # rank rows lead every leaf; strip the sharded rank dim
            Xl, yl = Xl[:, 0], yl[:, 0]
            pred = torch.einsum("rnf,rf->rn", Xl, w)
            g = torch.einsum("rnf,rn->rf", Xl, pred - yl) / yl.shape[-1]
            if compressed:
                gm, err = compressed_allreduce_mean({"w": g}, "dp", err)
                g = gm["w"]
            else:
                g = compat.pmean(g, "dp")
            return w - 0.1 * g, err

        return compat.block_shard_map(
            step, mesh,
            in_specs=(P(), {"w": P()}, P("dp", None, None), P("dp", None)),
            out_specs=(P(), {"w": P()}),
        )

    losses = {}
    for compressed in (False, True):
        w = torch.zeros(16, device=device)
        err = {"w": torch.zeros(16, device=device)}
        train = make_train(compressed)
        for _ in range(STEPS):
            w, err = train(w, err, Xt, yt)
        w_np = w.cpu().numpy()
        losses[compressed] = float(np.mean(
            (X.reshape(-1, 16) @ w_np - y.reshape(-1)) ** 2))
    return losses


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    from repro_torch.models.model import model_device

    losses = run(model_device(args.device))
    for compressed, loss in losses.items():
        print(f"compressed={compressed}: final mse {loss:.5f}")
    ok = losses[True] < TOL and losses[False] < TOL
    print("convergence parity:", "OK" if ok else "FAIL")
    print("ALL-OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
