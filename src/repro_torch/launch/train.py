"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 100 --batch 8 --seq 128 [--full] [--ckpt-dir DIR] [--device cpu]

The arguments are the reference's, plus ``--device`` (the card unless
``cpu`` is named). ``--reduced`` is on unless ``--full``; the weights come
from seed 0 (a ``torch.Generator``), the data from the seeded numpy
pipeline. ``--mesh production`` needs the 256-rank production mesh and
raises on fewer ranks, as ``launch.mesh`` says; ``--offload-engine``
dispatches the step's collectives through the offload engine (a no-op
without a mesh, as in the reference). ``--fail-at`` injects simulated
failures, ``--opt`` sets perf flags (``remat_policy=save_block_outputs``).
The checkpoint directory defaults to ``repro_torch_ckpt`` under the
temporary directory. :func:`main` returns the run's history, so a script
can drive the launcher as a user would.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Dict, List, Optional

from repro_torch import perf_flags
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault import FailureInjector
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.sharding.specs import Topology, make_topology


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", choices=["none", "production"], default="none")
    ap.add_argument(
        "--offload-engine", action="store_true",
        help="dispatch the step's gradient/metric collectives through the "
             "offload engine as planned descriptors (pure-DP meshes)",
    )
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated failures at these steps")
    ap.add_argument("--opt", default="", help="perf flags k=v,...")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    perf_flags.parse_opt_string(args.opt)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg)
    if args.mesh == "production":
        from repro_torch.launch.mesh import make_production_mesh
        topo = make_topology(make_production_mesh(device=args.device))
    else:
        topo = Topology(mesh=None)

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    data = batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch,
    ))
    tr = Trainer(
        api, topo, shape, data,
        TrainerConfig(
            ckpt_dir=args.ckpt_dir, ckpt_every=25,
            use_offload_engine=args.offload_engine,
        ),
        AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
        injector=FailureInjector(fail_at=tuple(args.fail_at)),
        device=args.device,
    )
    params, opt = tr.init_state()
    start, params, opt = tr.maybe_restore(params, opt)
    if start:
        print(f"resumed from checkpoint at step {start}")
    params, opt, hist = tr.run(params, opt, args.steps, start_step=start)
    for h in hist[:: max(1, len(hist) // 12)]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.2f} {h['step_time_s']*1e3:.0f}ms")
    if hist:
        print(f"final loss: {hist[-1]['loss']:.4f}; "
              f"remesh events: {len(tr.remesh_events)}; "
              f"straggler flags: {len(tr.straggler.events)}")
    return {"start": start, "history": hist, "config": cfg,
            "remesh_events": tr.remesh_events,
            "straggler_flags": len(tr.straggler.events)}


if __name__ == "__main__":
    main()
