"""Dry run of every (arch x shape x mesh) cell: one counted step at the
production mesh's shape (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's memory and cost analyses. The port has no compiler
to ask: it builds the published config at full width on the ``meta``
device (shapes alone, no storage), binds a co-resident mesh of the
production shape (``launch.mesh.production_shape``: (16, 16), or
(2, 16, 16) with ``multi``) on that device, builds the cell's step with
``launch.steps`` under the production topology, and runs it once under a
:class:`~repro_torch.roofline.op_cost.CostMode`. The model code takes its
mesh paths there, every rank's rows in one region, as it does on a
co-resident mesh on the card. ``launch.mesh.make_production_mesh`` still
refuses anything but a 256- or 512-process group: a dry run is not a
production run.

The record keeps the reference's keys. Where one means something else in
the port:

* ``lower_s`` is the seconds of the counted run; ``compile_s`` is null
  (nothing compiles);
* ``roofline.flops_per_device`` and ``bytes_per_device`` are the count over
  ``n_chips``. The co-resident rank rows hold every rank's work, and the
  work outside a region, done once on the global value, is assumed split
  evenly over the chips, as the reference's partitioner would split it;
* collectives (``compat``'s ``psum`` / ``pmax`` / ``pmean`` as all-reduce,
  ``all_to_all``, ``ppermute`` as collective-permute) are counted per
  rank: one a call, at one rank's payload under the ring model. The
  backward of a co-resident collective is counted as the aten ops autograd
  runs for it (its gradient is no charged region);
* ``memory.argument_size_bytes`` / ``output_size_bytes`` are per device,
  from ``sharding.rules``' specs: each leaf's bytes over the mesh axes its
  spec names; ``temp_size_bytes`` is the peak of the result storage alive
  during the run, over ``n_chips``; ``generated_code_size_bytes`` is null;
* ``raw_cost_analysis.flops`` is ``torch.utils.flop_counter``'s
  ``FlopCounterMode`` total of the same run (torch's own count, matmuls and
  attention only, the plain versions inside kernel regions included) over
  ``n_chips``, the counterpart of XLA's per-device ``cost_analysis()``;
  ``bytes_accessed`` is null (torch counts none);
* a decode cell's ``cache_len``, a traced scalar in the reference, is the
  last position (``seq_len - 1``): the step's shapes and masks span the
  whole cache either way.

``useful_flops_ratio``, ``params_*`` and ``opt`` are the reference's.
Records go to ``build/dryrun_torch/`` by default (not the reference's
``benchmarks/artifacts/dryrun``).

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Optional, Sequence

import torch

from repro_torch import perf_flags
from repro_torch.compat import Mesh, P
from repro_torch.configs import SHAPES, applicable_shapes, get_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core.trees import tree_leaves, tree_map
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.steps import (
    build_decode_step,
    build_prefill_step,
    build_train_step,
)
from repro_torch.models import build_model, input_specs
from repro_torch.optim.adamw import init_opt_state
from repro_torch.roofline.analysis import analyze, model_flops
from repro_torch.roofline.op_cost import CostMode
from repro_torch.sharding.rules import batch_specs, cache_specs
from repro_torch.sharding.specs import make_topology, use_topology

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"


def _spec_bytes(mesh: Mesh, tree: Any, specs: Any) -> int:
    """Per-device bytes of ``tree`` laid out by ``specs`` (a :class:`P`
    for every leaf, or a dict mirroring the tree): each leaf's bytes over
    the product of the mesh axes its spec names."""
    if isinstance(specs, P):
        return sum(_leaf_bytes(mesh, a, specs) for a in tree_leaves(tree))
    return sum(_spec_bytes(mesh, tree[k], specs[k]) for k in tree)


def _leaf_bytes(mesh: Mesh, a: Any, spec: P) -> int:
    split = 1
    for entry in spec:
        for name in (() if entry is None else
                     (entry,) if isinstance(entry, str) else entry):
            split *= mesh.shape[mesh.axis(name)]
    return math.prod(a.shape) * a.element_size() // split


def _materialize(tree: Any, device: torch.device) -> Any:
    """``meta`` input stand-ins as zeros on ``device`` (``meta`` keeps
    them as they are)."""
    if device.type == "meta":
        return tree
    return tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                          device=device), tree)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Optional[Path] = None, tag: str = "",
             device: str = "meta") -> dict:
    """Count one cell's step and write its record (see the module
    docstring); returns the record."""
    from torch.utils.flop_counter import FlopCounterMode

    out_dir = ART_DIR if out_dir is None else Path(out_dir)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mshape, names = production_shape(multi_pod=(mesh_kind == "multi"))
    mesh = Mesh(mshape, names, device=device)
    dev = mesh.device
    topo = make_topology(mesh)
    n_chips = mesh.size
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(0), device=dev)
    flop_counter = FlopCounterMode(display=False)

    with use_topology(topo):
        if shape.kind == "train":
            step, (_, _, bshapes), (pspec, ospec, bspec) = (
                build_train_step(api, topo, shape))
            opt = init_opt_state(model)
            args = (model, opt, _materialize(bshapes, dev))
            arg_bytes = (_spec_bytes(mesh, model.state_dict(), pspec)
                         + _spec_bytes(mesh, opt, ospec)
                         + _spec_bytes(mesh, bshapes, bspec))
        elif shape.kind == "prefill":
            step, (_, bshapes), (pspec, bspec) = build_prefill_step(
                api, topo, shape)
            args = (model, _materialize(bshapes, dev))
            arg_bytes = (_spec_bytes(mesh, model.state_dict(), pspec)
                         + _spec_bytes(mesh, bshapes, bspec))
        else:  # decode
            step, (_, bshapes), (pspec, cspec) = build_decode_step(
                api, topo, shape)
            cache = _materialize(bshapes["cache"], dev)
            token = _materialize(bshapes["token"], dev)
            args = (model, token, cache, shape.seq_len - 1)
            arg_bytes = (_spec_bytes(mesh, model.state_dict(), pspec)
                         + _spec_bytes(mesh, {"token": token},
                                       batch_specs({"token": token}, topo))
                         + _spec_bytes(mesh, cache, cspec))
        t0 = time.time()
        with flop_counter, CostMode() as mode:
            out = step(*args)
        t_run = time.time() - t0

    if shape.kind == "train":
        new_model, new_opt, metrics = out
        out_bytes = (_spec_bytes(mesh, new_model.state_dict(), pspec)
                     + _spec_bytes(mesh, new_opt, ospec)
                     + sum(a.element_size() * a.numel()
                           for a in tree_leaves(metrics)))
    else:  # (last logits or next token: the batch over DP, caches)
        head, cache = out
        out_bytes = (_spec_bytes(mesh, {"head": head},
                                 batch_specs({"head": head}, topo))
                     + _spec_bytes(mesh, cache, cache_specs(cache, cfg, topo)))

    cost = mode.cost
    roof = analyze(cost, n_chips)
    mf = model_flops(cfg, shape, shape.kind)
    flops_total = roof.flops_per_device * n_chips
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "n_chips": n_chips,
        "kind": shape.kind,
        "lower_s": round(t_run, 1),
        "compile_s": None,
        "memory": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": mode.peak_bytes // n_chips,
            "generated_code_size_bytes": None,
        },
        "roofline": roof.as_dict(),
        "collectives": {
            "counts": dict(cost.coll_counts),
            "wire_bytes": dict(cost.coll_bytes),
        },
        "raw_cost_analysis": {
            "flops": float(flop_counter.get_total_flops()) / n_chips,
            "bytes_accessed": None,
        },
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / flops_total) if flops_total else None,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "opt": dataclasses.asdict(perf_flags.FLAGS),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    out_path.write_text(json.dumps(record, indent=2))
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", type=str, default=str(ART_DIR))
    ap.add_argument("--opt", type=str, default="",
                    help="perf flags, e.g. seq_shard_attn=1,remat_policy=save_block_outputs")
    ap.add_argument("--tag", type=str, default="",
                    help="artifact filename suffix for perf iterations")
    ap.add_argument("--device", type=str, default="meta",
                    help="where the step runs: meta (shapes alone), cpu or cuda")
    args = ap.parse_args(argv)
    perf_flags.parse_opt_string(args.opt)
    out_dir = Path(args.out)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in applicable_shapes(get_config(arch)):
                for m in meshes:
                    cells.append((arch, shape, m))
    else:
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape, m in cells:
        tag = f"{arch} x {shape} x {m}"
        path = out_dir / f"{arch}__{shape}__{m}.json"
        if args.skip_existing and path.exists():
            print(f"[skip] {tag}")
            continue
        try:
            rec = run_cell(arch, shape, m, out_dir, tag=args.tag,
                           device=args.device)
            r = rec["roofline"]
            print(
                f"[ok]   {tag}: run={rec['lower_s']}s "
                f"flops/dev={r['flops_per_device']:.3e} "
                f"bytes/dev={r['bytes_per_device']:.3e} "
                f"coll={r['collective_bytes_per_device']:.3e}B "
                f"bottleneck={r['bottleneck']}", flush=True,
            )
        except Exception:
            failures += 1
            print(f"[FAIL] {tag}", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
