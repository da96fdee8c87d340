"""The readings a cell's limits are set from, on the card at the cell's size.

    python -m portbench.control --workload <cell> --seeds 12 --control-seeds 3 \
        [--faults half,altered] [--seconds 2] [--out control.jsonl]

In one process, for each seed: the program's reading of every number that
decides ``correct`` (set-up, a short window at the cell's load, the
comparison); for each control seed the control's (the reference in the next
precision down, put in the program's place); for each fault and control seed
the program with that fault planted (``faults.py``). One JSON line a reading
goes to ``--out``; the last line printed sums them up: for each number the
largest sound reading and the smallest control and fault readings. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def readings(cell, seed, seconds, *, control=False, fault=None, device="cuda"):
    """One seed's checks: ``{name: value}``."""
    from portbench import bench, faults

    module = bench.workload_module(cell.mix["kind"])
    undo = faults.apply(fault)
    try:
        wl = module.make(cell, seed, device)
        wl.setup()
        bench.timed_window(wl, seconds)
        wl.release()
        checks = wl.control() if control else wl.check()
    finally:
        undo()
    return {c.name: c.value for c in checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default="control.jsonl")
    args = ap.parse_args(argv)

    from portbench import bench

    bench.use_port()
    import torch

    torch.set_num_threads(1)
    cell = bench.load_cell(args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    plan = [("program", None, s) for s in range(args.seeds)]
    plan += [("control", None, s) for s in range(args.control_seeds)]
    plan += [("fault", f, s) for f in filter(None, args.faults.split(","))
             for s in range(args.control_seeds)]
    summary = {}
    with open(out, "a") as f:
        for kind, fault, s in plan:
            seed = args.first_seed + 7919 * s
            t = time.perf_counter()
            try:
                got = readings(cell, seed, args.seconds, control=kind == "control",
                               fault=fault)
            except Exception as exc:  # a control or fault that crashes has failed
                got = {"error": f"{type(exc).__name__}: {exc}"[:400]}
            row = {"cell": cell.name, "kind": kind, "fault": fault, "seed": seed,
                   "readings": got, "seconds": time.perf_counter() - t}
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)
            label = kind if fault is None else f"fault:{fault}"
            for name, value in got.items():
                if name == "error":
                    continue
                lo_hi = summary.setdefault(name, {})
                key = "program_max" if kind == "program" else f"{label}_min"
                pick = max if kind == "program" else min
                lo_hi[key] = value if key not in lo_hi else pick(lo_hi[key], value)
    print(json.dumps({"cell": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
