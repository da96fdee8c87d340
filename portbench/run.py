"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the line's metrics are the
cell's end-to-end ones, with ``--trace 1`` its per-layer ones, read from the
benchmark's own profiler window. The run exits with another code than 0 and
prints no result when CUDA is missing or has fewer cards than the cell asks
for, and when a module whose top-level name is ``jax``, ``jaxlib``, ``flax``
or ``repro`` (the JAX package) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell, seed, seconds, trace, device="cuda", fault=None):
    """Run ``cell`` once on ``device``, with ``fault`` planted in the
    program (the tests'; a benchmark run plants none); returns (result
    line, checks)."""
    import torch

    from portbench import bench

    wl = bench.workload_module(cell.mix["kind"]).make(cell, seed, device, fault)
    measured, checks = bench.run_local(wl, seconds, bool(trace), T0)
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": cell.chips}
    return bench.result_line(cell, measured, checks, bool(trace), info), checks


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from portbench import bench

    bench.use_port()
    import torch

    torch.set_num_threads(1)
    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, checks = execute(cell, args.seed, args.seconds, args.trace)
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for c in bench.worst(checks):
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
