"""The profiler leg of the fusion check (counterpart of the last leg of
``repro.testing.fusion_check``; its bitwise legs are covered by
:mod:`repro_torch.testing.spmd_check`).

    python -m repro_torch.testing.fusion_check [--device cpu]

An optimized (pass-pipeline) planned SCAN over a (2, 4) mesh dispatches in
driver mode (the engine's own ``shard_map`` over a co-resident
:class:`~repro_torch.compat.Mesh`) under ``profile_offload``, on the card
or, with ``--device cpu``, on the CPU. On a card the latency must be
*profiler-sourced*: a wall-clock fallback means the trace pipeline broke
and fails the check. On the CPU there is no device event, so the dispatch
must come back ``"wall"`` with its reason counted. The profiled dispatch's
result is also held bitwise against the same descriptor in sim mode.

Prints a ``fusion_check_summary`` CSV row and ALL-OK; exits nonzero on any
violation.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from repro_torch.compat import Mesh
from repro_torch.offload import OffloadEngine

AXES = (2, 4)
AXIS_NAMES = ("outer", "inner")


def main(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(prog="repro_torch.testing.fusion_check")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    eng = OffloadEngine(device=args.device)
    mesh = Mesh(AXES, AXIS_NAMES, device=eng.device)
    p = int(np.prod(AXES))
    n = 16
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.integers(-8, 9, size=(p, n)).astype(np.float32)
    ).to(eng.device)
    failures = 0

    def check(name, ok):
        nonlocal failures
        print(f"fusion {name:44s} {'OK' if ok else 'FAIL'}")
        failures += 0 if ok else 1

    d_opt = eng.make_descriptor(
        "SCAN", axes=AXES, payload_bytes=n * 4, op="sum",
        split=(0, 1), optimize=True,
    )
    check("descriptor is optimized", d_opt.optimized)
    timing = eng.profile_offload(d_opt, x, axis_name=AXIS_NAMES, mesh=mesh)
    got = eng.offload(d_opt, x, axis_name=AXIS_NAMES, mesh=mesh)
    check("driver scan == sim scan", torch.equal(got, eng.offload(d_opt, x)))
    snap = eng.telemetry.snapshot()
    dev_us = snap["device_latency_by_coll_us"].get("scan", 0.0)
    print(f"fusion profiled scan device_us={dev_us:.1f} "
          f"wall_us={timing.wall_us:.1f} source={timing.source} "
          f"events={timing.events}")
    check("device latency recorded", dev_us > 0)
    if eng.device.type == "cuda":
        check("latency source is the profiler", (
            timing.source == "profiler"
            and snap["latency_source_by_coll"].get("scan") == "profiler"
        ))
        check("0 < device_us <= wall_us",
              0 < timing.device_us <= timing.wall_us)
    else:
        check("CPU profile falls back to wall, reason counted", (
            timing.source == "wall"
            and snap["profiler_fallback_reasons"].get(
                timing.fallback_reason, 0) >= 1
        ))
    print(
        f"fusion_check_summary,device_latency,{int(dev_us > 0)},"
        f"source,{timing.source},events,{timing.events}"
    )
    if failures:
        print(f"FAILURES: {failures}")
        return 1
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
