#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. device  — the card, its power limit, TF32 off, the kernel library built
             from ``src/repro_torch/kernels/csrc`` with nvcc.
2. kernel  — K1 (the fused collective kernel) against its plain PyTorch
             version on the card, for every phase kind, operator and wire
             dtype, over several rank counts, a ragged width, NaN inputs and
             a rank count large enough for the global-scratch column path.
3. main    — the port's main path: ``OffloadEngine()`` (on the GPU by
             default) -> ``make_descriptor(..., backend="pallas", chunks=1)``
             -> ``offload`` for SCAN, EXSCAN, ALLREDUCE and BARRIER at
             p = 8 and 16 over the osu_scan message sizes (4 B - 1 MiB per
             rank) plus a 25 MiB ALLREDUCE, each held against the port's
             default sim lowering and, on a small input, against numpy.
             K1's launch count is zeroed right before and read right after.
4. times   — K1, its plain version and one PyTorch library call at the main
             path's shapes: device time from ``torch.profiler`` and the
             per-call time with CUDA events (host overhead included), beside
             the least time the card's memory bandwidth allows.

The line before the last is the card's name and power limit as nvidia-smi
prints them; the last line is the result object.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

#: HBM bandwidth in bytes/s from NVIDIA's data sheets, by card name
_MEM_BW = (
    ("H200", 4.8e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),
)

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_collective.cu"
KERNEL_REPLACES = "src/repro/kernels/pallas_collective.py:362"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def mem_bandwidth(name: str) -> float:
    for key, bw in _MEM_BW:
        if key in name:
            return bw
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def make_input(torch, gen, kind_op, dtype, shape, device, *, nan=False):
    """Seeded random leaves for one operator; tuples for ssd / flash."""
    def normal(shp):
        return torch.randn(shp, generator=gen, device=device)

    def uniform(lo, hi, shp):
        return lo + (hi - lo) * torch.rand(shp, generator=gen, device=device)

    if kind_op == "ssd":
        return (uniform(0.5, 1.5, shape).to(dtype), normal(shape).to(dtype))
    if kind_op == "flash":
        return (
            normal(shape).to(dtype),
            uniform(0.5, 2.0, shape).to(dtype),
            normal(shape).to(dtype),
        )
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)
    if dtype == torch.int32:
        hi = 4 if kind_op == "prod" else 1 << 30
        return torch.randint(-hi, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)
    x = uniform(0.8, 1.25, shape) if kind_op == "prod" else normal(shape)
    if nan:
        flat = x.view(-1)
        flat[:: max(1, flat.numel() // 7)] = float("nan")
    return x.to(dtype)


def leaves_of(tree):
    return list(tree) if isinstance(tree, tuple) else [tree]


def max_abs_err(torch, got, want) -> float:
    worst = 0.0
    for g, w in zip(leaves_of(got), leaves_of(want)):
        g64, w64 = g.double(), w.double()
        both_nan = torch.isnan(g64) & torch.isnan(w64)
        if bool((torch.isnan(g64) != torch.isnan(w64)).any()):
            return float("inf")
        diff = (g64 - w64).abs().masked_fill(both_nan, 0.0)
        diff = diff.masked_fill(g64 == w64, 0.0)  # equal infinities
        if diff.numel():
            worst = max(worst, float(diff.max()))
    return worst


def assert_match(torch, got, want, rtol, atol, what) -> float:
    err = max_abs_err(torch, got, want)
    for g, w in zip(leaves_of(got), leaves_of(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(
                f"{what}: {tuple(g.shape)}/{g.dtype} vs {tuple(w.shape)}/{w.dtype}"
            )
        if rtol == 0 and atol == 0:
            same = (g == w) | (torch.isnan(g.double()) & torch.isnan(w.double()))
            if not bool(same.all()):
                raise AssertionError(f"{what}: not bitwise equal (max err {err})")
        else:
            torch.testing.assert_close(
                g.double(), w.double(), rtol=rtol, atol=atol, equal_nan=True,
                msg=lambda m: f"{what}: {m}",
            )
    return err


# tolerance per (op, dtype) of K1 against its plain version; (0, 0) = bitwise.
# SUM/MAX/MIN and integer PROD repeat the plain version's arithmetic
# exactly. Float PROD and SSD are exact too (no FMA contraction), but a
# tolerance leaves room for the library's rounding of bf16/fp16 products;
# flash calls exp, whose last bit may differ between libraries.
def tolerance(torch, op, dtype):
    if op in ("sum", "max", "min") or not dtype.is_floating_point:
        return 0.0, 0.0
    scale = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}[dtype]
    return scale, scale


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    path = _build.build_all(["fused_collective"])["fused_collective"]
    build_s = time.perf_counter() - t0
    log = _build.build_log("fused_collective")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    name = torch.cuda.get_device_name(0)
    emit({
        "phase": "device",
        "name": name,
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "library": str(path.relative_to(REPO)),
        "build_s": round(build_s, 3),
        "ptxas": {
            "kernels": len(regs),
            "max_registers": max(regs) if regs else None,
            "max_spill_store_bytes": max(spills) if spills else None,
        },
    })
    return name, smi


def phase_kernel(torch, device):
    from repro_torch.core.operators import get_operator
    from repro_torch.kernels import fused_collective as fc
    from repro_torch.offload.planner import PhaseKind

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    dtypes = [torch.int32, torch.float32, torch.bfloat16, torch.float16, torch.int8]
    forms = [
        (PhaseKind.SCAN, True), (PhaseKind.SCAN, False),
        (PhaseKind.FUSED_SCAN_TOTAL, True), (PhaseKind.FUSED_SCAN_TOTAL, False),
        (PhaseKind.TOTAL, True), (PhaseKind.BARRIER, True),
    ]
    cases = 0
    worst = 0.0
    worst_by_op = {}
    for kind, inclusive in forms:
        butterfly = kind in (PhaseKind.TOTAL, PhaseKind.BARRIER)
        ps = (2, 8, 16, 64, 512) if butterfly else (2, 3, 5, 8, 16, 64, 500)
        if kind == PhaseKind.BARRIER:
            # the fence: MAX over one float32 token per rank
            combos = [("max", torch.float32)]
        else:
            combos = [(o, d) for o in ("sum", "prod", "max", "min") for d in dtypes]
            if kind == PhaseKind.TOTAL:
                combos += [(o, d) for o in ("ssd", "flash")
                           for d in (torch.float32, torch.bfloat16, torch.float16)]
        for p in ps:
            # 1000 columns: a ragged last block; p=500/512 take the global
            # scratch path (the column no longer fits in shared memory)
            width = 1 if kind == PhaseKind.BARRIER else 1000
            for opname, dtype in combos:
                if p >= 500 and (opname, dtype) not in (("sum", torch.float32),
                                                         ("max", torch.float32),
                                                         ("ssd", torch.float32)):
                    continue
                op = get_operator(opname)
                x = make_input(torch, gen, opname, dtype, (p, width), device,
                               nan=dtype.is_floating_point and opname != "prod")
                before = fc.launches
                got = fc.comm_phase(kind, p, op, x, inclusive=inclusive)
                if fc.launches != before + 1:
                    raise AssertionError("the wrapper did not launch the kernel")
                want = fc.comm_phase_plain(kind, p, op, x, inclusive=inclusive)
                torch.cuda.synchronize()
                rtol, atol = tolerance(torch, opname, dtype)
                what = f"{kind.name} incl={inclusive} p={p} {opname} {dtype}"
                pairs = [(got, want)]
                if kind == PhaseKind.FUSED_SCAN_TOTAL:
                    pairs = list(zip(got, want))
                for g, w in pairs:
                    err = assert_match(torch, g, w, rtol, atol, what)
                    if dtype == torch.float32 and opname in ("sum", "max", "min"):
                        worst = max(worst, err)
                    key = f"{opname}:{str(dtype).replace('torch.', '')}"
                    worst_by_op[key] = max(worst_by_op.get(key, 0.0), err)
                cases += 1

    # leaves of unequal shapes: SSD's decay and flash's (m, l) broadcast
    # against the state (one launch, results sliced back to each leaf's
    # shape); an elementwise op over a two-leaf payload (one launch a leaf)
    p = 8
    ssd = (make_input(torch, gen, "ssd", torch.float32, (p, 1), device)[0],
           make_input(torch, gen, "ssd", torch.float32, (p, 1000), device)[1])
    m, l, _ = make_input(torch, gen, "flash", torch.float32, (p, 1), device)
    flash = (m, l, make_input(torch, gen, "flash", torch.float32, (p, 1000),
                              device)[2])
    pair = (make_input(torch, gen, "sum", torch.float32, (p, 1000), device),
            make_input(torch, gen, "sum", torch.int32, (p, 7), device))
    for kind, inclusive, opname, x, n_launch in (
        (PhaseKind.TOTAL, True, "ssd", ssd, 1),
        (PhaseKind.TOTAL, True, "flash", flash, 1),
        (PhaseKind.FUSED_SCAN_TOTAL, False, "sum", pair, 2),
    ):
        op = get_operator(opname)
        before = fc.launches
        got = fc.comm_phase(kind, p, op, x, inclusive=inclusive)
        if fc.launches != before + n_launch:
            raise AssertionError(f"{opname}: {fc.launches - before} launches")
        want = fc.comm_phase_plain(kind, p, op, x, inclusive=inclusive)
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if kind == PhaseKind.FUSED_SCAN_TOTAL \
            else [(got, want)]
        rtol, atol = tolerance(torch, opname, torch.float32)
        for g, w in pairs:
            assert_match(torch, g, w, rtol, atol, f"unequal leaves {opname}")
            if [t.shape for t in g] != [t.shape for t in x]:
                raise AssertionError(f"{opname}: leaf shapes not kept")
        cases += 1
    emit({"phase": "kernel", "cases": cases, "bitwise_f32_max_abs_err": worst,
          "max_abs_err_by_op": worst_by_op, "ok": True})


MAIN_SIZES = (4, 1 << 10, 16 << 10, 256 << 10, 1 << 20)
ALLREDUCE_BIG = 25 << 20  # DDP's default bucket_cap_mb


def main_requests():
    reqs = []
    for p in (8, 16):
        for coll in ("SCAN", "EXSCAN", "ALLREDUCE", "BARRIER"):
            sizes = (4,) if coll == "BARRIER" else MAIN_SIZES
            for nb in sizes:
                reqs.append((coll, p, nb))
    reqs.append(("ALLREDUCE", 8, ALLREDUCE_BIG))
    return reqs


def phase_main(torch, device):
    import numpy as np

    from repro_torch import OffloadEngine
    from repro_torch.kernels import fused_collective as fc

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    eng = OffloadEngine()  # the GPU is the default
    if eng.device.type != "cuda":
        raise AssertionError(f"OffloadEngine() chose {eng.device}")
    runs = []
    for coll, p, nb in main_requests():
        desc = eng.make_descriptor(
            coll, axes=(1, p), payload_bytes=nb, backend="pallas", chunks=1
        )
        if desc.backend != "pallas" or desc.chunks != 1 or len(desc.encode()) != 16:
            raise AssertionError(f"unexpected descriptor {desc}")
        x = None
        if coll != "BARRIER":
            x = torch.randn((p, nb // 4), generator=gen, device=device)
        runs.append((coll, p, nb, desc, x))
    torch.cuda.synchronize()

    fc.launches = 0
    outs = []
    repeat_hits = 0
    for coll, p, nb, desc, x in runs:
        first = eng.offload(desc.encode(), x)  # builds the schedule, or hits
        hits = eng.telemetry.hits              # a plan of an earlier size
        again = eng.offload(desc.encode(), x)
        repeat_hits += eng.telemetry.hits - hits
        outs.append((first, again))
    torch.cuda.synchronize()
    launches = fc.launches

    snap = eng.telemetry.snapshot()
    n = len(runs)
    if launches < 2 * n:
        raise AssertionError(f"K1 launched {launches} times for {2 * n} dispatches")
    if snap["backend_fallbacks"] != 0:
        raise AssertionError(f"fallbacks taken: {snap['backend_fallback_reasons']}")
    if repeat_hits != n:
        raise AssertionError(f"{repeat_hits} of {n} repeat dispatches hit the cache")

    ref_eng = OffloadEngine()
    checked = []
    for (coll, p, nb, desc, x), (first, again) in zip(runs, outs):
        ref_desc = ref_eng.make_descriptor(
            coll, axes=(1, p), payload_bytes=nb, backend="", chunks=1
        )
        ref = ref_eng.offload(ref_desc, x)
        what = f"main {coll} p={p} {nb}B"
        assert_match(torch, first, ref, 0.0, 0.0, what)  # SUM f32: bitwise
        assert_match(torch, again, ref, 0.0, 0.0, what + " (cache hit)")
        if not bool(torch.isfinite(first).all()):
            raise AssertionError(f"{what}: non-finite output")
        if coll != "BARRIER" and nb == 1 << 10:
            # independent check on a small input: numpy in float64
            xs = x.double().cpu().numpy()
            want = {
                "SCAN": np.cumsum(xs, 0),
                "EXSCAN": np.concatenate([np.zeros_like(xs[:1]),
                                          np.cumsum(xs, 0)[:-1]]),
                "ALLREDUCE": np.broadcast_to(xs.sum(0), xs.shape),
            }[coll]
            np.testing.assert_allclose(first.double().cpu().numpy(), want,
                                       rtol=1e-5, atol=1e-4, err_msg=what)
        if coll == "BARRIER" and not bool((first == 1).all()):
            raise AssertionError(f"{what}: barrier token is not 1")
        checked.append(f"{coll}:{p}:{nb}")
    emit({
        "phase": "main",
        "dispatches": snap["dispatches"],
        "k1_launches": launches,
        "launches_per_dispatch": launches / snap["dispatches"],
        "cache_hits": snap["hits"],
        "cache_misses": snap["misses"],
        "backend_fallbacks": snap["backend_fallbacks"],
        "checked": len(checked),
        "ok": True,
    })
    return launches


def time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, name=None):
    """Device time per call from ``torch.profiler`` (CUPTI): the kernels
    whose name contains ``name``, or every device activity when ``name`` is
    None. None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0.0)
        if name is None or name in evt.key:
            total_us += t
    return total_us / iters / 1e3 if total_us > 0 else None


def phase_times(torch, device, card, launches):
    from repro_torch.core.operators import MAX, SUM
    from repro_torch.kernels import fused_collective as fc
    from repro_torch.offload.planner import PhaseKind

    from repro_torch import OffloadEngine

    bw = mem_bandwidth(card)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    eng = OffloadEngine()
    rows = []
    for coll, p, nb in main_requests():
        if coll == "BARRIER":
            kind, op, x = PhaseKind.BARRIER, MAX, torch.ones((p, 1), device=device)
            library = lambda x=x: x.amax(0)  # noqa: E731
        else:
            kind = PhaseKind.TOTAL if coll == "ALLREDUCE" else PhaseKind.SCAN
            op = SUM
            x = torch.randn((p, nb // 4), generator=gen, device=device)
            if coll == "SCAN":
                library = lambda x=x: torch.cumsum(x, 0)  # noqa: E731
            elif coll == "ALLREDUCE":
                library = lambda x=x: x.sum(0)  # noqa: E731
            else:
                library = None
        inclusive = coll != "EXSCAN"
        got = fc.comm_phase(kind, p, op, x, inclusive=inclusive)
        want = fc.comm_phase_plain(kind, p, op, x, inclusive=inclusive)
        err = assert_match(torch, got, want, 0.0, 0.0, f"times {coll} p={p} {nb}B")
        iters = 20 if x.numel() * 4 >= (64 << 20) else 200
        kernel = lambda: fc.comm_phase(kind, p, op, x, inclusive=inclusive)  # noqa: E731
        plain = lambda: fc.comm_phase_plain(kind, p, op, x, inclusive=inclusive)  # noqa: E731
        # per call, back to back: CUDA events (what a caller waits, host
        # overhead included) and the profiler's device time (the kernels)
        event = {
            "ms": time_ms(torch, kernel, iters),
            "plain_ms": time_ms(torch, plain, iters),
            "library_ms": time_ms(torch, library, iters) if library else None,
        }
        dev = {
            "ms": device_ms(torch, kernel, iters, name="k1_kernel"),
            "plain_ms": device_ms(torch, plain, iters),
            "library_ms": device_ms(torch, library, iters) if library else None,
        }
        # the end-to-end metric: the engine's own dispatch latency (host
        # clock bracketed by synchronize), median of repeat dispatches
        desc = eng.make_descriptor(coll, axes=(1, p), payload_bytes=nb,
                                   backend="pallas", chunks=1)
        arg = None if coll == "BARRIER" else x
        lat = []
        for _ in range(3 + min(iters, 50)):
            eng.offload(desc, arg)
            lat.append(eng.telemetry.last_latency_s * 1e3)
        lat = sorted(lat[3:])
        timing = "profiler" if dev["ms"] is not None else "events"
        times = dev if timing == "profiler" else event
        nbytes = 2 * x.numel() * x.element_size()  # read once, write once
        row = {
            "coll": coll, "p": p, "bytes_per_rank": nb,
            **times, "timing": timing,
            "event_ms": event["ms"], "plain_event_ms": event["plain_ms"],
            "library_event_ms": event["library_ms"],
            "dispatch_ms": lat[len(lat) // 2],
            "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
            "max_abs_err": err,
        }
        rows.append(row)
        emit({"phase": "times", **row})
    # the headline shape: SCAN, SUM float32, p=8, 1 MiB per rank (osu_scan's
    # largest default message)
    head = next(r for r in rows
                if (r["coll"], r["p"], r["bytes_per_rank"]) == ("SCAN", 8, 1 << 20))
    return {
        "name": "k1_fused_comm",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "timing": head["timing"],
        "event_ms": head["event_ms"],
    }


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no {SRC / 'repro_torch'})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card, smi = phase_device(torch)
    phase_kernel(torch, device)
    launches = phase_main(torch, device)
    k1 = phase_times(torch, device, card, launches)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    emit({"kernels": [k1]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
