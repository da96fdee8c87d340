"""Time K4's design switches on one NVIDIA GPU.

``kernels/csrc/ssd_scan.cu`` has six compile-time switches for its chunked
path, each defaulting to the shipped design:

* ``K4_STEPS``: time steps a warp holds in registers (16);
* ``K4_TIME_WARPS``: warps along time, so the chunk is ``L = K4_STEPS *
  K4_TIME_WARPS`` steps (4: L = 64);
* ``K4_FEATURE_WARPS``: warps along features, so a block's tile is ``D_TILE
  = 32 * (K4_VEC_BYTES / itemsize) * K4_FEATURE_WARPS`` features (2: 256 in
  float32, 512 in bf16 / fp16);
* ``K4_VEC_BYTES``: bytes a thread loads at once (16: 4 floats, 8 bf16);
* ``K4_STAGE``: a and b held in registers (0) or staged through shared
  memory with ``cp.async`` (1);
* ``K4_ORDER``: the ticket order, the chunk varying fastest within a
  column (0) or the column fastest within a chunk (1, shipped).

This script builds the source as shipped and with the switches changed (one
nvcc each, all started together, into ``build/kernels/k4_ablation/``),
holds every build's output against the plain version on the card, and times
each build with ``torch.profiler`` at Mamba2-130m's SSD shape ``(8, 4096,
1536)`` in float32 and bf16, the shipped build first and again last. Two
diagnostic builds, edited copies of the shipped source that compute the
wrong function on purpose (no look-back; nor any status or value
published), are timed beside them to show what the look-back costs::

    PYTHONPATH=src python -m repro_torch.testing.k4_ablation [--out FILE]

Prints one JSON line per build (device µs per call: every activity of the
call, which includes the memset of the look-back's status words, and the
kernel alone; the activities the trace held against those launched; µs per
call between CUDA events; ptxas's registers and spill bytes of the chunked
kernel at each type and vector width), then the card's name and power
limit; exits non-zero if a build fails or disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_ssd_scan
from repro_torch.testing.k5_ablation import device_us, event_us

K4 = importlib.import_module("repro_torch.kernels.ssd_scan")

#: (build, nvcc defines); the builds of 8 time warps keep one feature warp,
#: so that a block stays at 256 threads and ptxas at no spill
VARIANTS = (
    ("shipped", ()),
    ("chunk_32", ("-DK4_TIME_WARPS=2",)),
    ("chunk_128", ("-DK4_TIME_WARPS=8", "-DK4_FEATURE_WARPS=1")),
    ("steps_8", ("-DK4_STEPS=8", "-DK4_TIME_WARPS=8", "-DK4_FEATURE_WARPS=1")),
    ("d_tile_half", ("-DK4_FEATURE_WARPS=1",)),
    ("vec_8_bytes", ("-DK4_VEC_BYTES=8",)),
    ("staged", ("-DK4_STAGE=1",)),
    ("order_0", ("-DK4_ORDER=0",)),
)

# Diagnostic builds, which compute the wrong function on purpose and are
# only timed: where the shipped kernel's time goes beyond the bytes. Each is
# the shipped source with these (text, replacement) edits.
_NO_WAIT = (("if (chunk == 0) {\n#pragma unroll", "if (true) {\n#pragma unroll"),)
DIAGNOSTICS = (
    # every chunk starts from h0 (or 0): no look-back, no wait; the status
    # words and values are still published
    ("no_wait", _NO_WAIT),
    # nor is anything published: loads, the two walks and the stores alone
    ("no_publish", _NO_WAIT + (
        ("if (lane == 0) store_release(status + tile * FW + fw, AGGREGATE);", ""),
        ("if (lane == 0) store_release(status + tile * FW + fw, INCLUSIVE);", ""),
        ("store_floats<V>(mine, Ac);", ""),
        ("store_floats<V>(mine + DT, Bc);", ""),
        ("store_floats<V>(mine + 2 * DT, incl);", ""),
    )),
)

SHAPE = (8, 4096, 1536)  # Mamba2-130m: batch 8, sequence 4096, d_inner 1536
ITERS = 20
#: as chip_smoke.py's SSD_TOL
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def build(out_dir: Path) -> dict:
    """Compile every variant and diagnostic build at once; returns {build:
    (library, log)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = _build.CSRC / "ssd_scan.cu"
    jobs = [(name, defines, shipped) for name, defines in VARIANTS]
    for name, edits in DIAGNOSTICS:
        text = shipped.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"diagnostic {name}: {old!r} not in the source")
            text = text.replace(old, new)
        src = out_dir / f"ssd_scan-{name}.cu"
        src.write_text(text)
        jobs.append((name, (), src))
    procs = {}
    for name, defines, src in jobs:
        lib = out_dir / f"libssd_scan-{name}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(lib),
               str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        built[name] = (lib, log)
    return built


def chunked_registers(log: str) -> dict:
    """[registers, spill-store bytes] of each chunked-kernel instantiation
    in ptxas's ``-v`` report, keyed by its mangled type and vector width."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"k4_chunked_kernelI(\w+?)Li(\d)E", m.group(1))
            key = f"{k.group(1)},{k.group(2)}" if k else None
            if key:
                out[key] = [None, None]
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[key][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key][0] = int(m.group(1))
    return out


def activities_us(fn, iters: int):
    """Device µs per call over every activity of the trace that holds device
    time (the kernel and the memset of the status words), and the number of
    those activities (two a call on the chunked path)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, 0
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", None)
        t = getattr(evt, "cuda_time_total", 0.0) if t is None else t
        if t > 0:
            total += t
            seen += evt.count
    return total / iters, seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    built = build(_build.BUILD_DIR / "k4_ablation")
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    inputs = []
    for dtype in (torch.float32, torch.bfloat16):
        a = (0.9 + 0.1 * torch.rand(SHAPE, generator=gen, device=device)).to(dtype)
        b = torch.randn(SHAPE, generator=gen, device=device).to(dtype)
        inputs.append((str(dtype).replace("torch.", ""), a, b, ref_ssd_scan(a, b)[0]))
    torch.cuda.synchronize()

    rows = []
    diagnostic = dict(DIAGNOSTICS)
    order = [name for name, _ in VARIANTS] + list(diagnostic) + ["shipped"]
    for turn, name in enumerate(order):
        lib, log = built[name]
        entry = K4.bind(ctypes.CDLL(str(lib)))
        row = {"build": name, "turn": turn,
               "defines": dict(VARIANTS).get(name, ()),
               "diagnostic": name in diagnostic,
               "design": vars(entry.build), "us": {}, "kernel_us": {},
               "event_us": {}, "traced": {},
               "registers_spills": chunked_registers(log)}
        for label, a, b, want in inputs:
            plan = K4.plan_launch(*SHAPE, a.dtype, build=entry.build)

            def call(a=a, b=b, entry=entry):
                return K4._launch(a, b, None, entry=entry)

            got = call()
            torch.cuda.synchronize()
            if name in diagnostic:  # the wrong function, but it ran
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{name} {label}: non-finite output")
            else:
                torch.testing.assert_close(got.double(), want.double(),
                                           rtol=TOL[a.dtype], atol=TOL[a.dtype],
                                           msg=lambda m: f"{name} {label}: {m}")
            del got
            # every activity of the call: the kernel and the memset
            us, seen = activities_us(call, ITERS)
            row["us"][label] = us
            row["traced"][label] = [seen, 2 * ITERS]
            row["kernel_us"][label] = device_us(call, ITERS, plan.launches,
                                                name="k4_chunked_kernel")[0]
            row["event_us"][label] = event_us(call, ITERS)
        print(json.dumps(row), flush=True)
        rows.append(row)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "shape": SHAPE,
             "timing": "torch.profiler, device µs per call (every activity, "
                       "and the k4_chunked_kernel alone)", "rows": rows},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
