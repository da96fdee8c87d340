"""Time K5's design switches on one NVIDIA GPU.

``kernels/csrc/flash_attention.cu`` has four compile-time switches, each on
in the shipped build:

* ``K5_TC_TURNS``: the tensor-core kernel's two consumer warpgroups take
  turns to issue their products;
* ``K5_TC_PIPE``: the next tile's S and this tile's P.V stay in flight during
  the softmax (0 never, 1 below D = 128 as shipped, 2 at every head size);
* ``K5_TC_BY_HEAD``: under a window, one head's query tiles run together;
* ``K5_DECODE_ROWS1``: a one-row decode call runs the kernel compiled for one
  row (else the one compiled for 16).

This script builds the source as shipped and once with each switch changed
(one nvcc each, all started together, into ``build/kernels/k5_ablation/``),
holds every build's output against the plain version, and times each
build's kernels with ``torch.profiler`` on the K5 shapes of
``chip_smoke.py``, the shipped build first and again last::

    PYTHONPATH=src python -m repro_torch.testing.k5_ablation [--out FILE]

Prints one JSON line per build (device µs per call and shape, the kernels
the trace held against those launched, µs per call between CUDA events,
ptxas's notes that it serialized a ``wgmma`` pipeline), then the card's
name and power limit; exits non-zero if a build fails or disagrees with
the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_attention

FA = importlib.import_module("repro_torch.kernels.flash_attention")

#: (build, nvcc defines)
VARIANTS = (
    ("shipped", ()),
    ("turns_off", ("-DK5_TC_TURNS=0",)),
    ("pipe_off", ("-DK5_TC_PIPE=0",)),
    ("pipe_at_d128", ("-DK5_TC_PIPE=2",)),
    ("by_head_off", ("-DK5_TC_BY_HEAD=0",)),
    ("decode_rows16", ("-DK5_DECODE_ROWS1=0",)),
)

#: (label, (BH, Sq, Skv, D, causal, window, q_offset), timed calls), bf16
SHAPES = (
    ("smollm_360m causal (60,2048,64)", (60, 2048, 2048, 64, True, 0, 0), 50),
    ("gemma3_27b local window 1024 (64,4096,128)",
     (64, 4096, 4096, 128, True, 1024, 0), 20),
    ("smollm_360m decode (60,1,2048) q_offset 2047",
     (60, 1, 2048, 64, True, 0, 2047), 200),
)
TOL = 2e-2  # bf16, as chip_smoke.py's FLASH_TOL


def build(out_dir: Path) -> dict:
    """Compile every variant at once; returns {variant: (library, log)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "flash_attention.cu"
    procs = {}
    for name, defines in VARIANTS:
        lib = out_dir / f"libflash_attention-{name}.so"
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


def serialized_notes(log: str) -> list:
    """ptxas's notes that it serialized a wgmma pipeline (C7512, C7514),
    one per distinct message."""
    notes = []
    for line in log.splitlines():
        if "wgmma" in line and "serializ" in line and line not in notes:
            notes.append(line.strip())
    return notes


def device_us(fn, iters: int, launches: int, name: str = "k5_flash_kernel"):
    """Device µs per call of the kernels whose name holds ``name``, and the
    number of those kernels the trace holds. A trace that holds fewer than
    the ``iters * launches`` made is taken again, up to twice; the last one
    is returned either way, so the caller sees a short trace."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, seen = 0.0, 0
        for evt in prof.key_averages():
            if name in evt.key:
                t = getattr(evt, "device_time_total", None)
                total += getattr(evt, "cuda_time_total", 0.0) if t is None else t
                seen += evt.count
        if seen == iters * launches:
            break
    return total / iters, seen


def event_us(fn, iters: int) -> float:
    """µs per call between CUDA events around back-to-back calls (host work
    included: near the device time where the host keeps ahead)."""
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
    return start.elapsed_time(end) * 1e3 / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build(_build.BUILD_DIR / "k5_ablation")
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    inputs = []
    for label, (BH, Sq, Skv, D, causal, window, q_offset), iters in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device)
                   .to(torch.bfloat16)
                   for shape in ((BH, Sq, D), (BH, Skv, D), (BH, Skv, D)))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        want = ref_flash_attention(q, k, v, **kw)
        inputs.append((label, q, k, v, kw, iters, want))
    torch.cuda.synchronize()

    rows = []
    order = [name for name, _ in VARIANTS] + ["shipped"]
    for turn, name in enumerate(order):
        lib, log = built[name]
        entry = FA.bind(ctypes.CDLL(str(lib)))
        row = {"build": name, "turn": turn,
               "defines": dict(VARIANTS)[name], "us": {}, "event_us": {},
               "kernels_traced": {}, "serialized": serialized_notes(log)}
        for label, q, k, v, kw, iters, want in inputs:
            plan = FA.plan_launch(*q.shape[:2], k.shape[1], q.shape[2],
                                  q.dtype, **kw)

            def call(q=q, k=k, v=v, kw=kw):
                return FA._launch(q, k, v, entry=entry, **kw)

            got = call()
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=TOL,
                                       atol=TOL,
                                       msg=lambda m: f"{name} {label}: {m}")
            us, seen = device_us(call, iters, plan.launches)
            row["us"][label] = us
            row["kernels_traced"][label] = [seen, iters * plan.launches]
            row["event_us"][label] = event_us(call, iters)
        print(json.dumps(row), flush=True)
        rows.append(row)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "timing": "torch.profiler, device µs per call, "
             "kernels named k5_flash_kernel*", "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
