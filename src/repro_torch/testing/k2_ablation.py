"""Time K2's cluster-path design switches on one NVIDIA GPU.

``kernels/csrc/spmd_collective.cu`` has two compile-time switches for its
cluster path (2 <= p <= 16):

* ``K2_PUT_BULK``: a put is ``st.async``, one store and one
  ``complete_tx`` on the partner's barrier per 16 bytes a thread (0,
  shipped), or one ``cp.async.bulk`` a leaf row from a staging row in the
  sender's shared memory (1);
* ``K2_CLUSTER_THREADS``: threads a CTA (128 shipped);
* ``K2_SPLIT_SYNC``: the opening and closing cluster barriers are split
  around the loads and around the last combine and the stores (1,
  shipped), or arrive and wait together (0);
* ``K2_ROW_VECS``: 16-byte vectors a thread carries a leaf, for every type
  and operator (unset as shipped: 4 where shared memory and registers
  allow, as for float32 SUM, else 2 or 1).

This script builds the source as shipped and with the switches changed (one
nvcc each, all started together, into ``build/kernels/k2_ablation/``),
holds every build's output bitwise against K2's plain version on the card,
and times each build's
cluster kernel with ``torch.profiler`` on chip_smoke's comparison shapes
(float32 SUM: SCAN at p = 8 and 16 with 1 MiB per rank, ALLREDUCE at p = 8
with 25 MiB), the shipped build first and again last::

    PYTHONPATH=src python -m repro_torch.testing.k2_ablation [--out FILE]

Prints one JSON line per build (device µs per call and shape, the kernels
the trace held against those launched, µs per call between CUDA events),
then the card's name and power limit; exits non-zero if a build fails or
disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.compat import Mesh, shard_map
from repro_torch.core.operators import SUM
from repro_torch.kernels import _build
from repro_torch.kernels import fused_collective as fc
from repro_torch.kernels import spmd_collective as k2
from repro_torch.offload.planner import PhaseKind
from repro_torch.testing.k5_ablation import device_us, event_us

#: (build, nvcc defines, bulk puts, threads a CTA, 16-byte vectors a thread
#: at float32 SUM); "first" is the cluster path's first build (st.async, 128
#: threads of one vector, barriers not split)
VARIANTS = (
    ("shipped", (), False, 128, 4),
    ("vecs_1", ("-DK2_ROW_VECS=1",), False, 128, 1),
    ("threads_256", ("-DK2_CLUSTER_THREADS=256",), False, 256, 4),
    ("bulk", ("-DK2_PUT_BULK=1",), True, 128, 4),
    ("split_sync_off", ("-DK2_SPLIT_SYNC=0",), False, 128, 4),
    ("first", ("-DK2_SPLIT_SYNC=0", "-DK2_ROW_VECS=1"), False, 128, 1),
)

#: (label, phase kind, ranks, bytes per rank, timed calls), float32 SUM
SHAPES = (
    ("SCAN p=8 1 MiB", PhaseKind.SCAN, 8, 1 << 20, 200),
    ("SCAN p=16 1 MiB", PhaseKind.SCAN, 16, 1 << 20, 200),
    ("ALLREDUCE p=8 25 MiB", PhaseKind.TOTAL, 8, 25 << 20, 20),
)


def build(out_dir: Path) -> dict:
    """Compile every variant at once; returns {variant: library}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "spmd_collective.cu"
    procs = {}
    for name, defines, *_ in VARIANTS:
        lib = out_dir / f"libspmd_collective-{name}.so"
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
        built[name] = lib
    return built


def cluster_call(entry, bulk: bool, threads: int, vecs: int, kind, p: int, x):
    """One cluster-path launch of a build over stacked float32 rows ``x``
    (16-byte aligned), with the tile and shared memory that build takes."""
    M = x.shape[1]
    slots = k2.exchanges(kind, p, True)
    row = threads * 16 * vecs
    shared = -(-8 * slots // 16) * 16 + (2 if bulk else 1) * slots * row
    y = torch.empty_like(x)
    made = ctypes.c_int(0)
    rc = entry(0, fc._KIND_CODES[kind], 0, fc._DTYPE_CODES[torch.float32], 1,
               p, M, row // 4, shared, 1, x.data_ptr(), None, None,
               y.data_ptr(), None, None, None, None, None, None, None, None,
               0, k2.TIMEOUT_S, torch.cuda.current_stream().cuda_stream,
               ctypes.byref(made))
    if rc != 0 or made.value != 1:
        raise RuntimeError(f"launch failed (code {rc}, {made.value} launched)")
    return y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    built = build(_build.BUILD_DIR / "k2_ablation")
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    inputs = []
    for label, kind, p, nb, iters in SHAPES:
        x = torch.randn((p, nb // 4), generator=gen, device=device)
        plain = shard_map(
            lambda t, kind=kind, p=p: k2.comm_phase_spmd_plain(kind, p, "i", SUM, t),
            Mesh((p,), ("i",), device=device), ("i",), "i")
        inputs.append((label, kind, p, x, iters, plain(x)))
    torch.cuda.synchronize()

    rows = []
    order = [v[0] for v in VARIANTS] + ["shipped"]
    config = {v[0]: v for v in VARIANTS}
    for turn, name in enumerate(order):
        _, defines, bulk, threads, vecs = config[name]
        entry = k2.bind(ctypes.CDLL(str(built[name])))
        row = {"build": name, "turn": turn, "defines": list(defines),
               "us": {}, "event_us": {}, "kernels_traced": {}}
        for label, kind, p, x, iters, want in inputs:

            def call(kind=kind, p=p, x=x):
                return cluster_call(entry, bulk, threads, vecs, kind, p, x)

            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {label}: differs from the plain version")
            us, seen = device_us(call, iters, 1, name="k2_cluster_kernel")
            row["us"][label] = us
            row["kernels_traced"][label] = [seen, iters]
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
             "kernels named k2_cluster_kernel", "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
