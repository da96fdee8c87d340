"""Time K3's design switches on one NVIDIA GPU, and K3 beside an earlier
revision of itself.

``kernels/csrc/prefix_scan.cu`` has compile-time switches, each defaulting to
the shipped design (``kernels/prefix_scan.py::Build``):

* ``K3_VEC_BYTES``: bytes a lane loads at once on the vector variant (16);
* ``K3_ROW_LANES``: lanes a row on the rows path (32: one row a warp; 16 and
  8 put two and four rows in a warp);
* ``K3_ROW_SEGS``: segments a lane group loads at once on the rows path (2);
* ``K3_TILE_THREADS``, ``K3_TILE_VECS``: threads a block and vectors a
  thread a tile on the tiles path (256, 2);
* ``K3_PREFETCH``: the next batch's or tile's loads issued before the
  current one is scanned (1) or after (0);
* ``K3_CHUNK_THREADS``, ``K3_CHUNK_VECS``: threads a block and vectors a
  thread a chunk on the lookback path (128, 8).

This script builds the source as shipped and with each switch changed (one
nvcc each, all started together, into ``build/kernels/k3_ablation/``),
holds every build's output against the plain version on the card, and times
each build at the four float32 add shapes (Mamba2-130m's segment scan
``(3072, 256)``, its training step's ``(768, 256)``, the memory-bound
``(8192, 8192)`` and one long row ``(1, 67108864)``), forward and back to
front, the shipped build first and again last. The shipped build is also
timed with one element a lane (``vec=1``, no rebuild), on each path named
explicitly (the tiles path against the look-back at 8192 rows), on the rows
and tiles paths at 2048 rows of 1024-4096 elements (``ROWS_MAX_BYTES``),
and on the tiles and lookback paths at 66-528 rows of 2^16
(``TILES_MIN_ROWS``), where the plan moves from one to the other.

``--parent DIR`` also times the K3 of another checkout of the repository
(``DIR``, e.g. ``git archive <rev> | tar -x -C DIR``): its source built
beside this one's and its wrapper module loaded from its file (bound to
that build), in turns parent, change, change, parent, at the shapes where
the two are compared, with the segment-scan call through
``ops.prefix_scan`` timed by CUDA events a call::

    PYTHONPATH=src python -m repro_torch.testing.k3_ablation [--out FILE] [--parent DIR]

Prints one JSON line per build or turn (device µs a call from
``torch.profiler``: every device activity of the call, which on the lookback
path includes the memset of its status words; µs a launch between CUDA
events around a CUDA graph of 100 captured calls, for inputs under 64 MiB,
where no host time enters; µs a call between CUDA events around back-to-back
calls, host time included; ptxas's largest register count and spill bytes),
the global loads and stores that ``cuobjdump -sass`` lists in the float32
add kernels, forward and back to front, of the parent's build and this one's
(where the toolkit has ``cuobjdump``), then the card's name and power limit;
exits non-zero if a build fails or disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import ref_prefix_scan
from repro_torch.testing.k5_ablation import event_us

K3 = importlib.import_module("repro_torch.kernels.prefix_scan")

#: (build, nvcc defines)
VARIANTS = (
    ("shipped", ()),
    ("no_prefetch", ("-DK3_PREFETCH=0",)),
    ("row_lanes_16", ("-DK3_ROW_LANES=16",)),
    ("row_lanes_8", ("-DK3_ROW_LANES=8",)),
    ("row_segs_4", ("-DK3_ROW_SEGS=4",)),
    ("row_segs_1", ("-DK3_ROW_SEGS=1",)),
    ("vec_8_bytes", ("-DK3_VEC_BYTES=8",)),
    ("tile_vecs_4", ("-DK3_TILE_VECS=4",)),
    ("tile_threads_512", ("-DK3_TILE_THREADS=512",)),
    ("chunk_128x4", ("-DK3_CHUNK_VECS=4",)),
    ("chunk_256x4", ("-DK3_CHUNK_THREADS=256", "-DK3_CHUNK_VECS=4")),
    ("chunk_512x2", ("-DK3_CHUNK_THREADS=512", "-DK3_CHUNK_VECS=2")),
)

#: the four float32 add shapes
SHAPES = ((3072, 256), (768, 256), (8192, 8192), (1, 67108864))
#: paths side by side where the plan moves between them: (paths, shapes)
THRESHOLDS = (
    (("rows", "tiles"), tuple((2048, L) for L in (1024, 2048, 3072, 4096))),
    (("tiles", "lookback"), tuple((R, 1 << 16) for R in (66, 132, 264, 528))),
)
#: (label, shape, dtype, op, exclusive, reverse) where parent and change meet
COMPARE = (
    ("(8192,8192) f32 add", (8192, 8192), torch.float32, "add", False, False),
    ("(8192,8192) f32 max", (8192, 8192), torch.float32, "max", False, False),
    ("(8192,8192) f32 mul", (8192, 8192), torch.float32, "mul", False, False),
    ("(8192,8192) bf16 add", (8192, 8192), torch.bfloat16, "add", False, False),
    ("(8192,8192) int32 add", (8192, 8192), torch.int32, "add", False, False),
    ("(8192,8192) f32 add reverse", (8192, 8192), torch.float32, "add", False, True),
    ("(3072,256) f32 add", (3072, 256), torch.float32, "add", False, False),
    ("(768,256) f32 add", (768, 256), torch.float32, "add", False, False),
    ("(768,256) f32 add reverse", (768, 256), torch.float32, "add", False, True),
    ("(1,67108864) f32 add", (1, 67108864), torch.float32, "add", False, False),
    ("(1,64) int32 add exclusive", (1, 64), torch.int32, "add", True, False),
    ("(8,64) int32 add exclusive", (8, 64), torch.int32, "add", True, False),
)
#: Mamba2-130m's segment scan as the model hands it over: (B, nc, H, Q)
SEGMENT = (8, 16, 24, 256)
GRAPH_CALLS = 100
#: inputs at least this large are not captured 100 times in a graph
GRAPH_MAX_BYTES = 64 << 20


def scan_tolerance(op, dtype):
    """(rtol, atol) of K3 against its plain version, as ``chip_smoke.py``'s:
    bitwise for max and integers."""
    if op == "max" or not dtype.is_floating_point:
        return 0.0, 0.0
    rtol = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}[dtype]
    atol = (1e-3 if dtype == torch.float32 else rtol) if op == "add" else 0.0
    return rtol, atol


def make_input(shape, dtype, op, gen):
    """Seeded inputs on the card. A long row's add scan takes nonnegative
    values, as I/O offsets and bucket bases do: over millions of normal
    draws the float32 plain version drifts from the exact sum by more than
    the scan tolerance."""
    device = torch.device("cuda")
    if not dtype.is_floating_point:
        hi = 4 if op == "mul" else 1 << 20
        return torch.randint(-hi, hi, shape, generator=gen, device=device,
                             dtype=dtype)
    if op == "mul":
        x = torch.exp(0.01 * torch.randn(shape, generator=gen, device=device))
    elif shape[-1] >= 1 << 20:
        x = torch.rand(shape, generator=gen, device=device)
    else:
        x = torch.randn(shape, generator=gen, device=device)
    return x.to(dtype)


def plain(x, op, exclusive, reverse):
    if reverse:
        return ref_prefix_scan(x.flip(-1), op, exclusive=exclusive).flip(-1)
    return ref_prefix_scan(x, op, exclusive=exclusive)


def check(got, want, op, dtype, what) -> float:
    rtol, atol = scan_tolerance(op, dtype)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               equal_nan=True, msg=lambda m: f"{what}: {m}")
    return float((got.double() - want.double()).abs().max())


def activities_us(fn, iters: int):
    """Device µs a call: the mean duration of each kind of device activity
    in the trace (the kernel, and on the lookback path the memset of its
    status words), summed, so that an activity CUPTI dropped does not count
    as a call that took no time; and the number of activities the trace
    holds. A trace with none is taken again, up to three times in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    us, seen = None, 0
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, seen = 0.0, 0
        for evt in prof.key_averages():
            t = getattr(evt, "device_time_total", None)
            t = getattr(evt, "cuda_time_total", 0.0) if t is None else t
            if t > 0 and evt.count:
                total += t / evt.count
                seen += evt.count
        if total > 0:
            us = total
            break
    return us, seen


def graph_us(fn, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """µs a call between CUDA events around replays of one CUDA graph of
    ``calls`` captured calls: the device's time with no host in it (each
    captured call's output comes from the graph's memory pool)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    us = start.elapsed_time(end) * 1e3 / (replays * calls)
    del graph
    torch.cuda.empty_cache()
    return us


def timings(fn, nbytes: int, iters: int) -> dict:
    dev, seen = activities_us(fn, iters)
    return {"us": dev, "activities": seen,
            "graph_us": graph_us(fn) if nbytes < GRAPH_MAX_BYTES else None,
            "event_us": event_us(fn, iters)}


def compile_source(src: Path, lib: Path, defines=()) -> subprocess.Popen:
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *defines, "-o", str(lib),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(out_dir: Path, parent: Path = None) -> dict:
    """Compile every variant (and the parent's source) at once; returns
    {build: (library, log)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "prefix_scan.cu"
    jobs = {name: (out_dir / f"libprefix_scan-{name}.so", defines, src)
            for name, defines in VARIANTS}
    if parent is not None:
        jobs["parent"] = (out_dir / "libprefix_scan-parent.so", (),
                          parent / "src/repro_torch/kernels/csrc/prefix_scan.cu")
    procs = {name: (lib, compile_source(s, lib, d))
             for name, (lib, d, s) in jobs.items()}
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        built[name] = (lib, log)
    return built


def ptxas_summary(log: str) -> list:
    """[largest register count, largest spill-store bytes] over the build."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    return [max(regs, default=None), max(spills, default=None)]


def sass_memory_ops(lib: Path, kernels: dict) -> dict:
    """{label: {opcode: count}} of the global loads and stores (``LDG*``,
    ``STG*``) that ``cuobjdump -sass`` lists in each kernel whose mangled
    name holds the label's substring; {} without ``cuobjdump``."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=False).stdout
    out = {label: {} for label in kernels}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((label for label, key in kernels.items()
                            if key in m.group(1)), None)
            continue
        if current is None:
            continue
        m = re.search(r"\b((?:LDG|STG)\.[A-Z0-9.]+)", line)
        if m:
            ops_ = out[current]
            ops_[m.group(1)] = ops_.get(m.group(1), 0) + 1
    return out


class _Library:
    """Stands in for ``_build`` in a module loaded from another checkout:
    its ``load_library`` returns that checkout's build."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def load_library(self, name: str) -> ctypes.CDLL:
        return self.lib


def parent_module(parent: Path, lib: Path):
    """The other checkout's ``kernels/prefix_scan.py``, loaded from its file
    under another name and bound to its own build."""
    path = parent / "src/repro_torch/kernels/prefix_scan.py"
    spec = importlib.util.spec_from_file_location("k3_parent_prefix_scan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = _Library(ctypes.CDLL(str(lib)))
    return mod


def variant_row(name, turn, entry, log, inputs, *, vec=None, path=None):
    """One build's (or one forced width's or path's) times at the four
    shapes, forward and back to front, each output checked first."""
    row = {"build": name, "turn": turn, "design": vars(entry.build),
           "vec": vec, "path": path, "ptxas": ptxas_summary(log),
           "plans": {}, "times": {}}
    for shape, x, want, want_rev in inputs:
        key = f"{shape[0]}x{shape[1]}"
        for direction, rev, ref in (("forward", False, want),
                                    ("reverse", True, want_rev)):
            if path in ("rows", "tiles") and shape[0] == 1:
                continue  # one warp or block walking 2^26 elements

            plan = K3.plan_launch(*shape, x.dtype, reverse=rev,
                                  build=entry.build, path=path, vec=vec)

            def call(x=x, rev=rev, entry=entry):
                return K3._launch(x, "add", False, rev, path=path, vec=vec,
                                  entry=entry)

            got = call()
            torch.cuda.synchronize()
            err = check(got, ref, "add", x.dtype, f"{name} {shape} {direction}")
            del got
            iters = 10 if x.numel() * 4 >= GRAPH_MAX_BYTES else 100
            row["plans"][key] = [plan.path, plan.vec, plan.blocks]
            row["times"][f"{key} {direction}"] = {
                **timings(call, x.numel() * 4, iters), "max_abs_err": err}
    return row


def compare_turn(label, mod, cases, seg):
    """One turn of the parent-against-change comparison through ``mod``'s
    ``scan_rows`` (and ``ops.prefix_scan`` pointed at ``mod``)."""
    row = {"turn": label, "times": {}}
    for (what, shape, dtype, op, exclusive, reverse), x, want in cases:
        def call(x=x, op=op, exclusive=exclusive, reverse=reverse):
            return mod.scan_rows(x, op=op, exclusive=exclusive,
                                 reverse=reverse)

        got = call()
        torch.cuda.synchronize()
        err = check(got, want, op, dtype, f"{label} {what}")
        del got
        iters = 10 if x.numel() * x.element_size() >= GRAPH_MAX_BYTES else 100
        row["times"][what] = {**timings(call, x.numel() * x.element_size(), iters),
                              "max_abs_err": err}
    saved = ops._scan
    ops._scan = mod
    try:
        row["segment_call_event_us"] = event_us(lambda: ops.prefix_scan(seg), 100)
    finally:
        ops._scan = saved
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the rows to this JSON file")
    ap.add_argument("--parent", help="a checkout of another revision whose K3 "
                                     "is timed beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    parent = Path(args.parent).resolve() if args.parent else None
    built = build(_build.BUILD_DIR / "k3_ablation", parent)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    inputs = []
    for shape in SHAPES:
        x = make_input(shape, torch.float32, "add", gen)
        inputs.append((shape, x, plain(x, "add", False, False),
                       plain(x, "add", False, True)))
    torch.cuda.synchronize()

    rows = []
    shipped = K3.bind(ctypes.CDLL(str(built["shipped"][0])))
    order = [(name, {}) for name, _ in VARIANTS]
    order += [("shipped", {"vec": 1})]
    order += [("shipped", {"path": p}) for p in ("rows", "tiles", "lookback")]
    order += [("shipped", {})]
    for turn, (name, forced) in enumerate(order):
        lib, log = built[name]
        entry = shipped if name == "shipped" else K3.bind(ctypes.CDLL(str(lib)))
        row = variant_row(name, turn, entry, log, inputs, **forced)
        print(json.dumps(row), flush=True)
        rows.append(row)
    del inputs

    # where the rows path hands over to the tiles path (ROWS_MAX_BYTES),
    # and the tiles path to the look-back (TILES_MIN_ROWS)
    threshold = {}
    for paths, shapes in THRESHOLDS:
        for shape in shapes:
            x = make_input(shape, torch.float32, "add", gen)
            want = plain(x, "add", False, False)
            for path in paths:
                def call(x=x, path=path):
                    return K3._launch(x, "add", False, False, path=path,
                                      entry=shipped)

                check(call(), want, "add", x.dtype, f"threshold {shape} {path}")
                threshold[f"{shape[0]}x{shape[1]} {path}"] = timings(
                    call, x.numel() * 4, 100)
    print(json.dumps({"threshold": threshold}), flush=True)
    rows.append({"threshold": threshold})
    # f32 add, forward and back to front: the loads and stores each compiled to
    sass = {"shipped": sass_memory_ops(built["shipped"][0], {
        f"{path} {d}": f"k3_scan_kernel_{path}IfLi0ELb{int(rev)}ELi4E"
        for path in ("rows", "tiles", "lookback")
        for d, rev in (("forward", False), ("reverse", True))})}

    compare = []
    if parent is not None:
        sass["parent"] = sass_memory_ops(built["parent"][0], {
            "forward": "k3_scan_kernelIfLi0ELb0E",
            "reverse": "k3_scan_kernelIfLi0ELb1E"})
        old = parent_module(parent, built["parent"][0])
        cases = []
        for case in COMPARE:
            _, shape, dtype, op, exclusive, reverse = case
            x = make_input(shape, dtype, op, gen)
            cases.append((case, x, plain(x, op, exclusive, reverse)))
        seg = -0.1 * torch.rand(SEGMENT, generator=gen, device="cuda")
        new = K3
        for label, mod in (("parent", old), ("change", new), ("change", new),
                           ("parent", old)):
            row = compare_turn(label, mod, cases, seg)
            print(json.dumps(row), flush=True)
            compare.append(row)
        library = {}
        for (what, shape, dtype, op, exclusive, reverse), x, _ in cases:
            if exclusive or reverse:
                continue
            if op == "max":
                fn = lambda x=x: torch.cummax(x, -1)  # noqa: E731
            else:
                f = torch.cumsum if op == "add" else torch.cumprod
                fn = lambda x=x, f=f: f(x, -1, dtype=x.dtype)  # noqa: E731
            iters = 10 if x.numel() * x.element_size() >= GRAPH_MAX_BYTES else 100
            library[what] = timings(fn, x.numel() * x.element_size(), iters)
        library["segment_call_event_us"] = event_us(
            lambda: torch.cumsum(seg, -1), 100)
        print(json.dumps({"library": library}), flush=True)
        compare.append({"library": library})
    print(json.dumps({"sass": sass}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "shapes": SHAPES,
             "timing": "torch.profiler, device µs a call over every activity "
                       "of the call; CUDA-graph µs a launch; CUDA-event µs a "
                       "call (host included)",
             "rows": rows, "compare": compare, "sass": sass}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
