#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without printing a result:

1. device   — the card, its power limit, TF32 off, every kernel library
              built from ``src/repro_torch/kernels/csrc`` with nvcc (one nvcc
              per source, all started together), ptxas registers and spills
              (of every K1, K2, K4 and K5 kernel; a spill in K1's register
              path, K2's cluster path or K4's chunked path fails the run).
2. kernel   — K1 (the fused collective kernel) against its plain PyTorch
              version on the card, for every phase kind, operator and wire
              dtype, over rank counts of its register path (p <= 16) and
              its column path (p = 64, and 500/512 for the global-scratch
              column), a ragged width, NaN inputs and rows off 16-byte
              alignment; each call's launches by path held to
              ``plan_launch``'s.
3. onchip   — K3 (prefix scan), K4 (SSD scan) and K5 (flash attention)
              through ``repro_torch.kernels.ops`` against their plain versions
              on the card: ragged, N-d and NaN inputs, every mask of K5 on
              its decode, tensor-core and float32 paths in float32, bf16 and
              fp16, each output row also held to a limit relative to its
              norm, and the launches each call reports having made (counted
              in C after each launch) held to ``plan_launch``'s; K4 on its
              chunked and column paths over ragged T and D in every dtype,
              views off the vector alignment, broadcast h0, the exact
              a = b = 1 case at T = 4096 (bitwise), 20 back-to-back calls
              and calls on two streams, launches by path held to the plan.
4. serve    — the model substrate and the serving path
              (``repro_torch.models``, ``repro_torch.serving``): Mamba2-130m
              at full width in float32, ``lm_prefill`` at (2, 256) on the
              card (K3 under every Mamba layer: exactly 24 launches, read
              right before and after) against the same module on the CPU
              (the plain scan), logits and final SSD states to 1e-3 of the
              largest magnitude; Mamba2-130m and SmolLM-360M at full width in
              bf16 through ``ServeEngine(batch_size=4, max_len=256)``, 8
              requests of 4-23-token prompts (``default_rng(0)``, as
              ``launch/serve.py`` draws them) and 16 new tokens until
              drained, every kernel count zeroed right before and read right
              after (K3: 24 a prefill, none a decode step), with served
              tokens/s, prefill ms a request and the median CUDA-event
              decode step; the moe, hybrid, vlm and audio families
              reduced, one ``lm_forward`` and a prefill-then-decode on the
              card against the CPU in float32 to 1e-4; a reduced
              Mamba2-130m served as a tenant of the card's
              ``DescriptorBroker`` (its per-step ALLREDUCE through K1):
              ``collect_service_stats()`` equal to the host's count, K1's
              launches rising. Its profiler readings come after ``tune``,
              right before ``profile``. Every line carries the card's name
              and power limit.
5. mesh     — the model code's mesh paths (``repro_torch.compat``'s
              rank-group collectives and ``block_shard_map``): Mamba2-130m's
              mixer at full width in float32, x (2, 4096, 768),
              sequence-parallel under a co-resident (1, 8) mesh against the
              unsharded mixer (output and SSD state within 2e-3, conv tail
              1e-4; K3 once for all 8 shards); the 24-layer Mamba2-130m
              ``lm_forward`` at (8, 4096) in bf16 under that mesh and without
              it (logits' max and median gap held to ``MESH_FORWARD_BOUND``,
              24 K3 launches, host ms in turns); one OLMoE-1B-7B MoE block at
              full width in float32, x (4, 512, 2048), expert-parallel under
              (1, 8) and (2, 4) against ``_dense_moe`` (2e-4,
              ``load_balance`` 1e-3; one K3 launch a block for the (8, 64)
              expert offsets) and at capacity 0.25 finite with dropped
              picks; SmolLM-360M in bf16 through ``ServeEngine(4, 256)``
              under (1, 4) (decode ``kv_mode="seq"``) serving the unmeshed
              engine's tokens wherever its top-2 margin exceeds
              ``SERVE_SAFE_MARGIN`` and the prefixes agree, tokens/s and
              decode-step ms both ways. First ``mamba_sp_check`` (its
              fourth check, the gradient through ``dist_exscan``, included)
              and ``moe_check`` (reduced, co-resident) on the card; the
              full-width SP mixer's gradient against the unsharded one's
              (2e-3 of each leaf's largest; K3 once forward and once back
              to front). Its device times come with ``serve``'s, before
              ``profile``.
6. train    — the training path (``repro_torch.launch``, ``optim``,
              ``runtime.train_loop``): K3's backward (the ``PrefixScan``
              Function's back-to-front launch) against ``torch.cumsum``'s
              autograd gradient at Mamba2-130m's (768, 256) segment rows
              and (96, 1000), inclusive and exclusive, at the scan
              tolerance; Mamba2-130m at full width in bf16 through
              ``launch.train.main`` (``--full``, 20 steps at (8, 1024), the
              seeded pipeline, a temporary checkpoint directory): every
              loss finite, the last five's mean below the first five's,
              K3 48 launches a step forward (each layer and its
              recomputation) and 24 back to front, counted from zero over
              the run; median step ms, tokens/s, peak memory; one step's
              gradients of a 2-layer full-width f32 Mamba2-130m at (2, 512)
              on the card against the CPU (1e-3 of each leaf's largest);
              ``train_offload_check``'s bitwise scenario at full width, f32,
              on a co-resident (2, 2) mesh, 8 x 512 (engine == raw bitwise
              over 2 steps, step-2 cache hits, ``examples_seen`` 8, ms a
              step each way); ``compressed_dp_check``. Its profiler
              readings (a reverse K3 launch beside a forward one, one
              profiled training step's device share) come with
              ``serve``'s and ``mesh``'s, before ``profile`` (read after
              ``times``, K3's launches left no device record on the card).
7. main     — the offload path: ``OffloadEngine()`` (on the GPU by default)
              -> ``make_descriptor(..., backend="pallas", chunks=1)`` ->
              ``offload`` for SCAN, EXSCAN, ALLREDUCE and BARRIER at p = 8 and
              16 over the osu_scan message sizes (4 B - 1 MiB per rank) plus a
              25 MiB ALLREDUCE, each held against the port's default sim
              lowering and, on a small input, against numpy. K1's launch
              counts (in all and by path) are zeroed right before and read
              right after: every launch on the register path.
8. service  — the multi-tenant broker (``DescriptorBroker`` over
              ``OffloadEngine()``, its flush thread on the card): 1, 8 and
              64 client threads stream SCAN, EXSCAN and ALLREDUCE at axes
              (1, 8) through K1 (``backend="pallas"``, ``chunks=1``),
              float32 and int32 SUM, 4 B - 1 MiB per rank, each round
              posted together, with coalescing on (up to 64 tenants, a
              fused (8, k, n) payload of up to 512 MiB) and off
              (``max_coalesce=1``), in turns (on, off, off, on). Every
              result bitwise == a direct ``offload`` of the same request
              through the default lowering, so K1 is held against its plain
              counterpart at the coalesced shapes; K1's counts zeroed
              right before each run and read
              right after: at least one launch per fused dispatch, all on
              the register path; no backend fallback; coalesce factor > 1
              with it on; writing into one ticket's result leaves the
              others alone. Prints requests/s, client p50/p99 latency, the
              coalesce factor and K1 launches per request.
9. reliability — ``repro_torch.testing.chaos_check`` on the card at (2, 4)
              and at (1, 8), on the default backend as the reference runs
              it: all five CollTypes bitwise through seeded 5% drop +
              corrupt chaos (retries), a poisoned payload quarantined by
              bisection, the breaker tripped, degraded to
              ``reference_collective`` and recovered, ``healthz``. Then
              ``ReliableDispatcher`` without chaos: no retry or degrade,
              every dispatch on K1's register path, each result bitwise
              against the default lowering. Then the layer's cost, on and
              off in turns on one broker (the reference benchmark's 8 MiB
              int32 SCAN at (2, 4) on the default lowering, where K1
              declines the two-axis plan, and at (1, 8) through K1, every
              dispatch counted on K1), and ``payload_checksum`` at 16 KiB
              and 8 MiB.
10. health   — ``repro_torch.testing.health_check`` at (2, 4) on the card
              (a link-probed traced dispatch with one link slowed: the
              detector names that link and no other; sim, driver-mode and
              probed results bitwise; a deadline-miss SLO alert; the flight
              recorder's dump); ``HealthMonitor.ingest`` of a broker's and
              its engine's telemetry and ``render_dashboard`` of both.
11. entry    — the on-chip entry points at full width: Mamba2-130m's segment
              scan, OLMoE's expert offsets, memory-bound (8192, 8192) scans,
              Mamba2-130m's SSD recurrence, SmolLM-360M and Gemma3-27B
              attention and a decode step. The launch counts of K3, K4 (also
              by path) and K5 are zeroed right before and read right after
              (one a call for K3 and K4; for K5 the launches its C entry
              reports, held to ``plan_launch``'s count); each result is held
              against its plain version.
12. spmd     — the per-rank path: K2 (the per-rank collective kernel)
              through ``get_backend("pallas").lower(plan, op,
              axis_names=("i",))`` under the port's ``shard_map`` on
              co-resident meshes of 8 and 16 ranks on the card (its cluster
              path): SCAN and EXSCAN, ALLREDUCE on every wire dtype and SSD,
              BARRIER and the fused scan+total plan, 4 B - 1 MiB per rank
              plus a 25 MiB ALLREDUCE; fewer cases at 3, 6 and 12 ranks
              (clusters of no power of two) and 32 (its flags path, peer
              puts and signal flags). Each is dispatched twice and held
              bitwise against K1, K2's plain version and ``lower_spmd``.
              K2's launch counts (in all and by path, held to
              ``plan_launch``'s) are zeroed right before and read right
              after. Then the engine in driver mode (a mesh passed to
              ``offload``) for the five CollTypes and a planned (2, 4) SCAN,
              bitwise against sim mode.
13. baseline — the paper's comparison (Figs. 4-5) at p = 8, float32 SUM:
              host-stepped ``host_scan`` (a dispatch and a sync per hop)
              against the whole schedule as one CUDA graph replay, and K1
              through the engine for hillis_steele; host_scan == sim_scan
              bitwise.
14. tune     — the tuner on the card (``repro_torch.offload.tuner``):
              ``autotune`` over p = 2-16 x 1 KiB - 1 MiB x the five colls x
              every applicable algorithm (eager, CUDA events),
              ``tune_schedule`` over (1, 8), (1, 16) and (2, 4) x
              (fused?, chunks 1-8) x backends ("" and "pallas": K1 raced
              at the one-axis shapes; one CUDA graph of ``inner`` chained
              runs a sample) and ``tune_splits``; every grid point
              measured, the table's fingerprint names the card, a fitted
              LinkModel, save -> ``load_compatible`` keeps the winners and
              a jax-fingerprinted table is refused; then the table active,
              "auto" descriptors for the five CollTypes at p = 8 and 16,
              4 B - 1 MiB, bitwise against the untuned engine (int32 SUM,
              float32 MAX) and within ``scan_tolerance`` of float64 numpy
              (float32 SUM). Prints the fit, the p = 8 winners beside
              ``DEFAULT_LINK_MODEL``'s picks and the backend races.
15. profile  — after the serving path's, the mesh phase's and the
              training path's profiler readings (K3's device time in a
              Mamba2-130m prefill, a decode step's device time and host
              share for Mamba2-130m and SmolLM-360M, the (8, 4096) bf16
              forward with and without the (1, 8) mesh, K3's device time in
              it beside the same scan alone and its bytes bound; a reverse
              K3 launch beside a forward one, one training step's device
              share): two ``profile_offload`` sessions
              of one K1 dispatch in a row, the second holding K1's device
              event; then ``profile_offload`` of hillis_steele
              SCAN at p = 8 over the baseline sizes: K1 and the default
              lowering in sim mode, driver mode, the (2, 4) optimized plan
              in driver mode, and K2's per-rank lowering (``profile_call``);
              each device-sourced, ``0 < device_us <= wall_us``, with K1's
              or K2's launches among the window's device events (each
              profiled dispatch taken again up to three times when CUPTI
              drops activities). Then a traced K1 dispatch: bitwise equal
              to the untraced one, the span tree ``engine.offload`` ->
              ``engine.compile`` / phase span -> ``phase_round_count``
              round spans, the merged host+device trace aligned, the
              engine's series in the Prometheus text.
16. roofline — the roofline of a whole model call
              (``repro_torch.roofline``): Mamba2-130m at full width in bf16,
              the (8, 4096) ``lm_forward`` of ``times_serve_forward`` and one
              training step at (8, 1024) as ``launch.train`` builds it, each
              counted once under ``op_cost.CostMode`` (aten ops priced by the
              reference's rules, K3 charged at its own cost where it
              launches) and then run again, uncounted, under the profiler:
              FLOPs, bytes, the compute and memory terms, the bound and its
              bottleneck, ``model_flops``, the device time, ``bound_share =
              t_bound / device_s`` (at most 1.05: a bound above the
              measured time is a wrong count) and ``mfu = model_flops /
              (device_s x bf16 peak)``; K3's charges equal to its launches
              in the counted run (24; 48 forward and 24 back to front) and
              each at ``kernel_cost``'s bytes for the model's segment-scan
              shape. It and ``dryrun`` run after ``profile``: right after
              ``train``, they left ``profile``'s two sessions in a row
              without a device event.
17. dryrun   — ``launch.dryrun.run_cell`` for Mamba2-130m at train_4k,
              prefill_32k, decode_32k and long_500k on one pod's
              co-resident (16, 16) mesh on the ``meta`` device: every key of
              the reference's record, 256 chips, FLOPs and bytes above 0, a
              named bottleneck, a useful share in (0, 1.05]; each record's
              roofline and seconds.
18. times   — every kernel, its plain version and one PyTorch library call
              at the main and entry shapes: device time from
              ``torch.profiler`` and the per-call time with CUDA events
              (host overhead included), beside the least time the card's
              memory bandwidth or peak rate allows; K1's register and K2's
              cluster path each beside the PR 13 path (named explicitly,
              timed in turns) at SCAN p = 8 and 16, 1 MiB per rank, and a
              25 MiB ALLREDUCE; the engine's driver-mode dispatch latency
              beside sim mode's; and K4's chunked path beside its column
              path (the first port's kernel), in turns, at Mamba2-130m's
              SSD shape in float32 and bf16, with the same-bytes time of
              ``torch.add(a, b, out=h)``.

The line before the last is the card's name and power limit as nvidia-smi
prints them; the last line is the result object.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

CSRC = "src/repro_torch/kernels/csrc"
#: the kernel of each K1 / K2 path, as the profiler and ptxas name it
PATH_KERNELS = {"register": "k1_register_kernel", "column": "k1_column_kernel",
                "cluster": "k2_cluster_kernel", "flags": "k2_flags_kernel"}
#: the kernel of each K4 path
K4_KERNELS = {"chunked": "k4_chunked_kernel", "column": "k4_column_kernel"}
#: (name in the kernels line, CUDA source, TPU kernel it replaces, the
#: kernel's function name as the profiler lists it)
KERNELS = {
    "k1": ("k1_fused_comm", "fused_collective",
           "src/repro/kernels/pallas_collective.py:362", "k1_register_kernel"),
    "k2": ("k2_spmd_comm", "spmd_collective",
           "src/repro/kernels/pallas_collective.py:180", "k2_cluster_kernel"),
    "k3": ("k3_prefix_scan", "prefix_scan",
           "src/repro/kernels/prefix_scan.py:45", "k3_scan_kernel"),
    # K4's device time counts every activity of the call: the kernel and
    # the memset of its look-back's status words
    "k4": ("k4_ssd_scan", "ssd_scan",
           "src/repro/kernels/ssd_scan.py:33", None),
    "k5": ("k5_flash_attention", "flash_attention",
           "src/repro/kernels/flash_attention.py:27", "k5_flash_kernel"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def roofline():
    """The port's roofline analysis: the card's data-sheet peaks (HBM
    bytes/s, dense FLOP/s by dtype, TF32 off) and each kernel's cost, the
    one count behind every bound this script prints."""
    return importlib.import_module("repro_torch.roofline.analysis")


def mem_bandwidth(name: str) -> float:
    return roofline().mem_bandwidth(name)


def peak_flops(name: str, dtype) -> float:
    return roofline().peak_flops(name, dtype)


def kernel_bytes(kernel: str, **shape) -> float:
    """Bytes one call of ``kernel`` must move (each input read once, each
    output written once), from ``roofline().kernel_cost``."""
    return roofline().kernel_cost(kernel, **shape).bytes


def scan_bytes(x) -> float:
    """K3's bytes for a scan of ``x`` along its last axis."""
    L = x.shape[-1]
    return kernel_bytes("k3", rows=x.numel() // max(L, 1), length=L,
                        dtype=x.dtype)


def kernel_modules():
    """The wrapper module of each kernel (``repro_torch.kernels`` exports the
    entry-point functions under the K3-K5 module names)."""
    return {
        "k1": importlib.import_module("repro_torch.kernels.fused_collective"),
        "k2": importlib.import_module("repro_torch.kernels.spmd_collective"),
        "k3": importlib.import_module("repro_torch.kernels.prefix_scan"),
        "k4": importlib.import_module("repro_torch.kernels.ssd_scan"),
        "k5": importlib.import_module("repro_torch.kernels.flash_attention"),
    }


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


def demangle(names):
    """C++ names of mangled kernel symbols (cu++filt or c++filt; the mangled
    names where neither is installed)."""
    import shutil

    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    cuda = Path("/usr/local/cuda/bin/cu++filt")
    if tool is None and cuda.exists():
        tool = str(cuda)
    if tool is None or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_paths(log: str, kernels):
    """Registers and spill-store bytes of every instantiation of the named
    kernels, from ptxas's ``-v`` report, keyed by its C++ name without
    namespaces or parameters, e.g. ``k1_register_kernel<float, OpSum<float>,
    0, 8, 4>`` (leaf type, operator, kind, P_MAX, VEC)."""
    found = []
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = None
            if any(k in m.group(1) for k in kernels):
                entry = {"mangled": m.group(1)}
                found.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            entry["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    out = {}
    for entry, name in zip(found, demangle([e["mangled"] for e in found])):
        out[kernel_key(name)] = [entry.get("registers"),
                                 entry.get("spill_store_bytes")]
    return out


def kernel_key(name: str) -> str:
    """A demangled kernel's name and template arguments, without namespaces,
    ``(int)`` casts or its parameter list."""
    name = re.sub(r"<unnamed>::|\(anonymous namespace\)::|collective::|reg::|"
                  r"cl::|\(int\)|^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth == 0:
                return name[:i + 1]
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def phase_device(torch):
    from repro_torch.kernels import SOURCES, _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    paths = _build.build_all(SOURCES)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for src in SOURCES:
        log = _build.build_log(src)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        ptxas[src] = {
            "kernels": len(regs),
            "max_registers": max(regs) if regs else None,
            "max_spill_store_bytes": max(spills) if spills else None,
        }
    k1_kernels = ptxas_paths(_build.build_log("fused_collective"),
                             ("k1_register_kernel", "k1_column_kernel"))
    k2_kernels = ptxas_paths(_build.build_log("spmd_collective"),
                             ("k2_cluster_kernel", "k2_flags_kernel"))
    k4_kernels = ptxas_paths(_build.build_log("ssd_scan"), tuple(K4_KERNELS.values()))
    # the register and cluster kernels shrink VEC (or keep one row) so that
    # nothing spills, and K4's chunked kernel holds its steps in registers;
    # a build loaded from an earlier run has no log to read
    for table in (k1_kernels, k2_kernels, k4_kernels):
        spilling = [k for k, (_, spill) in table.items()
                    if ("register" in k or "cluster" in k or "chunked" in k)
                    and spill]
        if spilling:
            raise AssertionError(f"ptxas spills in {spilling[:5]}")
    name = torch.cuda.get_device_name(0)
    emit({
        "phase": "device",
        "name": name,
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "libraries": [str(p.relative_to(REPO)) for p in paths.values()],
        "build_s": round(build_s, 3),
        "ptxas": ptxas,
        # [registers, spill-store bytes] of every K1, K2, K4 and K5 kernel
        "k5_kernels": ptxas_paths(_build.build_log("flash_attention"),
                                  ("k5_flash_kernel",)),
        "k1_kernels": k1_kernels,
        "k2_kernels": k2_kernels,
        "k4_kernels": k4_kernels,
    })
    return name, smi


def launch_as_planned(fc, kind, p, op, x, inclusive, paths, path=None):
    """One K1 call; the launches its C entry reports, by path, held to
    ``plan_launch``'s (added to ``paths``)."""
    leaves = leaves_of(x)
    M = leaves[0].numel() // p
    before = dict(fc.path_launches)
    got = fc.comm_phase(kind, p, op, x, inclusive=inclusive, path=path)
    plan = fc.plan_launch(kind, p, M, leaves[0].dtype, len(leaves),
                          fc.aligned_rows(leaves, M), path=path)
    made = {k: fc.path_launches[k] - before[k] for k in before}
    want = {k: plan.launches if k == plan.path else 0 for k in before}
    if made != want:
        raise AssertionError(f"{kind.name} p={p}: launched {made}, planned {want}")
    for k, n in made.items():
        paths[k] += n
    return got


def phase_kernel(torch, device):
    from repro_torch.core.operators import SUM, get_operator
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
    paths = {"register": 0, "column": 0}  # launches each path made
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
            else:
                # a non-commutative combine, where operand order shows
                combos += [("ssd", torch.float32)]
        for p in ps:
            # 1000 columns: a ragged last block (int8 rows, 1000 bytes, are
            # not 16-byte aligned: VEC = 1); p <= 16 take the register
            # path, 64 the column path in shared memory, 500/512 in global
            # scratch (the column no longer fits in shared memory)
            width = 1 if kind == PhaseKind.BARRIER else 1000
            for opname, dtype in combos:
                if p >= 500 and (opname, dtype) not in (("sum", torch.float32),
                                                         ("max", torch.float32),
                                                         ("ssd", torch.float32)):
                    continue
                op = get_operator(opname)
                x = make_input(torch, gen, opname, dtype, (p, width), device,
                               nan=dtype.is_floating_point and opname != "prod")
                got = launch_as_planned(fc, kind, p, op, x, inclusive, paths)
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

    # rows that start off 16 bytes (a view one element into its storage):
    # the register path's VEC = 1 instance; then the column path at p <= 16
    for kind, inclusive in forms[:5]:
        for path in (None, "column"):
            p = 8
            base = make_input(torch, gen, "sum", torch.float32, (p * 1000 + 1,),
                              device)
            x = base[1:].view(p, 1000)
            if path is None and fc.aligned_rows([x], 1000):
                raise AssertionError("the offset view is 16-byte aligned")
            got = launch_as_planned(fc, kind, p, SUM, x, inclusive, paths,
                                    path=path)
            want = fc.comm_phase_plain(kind, p, SUM, x, inclusive=inclusive)
            torch.cuda.synchronize()
            pairs = list(zip(got, want)) if kind == PhaseKind.FUSED_SCAN_TOTAL \
                else [(got, want)]
            for g, w in pairs:
                assert_match(torch, g, w, 0.0, 0.0,
                             f"{kind.name} incl={inclusive} offset rows {path}")
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
        paths["register"] += n_launch
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
          "max_abs_err_by_op": worst_by_op, "path_launches": paths, "ok": True})


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
    for key in fc.path_launches:
        fc.path_launches[key] = 0
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
    paths = dict(fc.path_launches)

    snap = eng.telemetry.snapshot()
    n = len(runs)
    if launches < 2 * n:
        raise AssertionError(f"K1 launched {launches} times for {2 * n} dispatches")
    # every request has p <= 16: plan_launch sends each to the register path
    if paths != {"register": launches, "column": 0}:
        raise AssertionError(f"K1 launches by path {paths} of {launches}")
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
        "k1_path_launches": paths,
        "launches_per_dispatch": launches / snap["dispatches"],
        "cache_hits": snap["hits"],
        "cache_misses": snap["misses"],
        "backend_fallbacks": snap["backend_fallbacks"],
        "checked": len(checked),
        "ok": True,
    })
    return launches

# ---------------------------------------------------------------------------
# The service layer: the broker's coalesced dispatches, reliability, health
# ---------------------------------------------------------------------------

SERVICE_CLIENTS = (1, 8, 64)
SERVICE_SIZES = (4, 1 << 10, 64 << 10, 1 << 20)
SERVICE_COLLS = ("SCAN", "EXSCAN", "ALLREDUCE")
SERVICE_ROUNDS = 6  # requests per client: each coll twice
SERVICE_FLUSH_S = 0.002  # the reference broker's default window
#: the reference's overhead benchmark (benchmarks/reliability_overhead.py)
RELIABILITY_COLS = 262144  # x 8 ranks x int32 = 8 MiB
RELIABILITY_BATCH, RELIABILITY_REPS = 8, 12


def bitwise(torch, got, want, what):
    if not torch.equal(got, want):
        assert_match(torch, got, want, 0.0, 0.0, what)  # raises, with detail


def reset_k1_counts(fc):
    fc.launches = 0
    for key in fc.path_launches:
        fc.path_launches[key] = 0


def percentile_us(samples, q):
    import numpy as np

    return round(float(np.percentile(np.asarray(samples) * 1e6, q)), 3)


def service_run(eng, reqs, coalesce):
    """C client threads (one per row of ``reqs``) stream their requests
    through one started broker, every round posted together; returns
    (results by client and round, client latencies in s, wall s, broker)."""
    import threading

    from repro_torch.service import DescriptorBroker

    C, R = len(reqs), len(reqs[0])
    broker = DescriptorBroker(
        eng, flush_interval_s=SERVICE_FLUSH_S,
        max_coalesce=64 if coalesce else 1, max_tenants=64,
    ).start()
    clients = [broker.client(f"t{c}") for c in range(C)]
    gate = threading.Barrier(C)
    results = [[None] * R for _ in range(C)]
    lat = [[0.0] * R for _ in range(C)]
    errors = []

    def work(c):
        try:
            for r, (desc, x) in enumerate(reqs[c]):
                gate.wait()
                t0 = time.perf_counter()
                results[c][r] = clients[c].submit(desc.encode(), x).result(120)
                lat[c][r] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            gate.abort()

    threads = [threading.Thread(target=work, args=(c,)) for c in range(C)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    broker.stop()
    if errors:
        raise errors[0]
    return results, [s for row in lat for s in row], wall, broker


def phase_service(torch, device):
    """DescriptorBroker over OffloadEngine() on the card: 1, 8 and 64 client
    threads stream SCAN/EXSCAN/ALLREDUCE at axes (1, 8) through K1
    (backend "pallas"), float32 and int32 SUM, 4 B - 1 MiB per rank, with
    coalescing on (max_coalesce 64) and off (1). Every result bitwise ==
    a direct offload of the same request through the default lowering
    (K1's plain counterpart, at the coalesced shapes K1 ran); K1's counts
    zeroed right before each run and read right after: at least one launch
    per fused dispatch, all on the register path; no fallback; coalesce
    factor > 1 with it on."""
    from repro_torch import OffloadEngine
    from repro_torch.core.packet import WireDType
    from repro_torch.kernels import fused_collective as fc

    t0 = time.perf_counter()
    eng = OffloadEngine()  # the GPU is the default
    ref_eng = OffloadEngine()
    if eng.device.type != device.type:
        raise AssertionError(f"OffloadEngine() chose {eng.device}")
    gen = torch.Generator(device=device)
    gen.manual_seed(19)
    rows = []
    for C in SERVICE_CLIENTS:
        for nb in SERVICE_SIZES:
            for dtype in (torch.float32, torch.int32):
                wire = getattr(WireDType, dtype_name(dtype).upper())
                descs, ref_descs = ([eng.make_descriptor(
                    coll, axes=(1, 8), payload_bytes=nb, backend=backend,
                    chunks=1, data_type=wire,
                ) for coll in SERVICE_COLLS] for backend in ("pallas", ""))
                reqs = []
                for _c in range(C):
                    reqs.append([])
                    for r in range(SERVICE_ROUNDS):
                        x = torch.randint(-1000, 1000, (8, nb // 4),
                                          generator=gen, device=device)
                        reqs[-1].append((descs[r % len(descs)], x.to(dtype)))
                # the references take the default lowering: no K1 on either
                # side of the comparison
                refs = [[ref_eng.offload(ref_descs[r % len(descs)], x)
                         for r, (_d, x) in enumerate(row)] for row in reqs]
                torch.cuda.synchronize(device)
                row = {"clients": C, "bytes": nb,
                       "dtype": dtype_name(dtype), "on": {}, "off": {}}
                # in turns, on-off-off-on: a warm-up or drift of the host
                # favours neither mode
                for coalesce in (True, False, False, True):
                    fallbacks = eng.telemetry.backend_fallbacks
                    reset_k1_counts(fc)
                    results, lat, wall, broker = service_run(
                        eng, reqs, coalesce)
                    launches, paths = fc.launches, dict(fc.path_launches)
                    snap = broker.telemetry.snapshot()
                    what = (f"service C={C} {nb}B {dtype_name(dtype)} "
                            f"coalesce={coalesce}")
                    for got_row, ref_row in zip(results, refs):
                        for got, want in zip(got_row, ref_row):
                            bitwise(torch, got, want, what)
                    if launches < snap["fused_dispatches"]:
                        raise AssertionError(
                            f"{what}: K1 launched {launches} times for "
                            f"{snap['fused_dispatches']} fused dispatches")
                    if paths != {"register": launches, "column": 0}:
                        raise AssertionError(f"{what}: K1 paths {paths}")
                    if eng.telemetry.backend_fallbacks != fallbacks:
                        raise AssertionError(f"{what}: backend fallbacks")
                    factor = snap["coalesce_factor"]
                    if coalesce and C > 1 and not factor > 1.0:
                        raise AssertionError(f"{what}: coalesce factor {factor}")
                    if not coalesce and factor != 1.0:
                        raise AssertionError(f"{what}: coalesce factor {factor}")
                    n = C * SERVICE_ROUNDS
                    reading = {
                        "requests_per_s": round(n / wall, 1),
                        "p50_us": percentile_us(lat, 50),
                        "p99_us": percentile_us(lat, 99),
                        "coalesce_factor": round(factor, 3),
                        "fused_dispatches": snap["fused_dispatches"],
                        "k1_launches": launches,
                        "k1_launches_per_request": round(launches / n, 4),
                    }
                    mode = row["on" if coalesce else "off"]
                    for key, value in reading.items():
                        mode.setdefault(key, []).append(value)
                    if C == 8 and nb == 1 << 10 and coalesce \
                            and "tickets_independent" not in row:
                        # each ticket owns its result: writing into one
                        # leaves every other one alone
                        firsts = [res[0] for res in results]
                        saved = [t.clone() for t in firsts]
                        firsts[0].add_(1)
                        for got, want in zip(firsts[1:], saved[1:]):
                            bitwise(torch, got, want,
                                    what + " (a neighbour written)")
                        row["tickets_independent"] = True
                    del results
                row["on_over_off"] = round(
                    sum(row["on"]["requests_per_s"])
                    / sum(row["off"]["requests_per_s"]), 3)
                rows.append(row)
                emit({"phase": "service", **row})
                del reqs, refs
    emit({"phase": "service", "runs": len(rows) * 4,
          "seconds": round(time.perf_counter() - t0, 3), "ok": True})
    return rows


def check_module(module, args, device):
    """Run one of the port's check modules in-process on ``device``; fails
    the phase unless it returns 0 (it prints ALL-OK)."""
    mod = importlib.import_module(f"repro_torch.testing.{module}")
    extra = [] if device.type == "cuda" else ["--device", "cpu"]
    rc = mod.main(list(args) + extra)
    if rc != 0:
        raise AssertionError(f"{module} {' '.join(args)} returned {rc}")


def phase_reliability(torch, device):
    """The reference's chaos check on the card (seeded 5% drop + corrupt,
    all five CollTypes bitwise through retries; bisection quarantine;
    breaker trip, degrade to reference_collective, recover; healthz) at
    axes (2, 4) and (1, 8) on the default backend, as the reference runs
    it (under a chaos scope a fused-backend descriptor runs K1, which
    fails no message); then the happy path through ReliableDispatcher: no
    degrade, every dispatch on K1, each result bitwise == the default
    lowering's; then the reliability layer's cost as an A/B in turns on one
    broker (the reference benchmark's 8 MiB int32 SCAN at (2, 4), where K1
    declines the two-axis plan, and the same bytes at (1, 8) through K1)
    and payload_checksum's time."""
    from repro_torch import OffloadEngine
    from repro_torch.kernels import fused_collective as fc
    from repro_torch.offload import reliability as rel
    from repro_torch.service import DescriptorBroker

    t0 = time.perf_counter()
    check_module("chaos_check", ["2", "4"], device)
    check_module("chaos_check", ["1", "8"], device)
    chaos_s = time.perf_counter() - t0

    eng = OffloadEngine()
    disp = rel.ReliableDispatcher.from_policy(eng, rel.ReliabilityPolicy())
    desc = eng.make_descriptor("scan", axes=(1, 8), payload_bytes=1 << 20,
                               backend="pallas", chunks=1)
    x = torch.randn((8, 1 << 18), device=device)
    want = eng.offload(eng.make_descriptor(
        "scan", axes=(1, 8), payload_bytes=1 << 20, backend="", chunks=1), x)
    fallbacks = eng.telemetry.backend_fallbacks
    reset_k1_counts(fc)
    outs = [disp.offload(desc, x) for _ in range(16)]
    torch.cuda.synchronize(device)
    launches, paths = fc.launches, dict(fc.path_launches)
    for got in outs:
        bitwise(torch, got, want, "reliable happy path")
    if disp.counts["degrades"] or disp.counts["retries"] or \
            disp.counts["reference_dispatches"]:
        raise AssertionError(f"happy path took {disp.counts}")
    if launches < len(outs) or paths != {"register": launches, "column": 0}:
        raise AssertionError(f"happy path K1 launches {paths}")
    if eng.telemetry.backend_fallbacks != fallbacks:
        raise AssertionError("happy path took a backend fallback")

    overhead = [reliability_ab(torch, device, DescriptorBroker, rel, axes, kw)
                for axes, kw in (((2, 4), {}),
                                 ((1, 8), {"backend": "pallas", "chunks": 1}))]

    checksum_us = {}
    for nb in (16 << 10, 8 << 20):
        y = torch.randint(0, 1 << 20, (8, nb // 32), dtype=torch.int32,
                          device=device)
        rel.payload_checksum(y)
        iters = 200
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        for _ in range(iters):
            rel.payload_checksum(y)
        checksum_us[str(nb)] = round((time.perf_counter() - t1) / iters * 1e6, 3)
    emit({"phase": "reliability", "chaos_s": round(chaos_s, 3),
          "seconds": round(time.perf_counter() - t0, 3),
          "happy_path": {"dispatches": len(outs), "k1_launches": launches,
                         **disp.counts},
          "overhead": overhead, "checksum_us": checksum_us, "ok": True})
    return overhead, checksum_us


def reliability_ab(torch, device, DescriptorBroker, rel, axes, kw):
    """The reference's A/B (benchmarks/reliability_overhead.py): one broker,
    the same submit/drain loop with the reliability layer installed and
    detached, modes in turns in both orders, median per trial, best of
    two trials; host clock, each dispatch synchronized by the engine. K1's
    counts are zeroed before the A/B and read after it: through the fused
    backend every dispatch launched K1 on the register path, through the
    default one K1 never; either way no backend fallback."""
    import numpy as np

    from repro_torch import OffloadEngine
    from repro_torch.kernels import fused_collective as fc

    broker = DescriptorBroker(OffloadEngine(),
                              reliability=rel.ReliabilityPolicy())
    eng = broker.engine
    desc = eng.make_descriptor("scan", axes=axes,
                               payload_bytes=RELIABILITY_COLS * 4,
                               optimize=True, **kw)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    x = torch.randint(0, 1 << 20, (8, RELIABILITY_COLS), generator=gen,
                      dtype=torch.int32, device=device)
    client = broker.client("bench")
    modes = {"on": (broker._dispatcher, broker.reliability),
             "off": (None, None)}
    on_state = modes["on"]
    dispatches = 0

    def sample(mode):
        nonlocal dispatches
        dispatches += RELIABILITY_BATCH
        broker._dispatcher, broker.reliability = modes[mode]
        try:
            t0 = time.perf_counter()
            for _ in range(RELIABILITY_BATCH):
                t = client.submit(desc, x)
                broker.drain()
            t.result(timeout=120.0)
            return (time.perf_counter() - t0) / RELIABILITY_BATCH * 1e6
        finally:
            broker._dispatcher, broker.reliability = on_state

    fused = kw.get("backend") == "pallas"
    fallbacks = eng.telemetry.backend_fallbacks
    reset_k1_counts(fc)
    for mode in ("on", "off"):
        sample(mode)
    trials = []
    for _ in range(2):
        got = {"on": [], "off": []}
        for rep in range(RELIABILITY_REPS):
            for mode in (("on", "off") if rep % 2 == 0 else ("off", "on")):
                got[mode].append(sample(mode))
        on_us, off_us = (float(np.median(got[m])) for m in ("on", "off"))
        trials.append({"on_us": round(on_us, 3), "off_us": round(off_us, 3),
                       "overhead_frac": round((on_us - off_us) / off_us, 5)})
    torch.cuda.synchronize(device)
    launches, paths = fc.launches, dict(fc.path_launches)
    fallbacks = eng.telemetry.backend_fallbacks - fallbacks
    what = f"reliability A/B at {axes}"
    if fallbacks:
        raise AssertionError(f"{what}: {fallbacks} backend fallbacks")
    # the fused leg: every dispatch, in both modes, on K1's register path;
    # the default leg: K1 never launched
    if fused and (launches < dispatches
                  or paths != {"register": launches, "column": 0}):
        raise AssertionError(f"{what}: K1 launches {paths} for {dispatches} "
                             f"dispatches")
    if not fused and launches:
        raise AssertionError(f"{what}: K1 launched {launches} times")
    best = min(trials, key=lambda t: t["overhead_frac"])
    return {"axes": list(axes), "backend": kw.get("backend", ""),
            "bytes": 8 * RELIABILITY_COLS * 4, "dispatches": dispatches,
            "k1_launches": launches, "backend_fallbacks": fallbacks,
            "trials": trials, **best}


def phase_health(torch, device):
    """The health layer on the card: the reference's health check at
    (2, 4) (a traced dispatch with link_probe=True and a LinkDelayInjector
    slowing link (1, 0, 1): the detector names that link and no other of
    its seven peers; sim, driver-mode and probed results bitwise; a
    deadline SLO alert; the flight recorder's dump); then
    HealthMonitor.ingest of an engine's and a broker's snapshots and
    render_dashboard of both."""
    from repro_torch import OffloadEngine
    from repro_torch.obs import dashboard as obs_dashboard
    from repro_torch.obs import health as obs_health
    from repro_torch.service import DescriptorBroker

    t0 = time.perf_counter()
    check_module("health_check", ["2", "4"], device)
    check_s = time.perf_counter() - t0

    broker = DescriptorBroker(OffloadEngine())
    desc = broker.make_descriptor("scan", axes=(1, 8), payload_bytes=1 << 10,
                                  backend="pallas", chunks=1)
    monitor = obs_health.HealthMonitor()
    clients = [broker.client(f"h{c}") for c in range(4)]
    for _ in range(3):
        for client in clients:
            client.submit(desc, torch.ones((8, 256), device=device))
        broker.drain()
        monitor.ingest(service=broker.telemetry, engine=broker.engine.telemetry)
    hz = monitor.healthz()
    if hz["status"] != "ok":
        raise AssertionError(f"healthz after clean dispatches: {hz}")
    text = obs_dashboard.render_dashboard(engine=broker.engine, broker=broker,
                                          monitor=monitor)
    for section in ("-- engine", "-- service", "-- health: OK",
                    "-- flight recorder", "coalesce 4.00"):
        if section not in text:
            raise AssertionError(f"dashboard lacks {section!r}:\n{text}")
    print(text, flush=True)
    emit({"phase": "health", "check_s": round(check_s, 3),
          "seconds": round(time.perf_counter() - t0, 3),
          "healthz": hz["status"], "slos": hz["slos"],
          "dashboard_lines": len(text.splitlines()), "ok": True})


# ---------------------------------------------------------------------------
# K3-K5: the on-chip entry points of repro_torch.kernels
# ---------------------------------------------------------------------------


# tolerance (rtol, atol) of K3 against its plain version; (0, 0) = bitwise.
# max is exact and integer sums and products wrap exactly. Floating add/mul
# combine in another order than torch's scan; bf16/fp16 carry in float32
# and round once per output in both, so an ordering difference can move an
# output by one rounding step (2^-7 relative in bf16, 2^-10 in fp16).
def scan_tolerance(torch, op, dtype):
    if op == "max" or not dtype.is_floating_point:
        return 0.0, 0.0
    rtol = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}[dtype]
    atol = (1e-3 if dtype == torch.float32 else rtol) if op == "add" else 0.0
    return rtol, atol


# K4: one sequential recurrence (or chunks joined by the look-back's
# carries) against the plain version's doubling scan with h0 folded in
# after it (float32 state in both; bf16 and fp16 round once, so an ordering
# difference can move an output by one rounding step: 2^-7 relative in
# bf16, 2^-10 in fp16)
SSD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2),
           "float16": (2e-3, 2e-3)}
# K5: online against full softmax in float32 (TF32 off); bf16 and fp16 also
# round p to v's type before the P.V product, as the reference kernel does,
# and round the output once. fp16 keeps 3 more bits than bf16: the output's
# rounding moves it by 2^-11 |o|, 2e-3 at |o| in [2, 4), the worst error
# measured on an H100 (1.95e-3); a kernel that skipped one of 16 key tiles
# moves a long causal row by about 5e-3, so fp16's limit sits between the two.
FLASH_TOL = {"float32": (5e-4, 5e-4), "bfloat16": (2e-2, 2e-2),
             "float16": (4e-3, 4e-3)}
# K5 per output row: ||o - o_plain|| / ||o_plain||. The element-wise limits
# are sized for rows with |o| near |v|; a row over 2k keys has |o| of about
# 0.03-0.05, and a skipped key tile moves it by about a quarter of its norm.
# Rounding moves a row by a few units of its last place (2^-9 bf16, 2^-12
# fp16; about 4e-3 and 5e-4 between two orders of the same arithmetic on
# the CPU), so these limits hold that with room and still catch the fault.
FLASH_ROW_TOL = {"float32": 5e-4, "bfloat16": 2e-2, "float16": 4e-3}


def row_rel_err(torch, got, want) -> float:
    """The largest ``||got - want|| / ||want||`` over the last axis."""
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


def check_rows(torch, got, want, dtype, what) -> float:
    err = row_rel_err(torch, got, want)
    limit = FLASH_ROW_TOL[dtype_name(dtype)]
    if not err <= limit:
        raise AssertionError(f"{what}: a row moved by {err} of its norm "
                             f"(limit {limit})")
    return err


def scan_input(torch, gen, op, dtype, shape, device, *, nan=False):
    if dtype in (torch.int32, torch.int8):
        hi = 4 if op == "mul" else (1 << 30 if dtype == torch.int32 else 128)
        return torch.randint(-hi, hi, shape, generator=gen, device=device,
                             dtype=dtype)
    if op == "mul":
        # log-symmetric factors: a product over 70,000 steps stays a normal
        # float (a uniform draw around 1 drifts down into subnormals)
        x = torch.exp(0.01 * torch.randn(shape, generator=gen, device=device))
    else:
        x = torch.randn(shape, generator=gen, device=device)
    if nan and shape[-1] > 1:
        x[..., 0, shape[-1] // 3] = float("nan")
    return x.to(dtype)


def ssd_input(torch, gen, dtype, shape, device, with_h0):
    a = 0.5 + 0.5 * torch.rand(shape, generator=gen, device=device)
    b = torch.randn(shape, generator=gen, device=device)
    h0 = None
    if with_h0:
        h0 = torch.randn(shape[:-2] + shape[-1:], generator=gen, device=device)
        h0 = h0.to(dtype)
    return a.to(dtype), b.to(dtype), h0


def qkv_input(torch, gen, dtype, BH, Sq, Skv, D, device):
    q = torch.randn((BH, Sq, D), generator=gen, device=device).to(dtype)
    k = torch.randn((BH, Skv, D), generator=gen, device=device).to(dtype)
    v = torch.randn((BH, Skv, D), generator=gen, device=device).to(dtype)
    return q, k, v


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


#: K4's ragged lengths and widths: around the 64-step chunk (the CPU tests'
#: T = 1, L - 1, L, L + 1, 3L + 5), the shortest chunked T (2L) and T beyond
#: the look-back's 32-chunk window
K4_T = (1, 63, 64, 65, 128, 129, 197, 4096, 10000)
K4_D = (1, 3, 4, 130)
#: h0 shapes that broadcast against a (2, 3, T, 64) trajectory, as the
#: reference's h0[..., None, :] does (the last two widen the batch)
K4_H0_SHAPES = ((64,), (1,), (3, 64), (1, 64), (2, 1, 64), (1, 3, 64),
                (2, 3, 1), (2, 3, 64), (5, 2, 3, 64), (1, 2, 3, 64))


def onchip_k4(torch, device, check):
    """K4 on both paths: ragged T and D in float32, bf16 and fp16 with and
    without h0, N-d and multi-tile widths, views off the vector alignment,
    broadcast h0 through ``ops.ssd_scan``, the exact a = b = 1 case at
    T = 4096 (bitwise), 20 back-to-back calls and calls on two streams.
    Every call's launches by path are held to ``plan_launch``'s. Returns
    the number of cases and the launches by path."""
    import math

    from repro_torch.kernels import ops, ref

    k4 = kernel_modules()["k4"]
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    paths = {k: 0 for k in k4.path_launches}
    pending = []

    def launch(a, b, h0, what, tol=None):
        """One ops.ssd_scan call, its launches by path held to the plan;
        the comparison waits in ``pending``."""
        before = dict(k4.path_launches)
        got = ops.ssd_scan(a, b, h0)
        made = {k: k4.path_launches[k] - before[k] for k in before}
        h = got[0]
        plan = k4.plan_launch(math.prod(h.shape[:-2]), h.shape[-2],
                              h.shape[-1], h.dtype)
        planned = {k: plan.launches if k == plan.path else 0 for k in before}
        if made != planned:
            raise AssertionError(f"K4 {what}: launched {made}, planned {planned}")
        for k, n in made.items():
            paths[k] += n
        pending.append((got, (a, b, h0), what, tol, plan.path, sum(made.values())))

    def settle():
        for got, (a, b, h0), what, tol, path, launched in pending:
            want = ref.ref_ssd_scan(a, b, h0)
            rtol, atol = tol or SSD_TOL[dtype_name(a.dtype)]
            check(f"k4:{path}:{dtype_name(a.dtype)}", got, want, rtol, atol,
                  f"K4 {path} {what}", launched)
        count = len(pending)
        pending.clear()
        return count

    cases = 0
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    shapes = [(2, T, D) for T in K4_T for D in K4_D]
    shapes += [(2, 3, 300, 48), (3, 2, 200, 256), (1, 3000, 1536)]
    for shape in shapes:
        for dtype in dtypes:
            for with_h0 in (False, True):
                a, b, h0 = ssd_input(torch, gen, dtype, shape, device, with_h0)
                launch(a, b, h0, f"{dtype} {shape} h0={with_h0}")
                cases += settle()
    # views one element off the vector's alignment: the one-value instance
    for dtype in dtypes:
        for T in (200, 4096):
            N, D = 2, 128
            a, b, h0 = ssd_input(torch, gen, dtype, (N, T, D), device, True)
            views = []
            for x in (a, b):
                buf = torch.empty(N * T * D + 1, dtype=dtype, device=device)
                views.append(buf[1:].view(N, T, D).copy_(x))
            va, vb = views
            vec = k4.plan_launch(N, T, D, dtype, (va.data_ptr(), vb.data_ptr())).vec
            if T >= 2 * k4.SHIPPED.chunk and (vec != 1 or k4.plan_launch(
                    N, T, D, dtype, (a.data_ptr(), b.data_ptr())).vec == 1):
                raise AssertionError(f"K4 {dtype} view: vector width {vec}")
            launch(va, vb, h0, f"{dtype} {(N, T, D)} view off alignment")
            cases += settle()
    # h0 broadcast against the trajectory, on both paths
    for T in (100, 256):
        a, b, _ = ssd_input(torch, gen, torch.float32, (2, 3, T, 64), device, False)
        for shape in K4_H0_SHAPES:
            h0 = torch.randn(shape, generator=gen, device=device)
            launch(a, b, h0, f"(2, 3, {T}, 64) h0 {shape}")
        cases += settle()
    # a = b = 1: every state an integer, exact in float32, so bitwise
    for dtype in (torch.float32, torch.bfloat16):
        ones = torch.ones((8, 4096, 1536), dtype=dtype, device=device)
        h0 = torch.randint(-100, 100, (8, 1536), generator=gen, device=device)
        for start in (None, h0.to(dtype)):
            launch(ones, ones, start, f"{dtype} a = b = 1 (8, 4096, 1536) "
                   f"h0={start is not None}", tol=(0.0, 0.0))
            cases += settle()
        del ones
    # 20 calls back to back, no synchronisation between them
    for i in range(20):
        a, b, h0 = ssd_input(torch, gen, torch.float32, (2, 4096, 512), device,
                             i % 2 == 1)
        launch(a, b, h0, f"back-to-back call {i}")
    cases += settle()
    # two streams, each with its own inputs, interleaved
    inputs = [ssd_input(torch, gen, dtype, (4, 2048, 768), device, True)
              for dtype in (torch.float32, torch.bfloat16) for _ in range(3)]
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(device), torch.cuda.Stream(device))
    for i, (a, b, h0) in enumerate(inputs):
        with torch.cuda.stream(streams[i % 2]):
            launch(a, b, h0, f"{a.dtype} stream {i % 2}, call {i}")
    torch.cuda.synchronize()
    cases += settle()
    torch.cuda.empty_cache()
    return cases, paths


def phase_onchip(torch, device):
    from repro_torch.kernels import ops, ref

    mods = kernel_modules()
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    worst = {}

    def check(key, got, want, rtol, atol, what, launched, expected=1):
        if launched != expected:
            raise AssertionError(
                f"{what}: {launched} kernel launches, {expected} planned")
        torch.cuda.synchronize()
        err = assert_match(torch, got, want, rtol, atol, what)
        worst[key] = max(worst.get(key, 0.0), err)

    cases = 0
    worst_row = {}
    # K3: every op over float32 / bf16 / int32 on ragged, N-d and long rows
    # (with a NaN for max), and fp16 / int8 on two shapes
    shapes = [(1, 1), (3, 257), (2, 1000), (2, 3, 64), (2, 3, 5, 700), (1, 70000)]
    combos = [(op, dt, shp) for shp in shapes for op in ("add", "max", "mul")
              for dt in (torch.float32, torch.bfloat16, torch.int32)]
    combos += [(op, dt, shp) for shp in ((3, 257), (1, 70000))
               for op in ("add", "max", "mul") for dt in (torch.float16, torch.int8)]
    for op, dtype, shape in combos:
        x = scan_input(torch, gen, op, dtype, shape, device,
                       nan=op == "max" and dtype.is_floating_point)
        for exclusive in (False, True):
            before = mods["k3"].launches
            got = ops.prefix_scan(x, op=op, exclusive=exclusive)
            launched = mods["k3"].launches - before
            want = ref.ref_prefix_scan(x, op, exclusive=exclusive)
            rtol, atol = scan_tolerance(torch, op, dtype)
            check(f"k3:{op}:{dtype_name(dtype)}", got, want, rtol, atol,
                  f"K3 {op} {dtype} {shape} exclusive={exclusive}", launched)
            cases += 1
    # K4: ragged T, T = 1, N-d, Mamba width, with and without h0
    for shape in ((2, 300, 64), (3, 1, 40), (2, 2, 37, 48), (1, 1000, 1536)):
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                a, b, h0 = ssd_input(torch, gen, dtype, shape, device, with_h0)
                before = mods["k4"].launches
                got = ops.ssd_scan(a, b, h0)
                launched = mods["k4"].launches - before
                want = ref.ref_ssd_scan(a, b, h0)
                rtol, atol = SSD_TOL[dtype_name(dtype)]
                check(f"k4:{dtype_name(dtype)}", got, want, rtol, atol,
                      f"K4 {dtype} {shape} h0={with_h0}", launched)
                cases += 1
    k4_cases, k4_paths = onchip_k4(torch, device, check)
    cases += k4_cases
    # K5: (BH, Sq, Skv, D, causal, window, q_offset)
    flash_cases = [
        (2, 128, 128, 32, True, 0, 0),
        (2, 128, 128, 64, False, 0, 0),
        (2, 128, 128, 128, True, 0, 0),
        (2, 100, 300, 64, False, 0, 0),       # ragged Sq and Skv
        (2, 100, 300, 128, True, 0, 200),     # q_offset
        (3, 1, 300, 64, True, 0, 299),        # one query row
        (2, 1, 2048, 32, True, 0, 2047),
        (2, 256, 256, 64, True, 16, 0),       # window 16
        (1, 1100, 1100, 128, True, 1024, 0),  # window 1024
        (2, 64, 300, 32, False, 16, 100),     # window without causal
        (1, 70, 50, 64, True, 0, -30),        # rows that see no key
        # each case runs in float32, bf16 and fp16: Sq <= 16 takes the
        # decode path in every dtype, longer queries the tensor-core path
        # (bf16, fp16) or the float32 one
        (2, 1, 300, 128, True, 0, 299),       # decode at D = 128
        (2, 16, 1000, 32, True, 0, 984),      # the longest decode query
        (2, 17, 1000, 32, True, 0, 983),      # the shortest prefill query
        (2, 16, 777, 128, False, 0, 0),       # Skv no multiple of tile or split
        (2, 17, 777, 128, False, 0, 0),
        (3, 16, 333, 64, True, 0, 317),
        (3, 17, 333, 64, True, 0, 316),
        (3, 4, 2100, 128, True, 1024, 2096),  # decode with a window
        (2, 3, 700, 64, False, 100, 650),
        (2, 1, 300, 64, True, 0, 5000),       # decode past Skv
        (1, 5, 100, 64, True, 0, -3),         # decode rows that see no key
        (2, 3, 130, 32, False, 8, 400),       # no row sees a key
        (2, 300, 517, 128, True, 0, -100),    # prefill rows that see no key
        (1, 40, 50, 32, True, 0, -20),
        (2, 1000, 1000, 64, True, 0, 0),      # several causal query tiles
        (2, 200, 333, 32, True, 0, 100),
    ]
    for BH, Sq, Skv, D, causal, window, q_offset in flash_cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v = qkv_input(torch, gen, dtype, BH, Sq, Skv, D, device)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            plan = mods["k5"].plan_launch(BH, Sq, Skv, D, dtype, **kw)
            before = mods["k5"].launches
            got = ops.flash_attention(q, k, v, **kw)
            launched = mods["k5"].launches - before
            want = ref.ref_flash_attention(q, k, v, **kw)
            rtol, atol = FLASH_TOL[dtype_name(dtype)]
            what = f"K5 {plan.path} {dtype} {(BH, Sq, Skv, D)} {kw}"
            key = f"k5:{plan.path}:{dtype_name(dtype)}"
            check(key, got, want, rtol, atol, what, launched, plan.launches)
            worst_row[key] = max(worst_row.get(key, 0.0),
                                 check_rows(torch, got, want, dtype, what))
            cases += 1
    emit({
        "phase": "onchip", "cases": cases, "max_abs_err": worst,
        "k5_row_rel_err": worst_row, "k4_path_launches": k4_paths,
        "tolerances": {
            "k3": "bitwise for max and integers; float32 rtol 1e-4 (add atol "
                  "1e-3); bf16 rtol 1e-2, fp16 rtol 2e-3 (add atol = rtol)",
            "k4": SSD_TOL, "k5": FLASH_TOL, "k5_rows": FLASH_ROW_TOL,
        },
        "ok": True,
    })


class EntryCase:
    """One call of an entry point at a full-width shape, with its plain
    version, a PyTorch library call that computes the same function (or
    None), its tolerance and the least time the card could take for it."""

    def __init__(self, key, label, call, plain, library, tol, nbytes,
                 flops=0, dtype=None, head=False, launches=1, path=None):
        self.key, self.label, self.head = key, label, head
        self.call, self.plain, self.library = call, plain, library
        self.tol, self.nbytes, self.flops, self.dtype = tol, nbytes, flops, dtype
        # kernel launches a call makes, and K5's path (from plan_launch)
        self.launches, self.path = launches, path

    def bound(self, card):
        by_bytes = self.nbytes / mem_bandwidth(card) * 1e3
        by_ops = self.flops / peak_flops(card, self.dtype) * 1e3 if self.flops else 0.0
        return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def entry_cases(torch, device):
    """Full-width inputs, made on the card from a seed."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    cases = []

    def scan_case(label, x, op, exclusive=False, head=False):
        library = None
        if not exclusive:
            if op == "max":
                library = lambda: torch.cummax(x, -1)  # noqa: E731
            else:
                fn = torch.cumsum if op == "add" else torch.cumprod
                library = lambda: fn(x, -1, dtype=x.dtype)  # noqa: E731
        cases.append(EntryCase(
            "k3", label,
            lambda: ops.prefix_scan(x, op=op, exclusive=exclusive),
            lambda: ref.ref_prefix_scan(x, op, exclusive=exclusive),
            library, scan_tolerance(torch, op, x.dtype),
            scan_bytes(x), head=head,
        ))

    # Mamba2-130m prefill: within-chunk log-decay scan (B, nc, H, Q) =
    # (8, 16, 24, 256): d_inner 1536 / head_dim 64 = 24 heads, chunk 256,
    # sequence 4096 = 16 chunks
    seg = -0.1 * torch.rand((8, 16, 24, 256), generator=gen, device=device)
    scan_case("mamba2_130m segment scan (8,16,24,256) f32 add", seg, "add")
    # OLMoE-1B-7B: exclusive scan of 64 expert counts
    counts = torch.randint(0, 512, (1, 64), generator=gen, device=device,
                           dtype=torch.int32)
    scan_case("olmoe_1b_7b expert offsets (1,64) int32 add exclusive",
              counts, "add", exclusive=True)
    # the EP region's offsets: the (R, E) counts of 8 co-resident ranks
    counts = torch.randint(0, 256, (8, 64), generator=gen, device=device,
                           dtype=torch.int32)
    scan_case("olmoe_1b_7b EP expert offsets (8,64) int32 add exclusive",
              counts, "add", exclusive=True)
    # memory-bound: I/O offsets / radix bucket bases over 256 MiB
    big = (8192, 8192)
    for op, dtype in (("add", torch.float32), ("max", torch.float32),
                      ("mul", torch.float32), ("add", torch.bfloat16),
                      ("add", torch.int32)):
        x = scan_input(torch, gen, op, dtype, big, device)
        scan_case(f"(8192,8192) {dtype_name(dtype)} {op}", x, op,
                  head=(op, dtype) == ("add", torch.float32))

    # Mamba2-130m SSD recurrence: a, b (8, 4096, 1536), h0 (8, 1536)
    shape = (8, 4096, 1536)
    a = 0.9 + 0.1 * torch.rand(shape, generator=gen, device=device)
    b = torch.randn(shape, generator=gen, device=device)
    h0 = torch.randn((8, 1536), generator=gen, device=device)
    k4 = kernel_modules()["k4"]
    for x, y, h in ((a, b, None), (a, b, h0),
                    (a.bfloat16(), b.bfloat16(), None)):
        nbytes = kernel_bytes("k4", rows=shape[0], time=shape[1],
                              width=shape[2], dtype=x.dtype,
                              h0=h is not None)
        cases.append(EntryCase(
            "k4", f"mamba2_130m ssd (8,4096,1536) {dtype_name(x.dtype)} "
                  f"h0={h is not None}",
            lambda x=x, y=y, h=h: ops.ssd_scan(x, y, h),
            lambda x=x, y=y, h=h: ref.ref_ssd_scan(x, y, h),
            None, SSD_TOL[dtype_name(x.dtype)], nbytes,
            head=h is None and x.dtype == torch.float32,
            path=k4.plan_launch(*shape, x.dtype).path,
        ))

    # attention: (BH, Sq, Skv, D, causal, window, q_offset)
    k5 = importlib.import_module("repro_torch.kernels.flash_attention")
    for label, dtype, (BH, Sq, Skv, D, causal, window, q_offset) in (
        ("smollm_360m causal (60,2048,64) bf16", torch.bfloat16,
         (4 * 15, 2048, 2048, 64, True, 0, 0)),
        ("smollm_360m causal (60,2048,64) fp16", torch.float16,
         (4 * 15, 2048, 2048, 64, True, 0, 0)),
        ("smollm_360m causal (60,2048,64) f32", torch.float32,
         (4 * 15, 2048, 2048, 64, True, 0, 0)),
        ("gemma3_27b local causal window 1024 (64,4096,128) bf16",
         torch.bfloat16, (2 * 32, 4096, 4096, 128, True, 1024, 0)),
        ("smollm_360m decode step (60,1,2048) q_offset 2047 bf16",
         torch.bfloat16, (4 * 15, 1, 2048, 64, True, 0, 2047)),
    ):
        q, k, v = qkv_input(torch, gen, dtype, BH, Sq, Skv, D, device)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        # the library call sees (1, BH, S, D), the layout its fused
        # backends take
        mask = ref.attention_mask(Sq, Skv, kv_len=None, device=device, **kw)
        if bool(mask.all()):
            sdpa = {}
        elif causal and window == 0 and q_offset == 0 and Sq == Skv:
            sdpa = {"is_causal": True}
        else:
            sdpa = {"attn_mask": mask}

        def library(q4=q[None], k4=k[None], v4=v[None], sdpa=sdpa):
            return F.scaled_dot_product_attention(q4, k4, v4, **sdpa)

        plan = k5.plan_launch(BH, Sq, Skv, D, dtype, **kw)
        cost = roofline().kernel_cost("k5", bh=BH, sq=Sq, skv=Skv, d=D,
                                      dtype=dtype, **kw)
        cases.append(EntryCase(
            "k5", label,
            lambda q=q, k=k, v=v, kw=kw: ops.flash_attention(q, k, v, **kw),
            lambda q=q, k=k, v=v, kw=kw: ref.ref_flash_attention(q, k, v, **kw),
            library, FLASH_TOL[dtype_name(dtype)], cost.bytes,
            flops=cost.flops, dtype=dtype,
            head=not cases or cases[-1].key != "k5",
            launches=plan.launches, path=plan.path,
        ))
    torch.cuda.synchronize()
    return cases


def phase_entry(torch, device):
    mods = kernel_modules()
    cases = entry_cases(torch, device)
    for key in ("k3", "k4", "k5"):
        mods[key].launches = 0
    for path in mods["k4"].path_launches:
        mods["k4"].path_launches[path] = 0
    outs = [c.call() for c in cases]
    torch.cuda.synchronize()
    launches = {key: mods[key].launches for key in ("k3", "k4", "k5")}
    k4_paths = dict(mods["k4"].path_launches)
    planned = {path: sum(c.launches for c in cases
                         if c.key == "k4" and c.path == path)
               for path in k4_paths}
    if k4_paths != planned:
        raise AssertionError(f"k4: launched {k4_paths} by path, planned {planned}")
    for key, n in launches.items():
        # K3 and K4 launch once a call; K5 counts what its C entry
        # launched, held to what plan_launch planned
        want = sum(c.launches for c in cases if c.key == key)
        calls = sum(c.key == key for c in cases)
        if n != want:
            raise AssertionError(
                f"{key}: {n} launches for {calls} entry calls, {want} planned")
    rows = []
    for case, got in zip(cases, outs):
        want = case.plain()
        torch.cuda.synchronize()
        err = assert_match(torch, got, want, *case.tol, f"entry {case.label}")
        for leaf in leaves_of(got):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                raise AssertionError(f"entry {case.label}: non-finite output")
        row = {"kernel": case.key, "call": case.label, "max_abs_err": err,
               "tol": list(case.tol), "path": case.path,
               "launches": case.launches}
        if case.key == "k5":
            row["row_rel_err"] = check_rows(torch, got, want, case.dtype,
                                            f"entry {case.label}")
        rows.append(row)
        del want
    del outs
    torch.cuda.empty_cache()
    emit({"phase": "entry", "launches": launches, "k4_path_launches": k4_paths,
          "calls": rows, "ok": True})
    return launches, cases


BASELINE_SIZES = (4, 16, 64, 256, 1024, 1 << 20)
BASELINE_ALGOS = ("sequential", "recursive_doubling", "binomial_tree",
                  "sklansky", "hillis_steele")


def phase_baseline(torch, device):
    """Host-stepped vs one graph replay vs K1 through the engine, p = 8,
    float32 SUM (the paper's Figs. 4-5 on one card)."""
    from statistics import median

    from repro_torch import OffloadEngine
    from repro_torch.core.scan_collective import sim_scan

    hs = importlib.import_module("repro_torch.core.host_scan")
    k1 = kernel_modules()["k1"]
    p = 8
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    eng = OffloadEngine()
    rows = []
    for nb in BASELINE_SIZES:
        x = torch.randn((p, max(1, nb // 4)), generator=gen, device=device)
        for algo in BASELINE_ALGOS:
            want = sim_scan(x, "sum", p, algorithm=algo)
            got = hs.host_scan(x, "sum", p, algorithm=algo)
            assert_match(torch, got, want, 0.0, 0.0, f"host_scan {algo} {nb}B")
            replay, out = hs.offloaded_scan(x, "sum", p, algorithm=algo)
            replay()
            torch.cuda.synchronize()
            assert_match(torch, out, want, 0.0, 0.0, f"graph {algo} {nb}B")
            del replay, out
            row = {
                "bytes_per_rank": nb, "algorithm": algo,
                "host_stepped_us": 1e6 * median(
                    hs.time_host_scan(x, "sum", p, algorithm=algo)
                    for _ in range(3)),
                "graph_replay_us": 1e6 * median(
                    hs.time_offloaded_scan(x, "sum", p, algorithm=algo)
                    for _ in range(3)),
                "hops": len(hs.schedule_trace(algo, p)),
                "k1_dispatch_us": None,
            }
            if algo == "hillis_steele":
                desc = eng.make_descriptor(
                    "SCAN", axes=(1, p), payload_bytes=nb, algorithm=algo,
                    backend="pallas", chunks=1)
                before = k1.launches
                got = eng.offload(desc, x)
                if k1.launches == before:
                    raise AssertionError("the engine did not launch K1")
                assert_match(torch, got, want, 0.0, 0.0, f"K1 dispatch {nb}B")

                def dispatch_median():
                    lat = []
                    for _ in range(20):
                        eng.offload(desc, x)
                        lat.append(eng.telemetry.last_latency_s)
                    return median(lat)

                row["k1_dispatch_us"] = 1e6 * median(
                    dispatch_median() for _ in range(3))
            rows.append(row)
    if eng.telemetry.snapshot()["backend_fallbacks"]:
        raise AssertionError("the engine fell back from K1")
    torch.cuda.empty_cache()
    emit({"phase": "baseline", "p": p, "op": "sum", "dtype": "float32",
          "timing": "host clock around work that ends in a synchronize; "
                    "median of three medians of 20",
          "rows": rows, "host_scan_equals_sim_scan": "bitwise", "ok": True})


# ---------------------------------------------------------------------------
# the measurement layer: the tuner and its table, profiled device latency,
# the traced dispatch
# ---------------------------------------------------------------------------

TUNE_PS = (2, 4, 8, 16)
TUNE_PAYLOADS = (1 << 10, 64 << 10, 1 << 20)
TUNE_COLLS = ("scan", "exscan", "reduce", "allreduce", "barrier")
#: tune_schedule's grid: K1 is raced at the one-axis shapes
SCHEDULE_TOPOLOGIES = ((1, 8), (1, 16), (2, 4))
SCHEDULE_CHUNKS = (1, 2, 4, 8)
SPLIT_TOPOLOGIES = ((2, 4), (4, 2), (2, 2, 2))
SPLIT_PAYLOADS = (1 << 10, 64 << 10)
TUNED_SIZES = (4, 1 << 10, 64 << 10, 1 << 20)


def card_fingerprint(torch) -> str:
    import platform

    major, minor = torch.cuda.get_device_capability(0)
    return (f"torch-cuda:{torch.cuda.get_device_name(0)}:sm_{major}{minor}:"
            f"{platform.machine()}")


def tuned_dispatches(torch, device, eng):
    """(label, descriptor, payload, float64 numpy reference or None) for
    SCAN, EXSCAN, REDUCE, ALLREDUCE and BARRIER at p = 8 and 16, 4 B - 1
    MiB per rank, in the single-axis and the one-axis planned form, int32
    SUM, float32 MAX and float32 SUM, every choice left to "auto"."""
    import numpy as np

    from repro_torch.core.packet import WireDType

    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    out = []
    for p in (8, 16):
        for coll in ("SCAN", "EXSCAN", "REDUCE", "ALLREDUCE", "BARRIER"):
            for nb in ((4,) if coll == "BARRIER" else TUNED_SIZES):
                for form in ("single", "planned"):
                    shape = {"p": p} if form == "single" else {"axes": (1, p)}
                    cases = ((("sum", "float32"),) if coll == "BARRIER" else
                             (("sum", "int32"), ("max", "float32"),
                              ("sum", "float32")))
                    for op, dt in cases:
                        desc = eng.make_descriptor(
                            coll, payload_bytes=nb, op=op,
                            data_type=getattr(WireDType, dt.upper()),
                            algorithm="auto", optimize="auto", chunks="auto",
                            backend="auto", **shape)
                        x, want = None, None
                        if coll != "BARRIER":
                            n = nb // 4
                            if dt == "int32":
                                x = torch.randint(-1000, 1000, (p, n),
                                                  generator=gen, device=device,
                                                  dtype=torch.int32)
                            else:
                                x = torch.randn((p, n), generator=gen,
                                                device=device)
                            if (op, dt) == ("sum", "float32"):
                                xs = x.double().cpu().numpy()
                                total = xs.sum(0)
                                want = {
                                    "SCAN": np.cumsum(xs, 0),
                                    "EXSCAN": np.concatenate(
                                        [np.zeros_like(xs[:1]),
                                         np.cumsum(xs, 0)[:-1]]),
                                    "REDUCE": np.concatenate(
                                        [total[None], np.zeros_like(xs[1:])]),
                                    "ALLREDUCE": np.broadcast_to(total,
                                                                 xs.shape),
                                }[coll]
                        label = f"{coll} {form} p={p} {nb}B {op} {dt}"
                        out.append((label, (op, dt), desc, x, want))
    return out


def phase_tune(torch, device):
    """The tuner on the card: autotune, tune_schedule (K1 raced at the
    one-axis shapes) and tune_splits into one table; the table's checks;
    then tuned dispatches against untuned ones."""
    import os
    import tempfile
    import warnings

    import numpy as np

    from repro_torch import OffloadEngine
    from repro_torch.core.algorithms import ALGORITHMS
    from repro_torch.core.operators import get_operator
    from repro_torch.core.selector import (DEFAULT_LINK_MODEL,
                                           get_active_tuning,
                                           select_algorithm)
    from repro_torch.offload import backends, passes, planner, tuner
    from repro_torch.offload.tuning_cache import TuningCache, deactivate

    k1 = kernel_modules()["k1"]
    t0 = time.perf_counter()
    if any(p & (p - 1) for p in TUNE_PS):
        raise AssertionError("the grid count below assumes power-of-two p")
    table = tuner.autotune(ps=TUNE_PS, payloads=TUNE_PAYLOADS,
                           colls=TUNE_COLLS, iters=5)
    # sum admits every algorithm; allreduce and barrier measure their one
    # power-of-two butterfly
    want = len(TUNE_PS) * len(TUNE_PAYLOADS) * (3 * len(ALGORITHMS) + 2)
    keys = {(m.coll, m.algo, m.p, m.payload_bytes) for m in table.measurements}
    if len(table.measurements) != want or len(keys) != want:
        raise AssertionError(f"autotune measured {len(table.measurements)} "
                             f"points ({len(keys)} distinct) of {want}")
    t_auto = time.perf_counter() - t0

    launches0 = k1.launches
    tuner.tune_schedule(topologies=SCHEDULE_TOPOLOGIES,
                        payloads=TUNE_PAYLOADS, colls=("scan", "exscan"),
                        chunks=SCHEDULE_CHUNKS, backends=("", "pallas"),
                        iters=3, cache=table)
    k1_capture_launches = k1.launches - launches0
    fused = backends.get_backend("pallas")
    want_rows = set()
    for sizes in SCHEDULE_TOPOLOGIES:
        for nb in TUNE_PAYLOADS:
            for coll in ("scan", "exscan"):
                for opt in (False, True):
                    for c in SCHEDULE_CHUNKS:
                        want_rows.add((coll, sizes, opt, c, "", nb))
                        plan = planner.build_plan(coll, sizes, "sum", nb)
                        if opt:
                            plan = passes.optimize_plan(plan)
                        if c > 1:
                            plan = dataclasses.replace(plan, chunking=c)
                        if fused.capabilities(plan)[0]:
                            want_rows.add((coll, sizes, opt, c, "pallas", nb))
    rows = [(m.coll, m.sizes, m.optimized, m.chunks, m.backend,
             m.payload_bytes) for m in table.fusion_measurements]
    if len(rows) != len(want_rows) or set(rows) != want_rows:
        raise AssertionError(f"tune_schedule measured {len(rows)} variants "
                             f"of {len(want_rows)}")
    raced = {(r[1], r[5], r[0]) for r in rows if r[4] == "pallas"}
    one_axis = {(s, nb, c) for s in SCHEDULE_TOPOLOGIES if s[0] == 1
                for nb in TUNE_PAYLOADS for c in ("scan", "exscan")}
    if raced != one_axis:
        raise AssertionError(f"K1 raced at {sorted(raced)}, not at every "
                             "one-axis point")
    if k1_capture_launches <= 0:
        raise AssertionError("tune_schedule launched no K1")
    t_sched = time.perf_counter() - t0 - t_auto

    tuner.tune_splits(topologies=SPLIT_TOPOLOGIES, payloads=SPLIT_PAYLOADS,
                      colls=("scan", "allreduce"), iters=3, cache=table)
    want_splits = sum(math.factorial(len(s)) for s in SPLIT_TOPOLOGIES) * (
        len(SPLIT_PAYLOADS) * 2)
    if len(table.split_measurements) != want_splits:
        raise AssertionError(f"tune_splits measured "
                             f"{len(table.split_measurements)} of {want_splits}")
    t_tuned = time.perf_counter() - t0

    if table.backend != card_fingerprint(torch):
        raise AssertionError(f"table fingerprint {table.backend!r}")
    fit = table.fitted_model()
    if fit is None:
        raise AssertionError("no fitted model")
    with tempfile.TemporaryDirectory() as td:
        path = table.save(os.path.join(td, "table.json"))
        again = TuningCache.load_compatible(path)
        if again is None or any(
                getattr(again, w) != getattr(table, w)
                for w in ("winners", "split_winners", "schedule_winners",
                          "backend_winners", "fusion_winners")):
            raise AssertionError("saved table came back with other winners")
        data = json.loads(Path(path).read_text())
        data["backend"] = f"gpu:{torch.cuda.get_device_name(0)}:x86_64"
        jax_path = Path(td) / "jax_table.json"
        jax_path.write_text(json.dumps(data))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if TuningCache.load_compatible(jax_path) is not None:
                raise AssertionError("a table with a jax fingerprint loaded")
        if not any("measured on backend" in str(w.message) for w in caught):
            raise AssertionError("no warning for the jax-fingerprint table")

    # tuned dispatches against the untuned engine's, the same payloads
    untuned = OffloadEngine()
    base = tuned_dispatches(torch, device, untuned)
    want_out = [untuned.offload(d, x) for _, _, d, x, _ in base]
    table.activate()
    if get_active_tuning() is not table:
        raise AssertionError("the table is not active")
    eng = OffloadEngine()
    cases = tuned_dispatches(torch, device, eng)
    words_changed = 0
    checked = 0
    for (label, kind, desc, x, ref), (_, _, udesc, _, _), unt in zip(
            cases, base, want_out):
        got = eng.offload(desc, x)
        words_changed += desc.encode().tobytes() != udesc.encode().tobytes()
        if kind == ("sum", "float32"):
            if ref is None:  # BARRIER: the token
                assert_match(torch, got, unt, 0.0, 0.0, f"tuned {label}")
            else:
                rtol, atol = scan_tolerance(torch, "add", torch.float32)
                np.testing.assert_allclose(got.double().cpu().numpy(), ref,
                                           rtol=rtol, atol=atol,
                                           err_msg=f"tuned {label}")
        else:
            assert_match(torch, got, unt, 0.0, 0.0, f"tuned {label}")
        if not bool(torch.isfinite(got.double()).all()):
            raise AssertionError(f"tuned {label}: non-finite output")
        checked += 1
    snap = eng.telemetry.snapshot()

    winners = []
    for coll in TUNE_COLLS:
        op = get_operator("max" if coll == "barrier" else "sum")
        for nb in TUNE_PAYLOADS:
            win = table.winners[(coll, 8, nb)]
            pick = select_algorithm(8, nb, op, model=DEFAULT_LINK_MODEL,
                                    coll=coll)
            times = {m.algo: m.seconds for m in table.measurements
                     if (m.coll, m.p, m.payload_bytes) == (coll, 8, nb)}
            winners.append({
                "coll": coll, "bytes_per_rank": nb, "measured_winner": win,
                "winner_us": 1e6 * times[win],
                "default_model_pick": pick,
                "default_pick_us": (1e6 * times[pick] if pick in times
                                    else None)})
    races = []
    for sizes in SCHEDULE_TOPOLOGIES:
        if sizes[0] != 1:
            continue
        for coll in ("scan", "exscan"):
            for nb in TUNE_PAYLOADS:
                best = {}
                for m in table.fusion_measurements:
                    if (m.coll, m.sizes, m.payload_bytes) == (coll, sizes, nb):
                        b = m.backend or "default"
                        best[b] = min(best.get(b, math.inf), m.seconds)
                races.append({
                    "coll": coll, "sizes": list(sizes), "bytes_per_rank": nb,
                    "winner": table.backend_winner(coll, sizes, nb) or "default",
                    "default_us": 1e6 * best["default"],
                    "pallas_us": 1e6 * best["pallas"],
                    "schedule_winner": list(table.schedule_winner(coll, sizes,
                                                                  nb))})
    deactivate()
    if get_active_tuning() is not None:
        raise AssertionError("the table is still active")
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "tune", "fingerprint": table.backend,
          "timing": "CUDA events; inner = 1 eager, inner > 1 one CUDA graph "
                    "of inner chained runs",
          "fitted": {"alpha": fit.alpha, "beta": fit.beta, "gamma": fit.gamma},
          "autotune_points": len(table.measurements),
          "schedule_points": len(rows), "split_points": want_splits,
          "k1_launches_in_tune_schedule": k1_capture_launches,
          "p8_winners": winners, "backend_races": races,
          "tuned_dispatches": checked,
          "tuned_descriptors_that_differ": words_changed,
          "tuned_backend_fallbacks": snap["backend_fallback_reasons"],
          "seconds": {"autotune": round(t_auto, 3),
                      "tune_schedule": round(t_sched, 3),
                      "tune_splits": round(t_tuned - t_auto - t_sched, 3),
                      "phase": round(seconds, 3)},
          "ok": True})
    return seconds


def profiled_ok(timing, launched=0):
    return (timing.source == "profiler" and timing.events >= max(1, launched)
            and 0 < timing.device_us <= timing.wall_us)


def profile_retaken(torch, call, launches_of=None):
    """``call()`` -> DeviceTiming, taken again (CUPTI now and then drops
    activities) up to three times in all until it passes ``profiled_ok``;
    returns (timing, launches counted in the window)."""
    for _attempt in range(3):
        before = launches_of() if launches_of else 0
        timing = call()
        launched = (launches_of() - before) if launches_of else 0
        if profiled_ok(timing, launched):
            return timing, launched
    raise AssertionError(f"profiled dispatch failed three times: {timing} "
                         f"({launched} launches in the window)")


def first_launch(trace_path):
    """The first kernel launch a profiler session recorded (the primer of
    ``profile_call``): its host duration and whether its kernel left a
    device record."""
    from repro_torch.obs.export import load_chrome_trace
    from repro_torch.offload.profiling import DEVICE_EVENT_CATS

    if trace_path is None:
        return {"first_launch_us": None, "first_launch_recorded": None}
    events = [e for e in load_chrome_trace(trace_path)["traceEvents"]
              if e.get("ph") == "X"]
    launches = sorted((e for e in events if e.get("name") == "cudaLaunchKernel"),
                      key=lambda e: float(e["ts"]))
    if not launches:
        return {"first_launch_us": None, "first_launch_recorded": None}
    corr = (launches[0].get("args") or {}).get("correlation")
    return {"first_launch_us": float(launches[0].get("dur", 0.0)),
            "first_launch_recorded": any(
                e.get("cat") in DEVICE_EVENT_CATS
                and (e.get("args") or {}).get("correlation") == corr
                for e in events)}


def phase_profile(torch, device):
    """profile_offload on the card: K1 through the engine in sim mode, the
    default sim lowering, driver mode, K2's per-rank lowering under
    shard_map and the (2, 4) planned optimized SCAN; then one traced K1
    dispatch: its spans, the merged trace, the metrics."""
    import tempfile
    from statistics import median

    from repro_torch import OffloadEngine
    from repro_torch.compat import Mesh, shard_map
    from repro_torch.core import algorithms as alg
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracing as obs_tracing
    from repro_torch.offload import backends, planner
    from repro_torch.offload.profiling import profile_call

    mods = kernel_modules()
    k1, k2 = mods["k1"], mods["k2"]
    t0 = time.perf_counter()
    p = 8
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    eng = OffloadEngine()
    line = Mesh((1, p), ("o", "i"), device=device)
    ring = Mesh((p,), ("i",), device=device)
    grid = Mesh((2, 4), ("a", "b"), device=device)
    def dispatch_us(desc, x):
        lat = []
        for _ in range(23):  # unprofiled: the engine's own clock
            eng.offload(desc, x)
            lat.append(eng.telemetry.last_latency_s * 1e6)
        return median(lat[3:])

    # every size's legs, and their unprofiled dispatch time before this
    # process has run a profiler session
    sizes = []
    for nb in BASELINE_SIZES:
        x = torch.randn((p, max(1, nb // 4)), generator=gen, device=device)
        legs = []
        for backend in ("pallas", ""):
            desc = eng.make_descriptor("SCAN", axes=(1, p), payload_bytes=nb,
                                       algorithm="hillis_steele",
                                       backend=backend, chunks=1)
            eng.offload(desc, x)
            legs.append((f"sim {backend or 'default'}", desc, {},
                         dispatch_us(desc, x), k1 if backend else None))
            if backend:
                legs.append(("driver", desc,
                             {"axis_name": ("o", "i"), "mesh": line}, None,
                             None))
        d24 = eng.make_descriptor("SCAN", axes=(2, 4), payload_bytes=nb,
                                  split=(0, 1), optimize=True)
        legs.append(("driver (2,4) optimized", d24,
                     {"axis_name": ("a", "b"), "mesh": grid}, None, None))
        sizes.append((nb, x, legs))
    # two sessions in a row, after the serving path's and the mesh phase's
    # profiler sessions: the second must hold K1's device event (a first
    # launch there once left no device record; profile_call's primer launch
    # is the repair), taken once
    twice = []
    with tempfile.TemporaryDirectory() as keep:
        for _ in range(2):
            before = k1.launches
            timing = eng.profile_offload(sizes[0][2][0][1], sizes[0][1],
                                         warmup=0, trace_dir=keep)
            twice.append({"source": timing.source, "events": timing.events,
                          "launches": k1.launches - before,
                          "fallback_reason": timing.fallback_reason,
                          **first_launch(timing.trace_path)})
    if not profiled_ok(timing, twice[-1]["launches"]):
        raise AssertionError(f"the second of two sessions in a row: {twice}")
    rows = []
    for nb, x, legs in sizes:
        want = eng.offload(legs[0][1], x)  # K1
        row = {"bytes_per_rank": nb}
        for label, desc, kw, before_us, mod in legs:
            sim = eng.offload(desc, x)
            if label == "sim default":  # hillis_steele either way: bitwise
                assert_match(torch, sim, want, 0.0, 0.0, f"K1 vs sim {nb}B")
            eng.offload(desc, x, **kw)  # warm: the window holds one dispatch
            timing, launched = profile_retaken(
                torch, lambda: eng.profile_offload(desc, x, warmup=0, **kw),
                (lambda m=mod: m.launches) if mod else None)
            if eng.telemetry.snapshot()["latency_source_by_coll"].get(
                    "scan") != "profiler":
                raise AssertionError(f"profile {label} {nb}B: source not "
                                     "the profiler in the snapshot")
            got = eng.offload(desc, x, **kw)
            assert_match(torch, got, sim, 0.0, 0.0, f"profile {label} {nb}B")
            row[label] = {
                "device_us": timing.device_us, "wall_us": timing.wall_us,
                "host_share": 1 - timing.device_us / timing.wall_us,
                "events": timing.events, "launches": launched}
            if before_us is not None:
                row[label]["dispatch_us"] = before_us
                row[label]["dispatch_host_share"] = (
                    1 - timing.device_us / before_us)
        # K2: the per-rank fused lowering under the port's shard_map (the
        # engine's planned descriptors bind one axis name per axis, and K2
        # takes a one-axis mesh only, so no descriptor reaches it)
        plan = planner.build_plan("SCAN", (p,), "sum", nb)
        run = shard_map(backends.get_backend("pallas").lower(
            plan, "sum", axis_names=("i",)), ring, ("i",), "i")
        assert_match(torch, run(x), want, 0.0, 0.0, f"profile K2 {nb}B")
        paths = dict(k2.path_launches)
        timing, launched = profile_retaken(
            torch, lambda: profile_call(lambda: run(x), f"k2_spmd:scan:p{p}",
                                        coll="scan"),
            lambda: k2.launches)
        row["k2 per-rank"] = {
            "device_us": timing.device_us, "wall_us": timing.wall_us,
            "host_share": 1 - timing.device_us / timing.wall_us,
            "events": timing.events, "launches": launched,
            "path_launches": {k: v - paths[k]
                              for k, v in k2.path_launches.items()}}
        rows.append(row)
    # the same dispatches again, now that the profiler has run
    for (nb, x, legs), row in zip(sizes, rows):
        for label, desc, _, before_us, _ in legs:
            if before_us is not None:
                row[label]["dispatch_us_after_profiling"] = dispatch_us(desc,
                                                                        x)
    snap = eng.telemetry.snapshot()
    if snap["profiler_fallbacks"]:
        raise AssertionError(f"profiler fallbacks {snap['profiler_fallback_reasons']}")
    t_profiled = time.perf_counter() - t0

    # the traced K1 dispatch
    prev = obs_metrics.set_registry(obs_metrics.MetricsRegistry())
    try:
        teng = OffloadEngine()
        nb = 1 << 10
        x = torch.randn((p, nb // 4), generator=gen, device=device)
        desc = teng.make_descriptor("SCAN", axes=(1, p), payload_bytes=nb,
                                    algorithm="hillis_steele",
                                    backend="pallas", chunks=1)
        untraced = teng.offload(desc, x)
        before = k1.launches
        with obs_tracing.tracing() as tracer:
            traced = teng.offload(desc, x)
        if k1.launches == before:
            raise AssertionError("the traced dispatch launched no K1")
        assert_match(torch, traced, untraced, 0.0, 0.0, "traced K1 dispatch")
        spans = tracer.spans()
        by_id = {s.span_id: s for s in spans}
        roots = [s for s in spans if s.parent_id is None]
        if [s.name for s in roots] != ["engine.offload"]:
            raise AssertionError(f"span roots {[s.name for s in roots]}")
        root = roots[0]
        compiles = [s for s in spans if s.name == "engine.compile"]
        phases = [s for s in spans if s.cat == "phase"]
        rounds = [s for s in spans if s.cat == "round"]
        want_rounds = alg.phase_round_count("SCAN", p, inclusive=True)
        if (len(compiles) != 1 or compiles[0].parent_id != root.span_id
                or root.args.get("cache") != "miss"):
            raise AssertionError("no engine.compile under the missed dispatch")
        if len(phases) != 1 or phases[0].parent_id != root.span_id:
            raise AssertionError(f"phase spans {[s.name for s in phases]}")
        if (len(rounds) != want_rounds or phases[0].args.get("rounds")
                != want_rounds or any(r.parent_id != phases[0].span_id
                                      for r in rounds)):
            raise AssertionError(f"{len(rounds)} K1 round spans, want "
                                 f"{want_rounds}")
        for s in spans:
            parent = by_id.get(s.parent_id)
            if parent and not (parent.start_us <= s.start_us
                               and s.end_us <= parent.end_us + 1e-3):
                raise AssertionError(f"span {s.name} escapes {parent.name}")
        with obs_tracing.tracing() as tracer2:
            with tempfile.TemporaryDirectory() as td:
                for _attempt in range(3):
                    tracer2.clear()
                    timing = teng.profile_offload(desc, x, trace_dir=td)
                    if profiled_ok(timing):
                        break
                else:
                    raise AssertionError(f"traced profile: {timing}")
                host = obs_export.spans_to_chrome(tracer2.spans())
                merged = obs_export.merge_device_trace(
                    host, obs_export.load_chrome_trace(timing.trace_path))
        if not merged["deviceClockAligned"] or not merged["deviceEventsMerged"]:
            raise AssertionError("merged trace not aligned")
        prom = obs_metrics.render_prometheus()
        for series in ("repro_engine_dispatches_total",
                       "repro_engine_device_latency_us_bucket"):
            if series not in prom:
                raise AssertionError(f"{series} missing from the metrics")
    finally:
        obs_metrics.set_registry(prev)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "profile", "p": p, "coll": "SCAN", "op": "sum",
          "dtype": "float32",
          "timing": "device_us: union of the window's kernels, copies and "
                    "memsets (torch.profiler, CUPTI); wall_us: host clock "
                    "around the profiled dispatch, profiler on; dispatch_us: "
                    "the engine's own clock, median of 20 after 3, before "
                    "this phase's profiler sessions (and again after them)",
          "two_sessions": twice,
          "rows": rows,
          "backend_fallbacks": snap["backend_fallback_reasons"],
          "traced": {"spans": len(spans), "k1_round_spans": len(rounds),
                     "phase_round_count": want_rounds,
                     "merged_device_events": merged["deviceEventsMerged"],
                     "aligned": merged["deviceClockAligned"],
                     "bitwise_equal_untraced": True},
          "seconds": {"profiled": round(t_profiled, 3),
                      "phase": round(seconds, 3)},
          "ok": True})
    return seconds


# ---------------------------------------------------------------------------
# K2: the per-rank collective kernel, through the registry under shard_map
# ---------------------------------------------------------------------------

SPMD_PS = (8, 16)
#: rank counts of a reduced case list: 32 takes K2's flags path, the others
#: clusters of a size that is no power of two
SPMD_PS_REDUCED = (3, 6, 12, 32)
WIRE_DTYPES = ("int32", "float32", "bfloat16", "float16", "int8")


def spmd_plans(torch, p):
    """(label, plan, op name, dtype, bytes per rank) of the spmd phase: the
    cases of repro/testing/pallas_check.py over the osu sizes, ALLREDUCE on
    every wire dtype and over the SSD and flash operators, and a 25 MiB
    ALLREDUCE at p = 8; for the rank counts
    of ``SPMD_PS_REDUCED``, the scans, the fused plan and (pow2 p) the
    float32 ALLREDUCE and BARRIER at 4 B, 1 KiB and 1 MiB."""
    import dataclasses

    from repro_torch.offload.planner import PhaseKind, PlanPhase, build_plan

    hs = ("hillis_steele",)
    cases = []
    if p in SPMD_PS_REDUCED:
        pow2 = p & (p - 1) == 0
        for nb in (4, 1 << 10, 1 << 20):
            for coll in ("SCAN", "EXSCAN"):
                cases.append((f"{coll} sum", build_plan(
                    coll, (p,), "sum", nb, level_algorithms=hs),
                    "sum", torch.float32, nb))
            if pow2:
                cases.append(("ALLREDUCE sum", build_plan(
                    "ALLREDUCE", (p,), "sum", nb), "sum", torch.float32, nb))
            for inclusive in (True, False):
                base = build_plan("SCAN" if inclusive else "EXSCAN", (p,),
                                  "sum", nb, level_algorithms=hs)
                phase = PlanPhase(PhaseKind.FUSED_SCAN_TOTAL, 0,
                                  "fused_doubling", inclusive=inclusive,
                                  src=("x",), dst="y", dst2="t")
                cases.append((
                    f"FUSED {'inc' if inclusive else 'exc'} t",
                    dataclasses.replace(base, phases=(phase,), result="t"),
                    "sum", torch.float32, nb))
        if pow2:
            cases.append(("BARRIER", build_plan("BARRIER", (p,), "max", 4),
                          "max", torch.float32, 4))
        return cases
    for nb in MAIN_SIZES:
        for coll in ("SCAN", "EXSCAN"):
            for dtype in (torch.float32, torch.int32):
                cases.append((f"{coll} sum", build_plan(
                    coll, (p,), "sum", nb, level_algorithms=hs),
                    "sum", dtype, nb))
        for opname in ("sum", "max", "min", "prod"):
            for name in WIRE_DTYPES:
                cases.append((f"ALLREDUCE {opname}", build_plan(
                    "ALLREDUCE", (p,), opname, nb), opname,
                    getattr(torch, name), nb))
        cases.append(("ALLREDUCE ssd", build_plan("ALLREDUCE", (p,), "ssd", nb),
                      "ssd", torch.float32, nb))
        for name in ("float32", "bfloat16"):
            cases.append(("ALLREDUCE flash", build_plan(
                "ALLREDUCE", (p,), "flash", nb), "flash", getattr(torch, name),
                nb))
        for inclusive in (True, False):
            # pallas_check's hand-fused FUSED_SCAN_TOTAL plan, both outputs
            base = build_plan("SCAN" if inclusive else "EXSCAN", (p,), "sum",
                              nb, level_algorithms=hs)
            phase = PlanPhase(PhaseKind.FUSED_SCAN_TOTAL, 0, "fused_doubling",
                              inclusive=inclusive, src=("x",), dst="y",
                              dst2="t")
            for result in ("y", "t"):
                cases.append((
                    f"FUSED {'inc' if inclusive else 'exc'} {result}",
                    dataclasses.replace(base, phases=(phase,), result=result),
                    "sum", torch.float32, nb))
    cases.append(("BARRIER", build_plan("BARRIER", (p,), "max", 4), "max",
                  torch.float32, 4))
    if p == 8:
        cases.append(("ALLREDUCE sum", build_plan(
            "ALLREDUCE", (p,), "sum", ALLREDUCE_BIG), "sum", torch.float32,
            ALLREDUCE_BIG))
    return cases


def spmd_plain(torch, plan, p, op):
    """K2's plain version of a one-comm-phase plan, per rank."""
    from repro_torch import compat
    from repro_torch.core.operators import MAX
    from repro_torch.kernels.spmd_collective import comm_phase_spmd_plain
    from repro_torch.offload.planner import PhaseKind

    (ph,) = plan.phases
    phase_op = MAX if ph.kind == PhaseKind.BARRIER else op

    def run(x):
        if x is None:  # the barrier's fence token, as the lowering makes it
            x = compat.mesh_of("i").ranks.rank_ones(torch.float32)
        out = comm_phase_spmd_plain(ph.kind, p, "i", phase_op, x,
                                    inclusive=ph.inclusive)
        if ph.kind == PhaseKind.FUSED_SCAN_TOTAL:
            return out[0] if plan.result == "y" else out[1]
        return out

    return run


def phase_spmd(torch, device):
    """K2 through ``get_backend("pallas").lower(plan, op, axis_names=("i",))``
    under the port's shard_map on co-resident meshes of 8 and 16 ranks (and
    3, 6, 12 and 32 on fewer cases), held bitwise against its plain
    version, K1 and lower_spmd, each path's launches held to
    ``plan_launch``'s; then the engine in driver mode against sim mode."""
    import numpy as np

    from repro_torch import OffloadEngine
    from repro_torch.compat import Mesh, shard_map
    from repro_torch.core.operators import get_operator
    from repro_torch.kernels import fused_collective as fc
    from repro_torch.kernels import spmd_collective as k2
    from repro_torch.offload import backends
    from repro_torch.offload.planner import PhaseKind, lower_spmd

    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    pallas = backends.get_backend("pallas")
    runs = []
    for p in SPMD_PS + SPMD_PS_REDUCED:
        mesh = Mesh((p,), ("i",), device=device)
        for label, plan, opname, dtype, nb in spmd_plans(torch, p):
            ok, reason = pallas.capabilities(plan, ("i",))
            if not ok:
                raise AssertionError(f"{label}: K2 refuses the plan ({reason})")
            x = None
            if plan.coll.name != "BARRIER":
                n = max(1, nb // torch.empty((), dtype=dtype).element_size())
                x = make_input(torch, gen, opname, dtype, (p, n), device)
            lowered = pallas.lower(plan, opname, axis_names=("i",))
            if x is None:
                run = shard_map(lambda f=lowered: f(None), mesh, (), "i")
            else:
                run = shard_map(lowered, mesh, ("i",), "i")
            runs.append((p, mesh, label, plan, opname, dtype, nb, x, run))
    torch.cuda.synchronize()

    # the launches plan_launch gives each path
    planned = {"cluster": 0, "flags": 0}
    for p, mesh, label, plan, opname, dtype, nb, x, run in runs:
        (ph,) = plan.phases
        n_leaves = len(leaves_of(x)) if x is not None else 1
        M = leaves_of(x)[0].shape[1] if x is not None else 1
        got = k2.plan_launch(ph.kind, p, M, dtype, n_leaves,
                             inclusive=ph.inclusive)
        planned[got.path] += 2 * got.launches

    # K2's path: counts zeroed just before, read just after
    k2.launches = 0
    for key in k2.path_launches:
        k2.path_launches[key] = 0
    outs = []
    for *_, x, run in runs:
        args = () if x is None else (x,)
        first = run(*args)
        again = run(*args)  # a second dispatch: new epoch, same flags
        outs.append((first, again))
    torch.cuda.synchronize()
    launches = k2.launches
    paths = dict(k2.path_launches)
    if launches != 2 * len(runs):
        raise AssertionError(
            f"K2 launched {launches} times for {2 * len(runs)} dispatches of "
            "one-comm-phase plans")
    if paths != planned:
        raise AssertionError(f"K2 launches by path {paths}, planned {planned}")

    order_cases = 0
    # operand order: SCAN and FUSED over SSD's non-commutative combine (no
    # plan routes them to K2, which scans zero-identity operators only)
    ssd = get_operator("ssd")
    for p in SPMD_PS:
        mesh = Mesh((p,), ("i",), device=device)
        x = make_input(torch, gen, "ssd", torch.float32, (p, 3000), device)
        for kind, inclusive in ((PhaseKind.SCAN, True), (PhaseKind.SCAN, False),
                                (PhaseKind.FUSED_SCAN_TOTAL, True),
                                (PhaseKind.FUSED_SCAN_TOTAL, False)):
            def per_rank(fn, kind=kind, inclusive=inclusive, p=p):
                return shard_map(
                    lambda t: fn(kind, p, "i", ssd, t, inclusive=inclusive),
                    mesh, ("i",), "i")(x)

            got = per_rank(k2.comm_phase_spmd)
            want = per_rank(k2.comm_phase_spmd_plain)
            k1 = fc.comm_phase(kind, p, ssd, x, inclusive=inclusive)
            torch.cuda.synchronize()
            pairs = zip(got, want, k1) if kind == PhaseKind.FUSED_SCAN_TOTAL \
                else [(got, want, k1)]
            what = f"spmd p={p} {kind.name} incl={inclusive} ssd"
            for g, w, k in pairs:
                assert_match(torch, g, k, 0.0, 0.0, what + " vs K1")
                assert_match(torch, g, w, *tolerance(torch, "ssd", torch.float32),
                             what + " vs plain")
            order_cases += 1

    worst = {}
    checked = 0
    for (p, mesh, label, plan, opname, dtype, nb, x, run), (first, again) in \
            zip(runs, outs):
        op = get_operator(opname)
        args = () if x is None else (x,)
        spec = ((), "i") if x is None else (("i",), "i")

        def per_rank(f):
            return shard_map(
                (lambda: f(None)) if x is None else f, mesh, *spec)(*args)

        plain = per_rank(spmd_plain(torch, plan, p, op))
        spmd = per_rank(lower_spmd(plan, ("i",), op))
        k1 = fc.lower_fused(plan, op, device=device)(x)
        torch.cuda.synchronize()
        what = f"spmd p={p} {label} {dtype_name(dtype)} {nb}B"
        # bitwise: the plain version and lower_spmd repeat K1's combines in
        # the reference's order, all but flash's exp (PyTorch's, not expf)
        rtol, atol = tolerance(torch, opname, dtype) if opname == "flash" \
            else (0.0, 0.0)
        assert_match(torch, again, first, 0.0, 0.0, what + " (again)")
        assert_match(torch, first, k1, 0.0, 0.0, what + " vs K1")
        err = max(assert_match(torch, first, plain, rtol, atol, what + " vs plain"),
                  assert_match(torch, first, spmd, rtol, atol, what + " vs lower_spmd"))
        key = f"{opname}:{dtype_name(dtype)}"
        worst[key] = max(worst.get(key, 0.0), err)
        for leaf in leaves_of(first):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                raise AssertionError(f"{what}: non-finite output")
        if label == "SCAN sum" and dtype == torch.float32 and nb == 1 << 10:
            xs = x.double().cpu().numpy()
            np.testing.assert_allclose(first.double().cpu().numpy(),
                                       np.cumsum(xs, 0), rtol=1e-5, atol=1e-4,
                                       err_msg=what)
        if label == "BARRIER" and not bool((first == 1).all()):
            raise AssertionError(f"{what}: barrier token is not 1")
        checked += 1
    del runs, outs

    # the engine in driver mode on the card, against sim mode
    eng = OffloadEngine()
    driver = []
    for p in SPMD_PS:
        mesh = Mesh((p,), ("i",), device=device)
        for coll in ("SCAN", "EXSCAN", "REDUCE", "ALLREDUCE", "BARRIER"):
            desc = eng.make_descriptor(coll, p=p, payload_bytes=16 << 10)
            driver.append((coll, desc, mesh, "i"))
    mesh = Mesh((2, 4), ("a", "b"), device=device)
    desc = eng.make_descriptor("SCAN", axes=(2, 4), payload_bytes=16 << 10)
    driver.append(("SCAN (2,4) planned", desc, mesh, ("a", "b")))
    for coll, desc, mesh, axis in driver:
        x = None
        if desc.coll_type.name != "BARRIER":
            x = torch.randn((desc.comm_size, 4096), generator=gen, device=device)
        got = eng.offload(desc, x, axis_name=axis, mesh=mesh)
        want = eng.offload(desc, x)
        assert_match(torch, got, want, 0.0, 0.0,
                     f"driver {coll} p={desc.comm_size}")
    snap = eng.telemetry.snapshot()
    emit({"phase": "spmd", "ranks": list(SPMD_PS + SPMD_PS_REDUCED),
          "cases": checked, "operand_order_cases": order_cases,
          "k2_launches": launches,
          "k2_path_launches": paths, "dispatches": 2 * checked,
          "launches_per_dispatch": launches / (2 * checked),
          "max_abs_err_vs_plain_by_op": worst,
          "driver_cases": len(driver), "driver_dispatches": snap["dispatches"],
          "ok": True})
    torch.cuda.empty_cache()
    return launches


#: the shapes where K1 and K2 are each timed on their new path beside the
#: PR 13 path in one run: the headline, p = 16, and DDP's 25 MiB bucket
COMPARE_SHAPES = (("SCAN", 8, 1 << 20), ("SCAN", 16, 1 << 20),
                  ("ALLREDUCE", 8, ALLREDUCE_BIG))
#: the card's L2 (50 MB on an H100): a call whose input and output fit is
#: served from it when timed back to back, below the HBM bound's reach
L2_BYTES = 50e6


def paths_in_turns(torch, calls, iters):
    """Device time (profiler, the named kernel) and event time per call of
    each entry of ``calls`` ({label: (fn, kernel name)}), taken in turns
    a, b, b, a within this run; a list of the two readings each."""
    names = list(calls)
    out = {n: {"ms": [], "event_ms": []} for n in names}
    for n in names + names[::-1]:
        fn, kernel = calls[n]
        out[n]["ms"].append(device_ms(torch, fn, iters, name=kernel))
        out[n]["event_ms"].append(time_ms(torch, fn, iters))
    return out


def compare_row(torch, key, coll, p, nb, x, times, library, card, iters):
    """One same-run comparison row of two paths, beside the library call
    and the bytes bound."""
    nbytes = kernel_bytes(  # read once, written once
        key, phase="TOTAL" if coll == "ALLREDUCE" else "SCAN", p=p,
        numel=x.numel(), dtype=x.dtype)
    bound_ms = nbytes / mem_bandwidth(card) * 1e3
    return {
        "kernel": key, "coll": coll, "p": p, "bytes_per_rank": nb,
        "paths": times,
        "library": "torch.cumsum(x, 0)" if coll == "SCAN" else "x.sum(0)",
        "library_ms": device_ms(torch, library, iters),
        "library_event_ms": time_ms(torch, library, iters),
        "bound_ms": bound_ms, "bound_by": "bytes",
        # from the faster turn whose trace held the kernels (a turn whose
        # three traces all missed activities reads null)
        "bound_share": {k: (bound_ms / min(m for m in v["ms"] if m)
                            if any(v["ms"]) else None)
                        for k, v in times.items()},
        # in + out fit the L2: back-to-back calls read and write it, and
        # the HBM bound is no floor (the library call may run under it)
        "l2_resident": nbytes <= L2_BYTES,
    }


def phase_times_spmd(torch, device, card, launches):
    """K2 on its cluster path beside its flags path (the PR 13 kernel), in
    turns, at SCAN float32 SUM p = 8 and 16, 1 MiB per rank, and a 25 MiB
    ALLREDUCE at p = 8, with K1 and the library call; K2's plain version at
    the headline; then the engine's driver-mode dispatch latency beside sim
    mode's at p = 8 over the osu sizes."""
    from statistics import median

    from repro_torch import OffloadEngine
    from repro_torch.compat import Mesh, shard_map
    from repro_torch.core.operators import SUM
    from repro_torch.kernels import fused_collective as fc
    from repro_torch.kernels import spmd_collective as k2
    from repro_torch.offload import backends
    from repro_torch.offload.planner import PhaseKind, build_plan

    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    pallas = backends.get_backend("pallas")
    head = None
    for coll, p, nb in COMPARE_SHAPES:
        kind = PhaseKind.SCAN if coll == "SCAN" else PhaseKind.TOTAL
        x = torch.randn((p, nb // 4), generator=gen, device=device)
        mesh = Mesh((p,), ("i",), device=device)
        algos = {"level_algorithms": ("hillis_steele",)} if coll == "SCAN" else {}
        plan = build_plan(coll, (p,), "sum", nb, **algos)
        # the main route: the registry's lowering, whose launch plan_launch
        # sends down the cluster path; the flags path named explicitly
        kernel = shard_map(pallas.lower(plan, "sum", axis_names=("i",)), mesh,
                           ("i",), "i")
        flags = shard_map(
            lambda t, kind=kind, p=p: k2.comm_phase_spmd(
                kind, p, "i", SUM, t, path="flags"), mesh, ("i",), "i")
        k1 = lambda kind=kind, p=p, x=x: fc.comm_phase(kind, p, SUM, x)  # noqa: E731
        want = k1()
        err = 0.0
        for label, fn in (("cluster", kernel), ("flags", flags)):
            before = dict(k2.path_launches)
            got = fn(x)
            if k2.path_launches[label] != before[label] + 1:
                raise AssertionError(f"times K2 {coll} p={p}: not one "
                                     f"{label} launch")
            err = max(err, assert_match(torch, got, want, 0.0, 0.0,
                                        f"times K2 {label} {coll} p={p}"))
        big = x.numel() * 4 >= (64 << 20)
        iters = 20 if big else 200
        library = (lambda x=x: torch.cumsum(x, 0)) if coll == "SCAN" \
            else (lambda x=x: x.sum(0))
        times = paths_in_turns(torch, {
            "cluster": (lambda: kernel(x), PATH_KERNELS["cluster"]),
            "flags": (lambda: flags(x), PATH_KERNELS["flags"]),
        }, iters)
        row = compare_row(torch, "k2", coll, p, nb, x, times, library, card,
                          iters)
        row["k1_ms"] = device_ms(torch, k1, iters, name=PATH_KERNELS["register"])
        row["k1_event_ms"] = time_ms(torch, k1, iters)
        row["max_abs_err"] = err
        if head is None:  # the headline: K2's plain version too
            plain = shard_map(spmd_plain(torch, plan, p, SUM), mesh, ("i",), "i")
            assert_match(torch, plain(x), want, 0.0, 0.0, "times K2 plain")
            row["plain_ms"] = device_ms(torch, lambda: plain(x), 20)
            row["plain_event_ms"] = time_ms(torch, lambda: plain(x), 20)
            head = row
        emit({"phase": "times_spmd", **row})
        del x, kernel, flags
    torch.cuda.empty_cache()

    cluster = head["paths"]["cluster"]
    # one source for every field, as in phase_times: events when a trace
    # held no device time
    timing = "profiler" if cluster["ms"][0] is not None and \
        head["plain_ms"] is not None and head["library_ms"] is not None \
        else "events"
    pick = (lambda dev, ev: dev) if timing == "profiler" else (lambda dev, ev: ev)
    p, nb = 8, 1 << 20
    mesh = Mesh((p,), ("i",), device=device)
    eng = OffloadEngine()
    rows = []
    for size in MAIN_SIZES:
        desc = eng.make_descriptor("SCAN", p=p, payload_bytes=size)
        xs = torch.randn((p, size // 4), generator=gen, device=device)
        lat = {}
        for mode, kw in (("sim", {}), ("driver", {"axis_name": "i", "mesh": mesh}),
                         ("driver2", {"axis_name": "i", "mesh": mesh}),
                         ("sim2", {})):
            # sim, driver, driver, sim: two turns each within this run
            got = []
            for _ in range(23):
                eng.offload(desc, xs, **kw)
                got.append(eng.telemetry.last_latency_s * 1e6)
            lat[mode] = median(got[3:])
        rows.append({"bytes_per_rank": size, "algorithm": desc.algo_type,
                     "sim_us": [lat["sim"], lat["sim2"]],
                     "driver_us": [lat["driver"], lat["driver2"]]})
    emit({"phase": "times_dispatch", "p": p, "coll": "SCAN", "op": "sum",
          "dtype": "float32",
          "timing": "host clock around offload bracketed by synchronize; "
                    "median of 20 after 3, two turns each",
          "rows": rows})
    return {
        **kernel_ident("k2"),
        "launches": launches,
        "max_abs_err": head["max_abs_err"],
        "ms": pick(cluster["ms"][0], cluster["event_ms"][0]),
        "plain_ms": pick(head["plain_ms"], head["plain_event_ms"]),
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": pick(head["library_ms"], head["library_event_ms"]),
        "timing": timing,
        "event_ms": cluster["event_ms"][0],
        "path": "cluster",
        "k1_ms": pick(head["k1_ms"], head["k1_event_ms"]),
    }


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
    None. CUPTI now and then returns a trace that misses activities: one
    that holds no device time, or a count of them that is no multiple of
    the ``iters`` identical calls, is taken again, up to three times in
    all; None when none will do."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, seen = 0.0, 0
        for evt in prof.key_averages():
            t = getattr(evt, "device_time_total", None)
            if t is None:
                t = getattr(evt, "cuda_time_total", 0.0)
            if t > 0 and (name is None or name in evt.key):
                total_us += t
                seen += evt.count
        if total_us > 0 and seen % iters == 0:
            return total_us / iters / 1e3
    return None


def kernel_ident(key):
    name, src, replaces, _ = KERNELS[key]
    return {"name": name, "route": "cuda", "source": f"{CSRC}/{src}.cu",
            "replaces": replaces}


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
            "ms": device_ms(torch, kernel, iters, name=PATH_KERNELS["register"]),
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
        nbytes = kernel_bytes("k1", phase=kind.name, p=p, numel=x.numel(),
                              dtype=x.dtype)  # read once, written once
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
    # the register path beside the column path (the PR 13 kernel), in
    # turns, at the shapes of COMPARE_SHAPES
    for coll, p, nb in COMPARE_SHAPES:
        kind = PhaseKind.SCAN if coll == "SCAN" else PhaseKind.TOTAL
        x = torch.randn((p, nb // 4), generator=gen, device=device)
        want = fc.comm_phase_plain(kind, p, SUM, x)
        calls, err = {}, 0.0
        for path in ("register", "column"):
            fn = lambda kind=kind, p=p, x=x, path=path: fc.comm_phase(  # noqa: E731
                kind, p, SUM, x, path=path)
            err = max(err, assert_match(torch, fn(), want, 0.0, 0.0,
                                        f"times K1 {path} {coll} p={p}"))
            calls[path] = (fn, PATH_KERNELS[path])
        iters = 20 if x.numel() * 4 >= (64 << 20) else 200
        library = (lambda x=x: torch.cumsum(x, 0)) if coll == "SCAN" \
            else (lambda x=x: x.sum(0))
        row = compare_row(torch, "k1", coll, p, nb, x,
                          paths_in_turns(torch, calls, iters), library, card,
                          iters)
        row["max_abs_err"] = err
        emit({"phase": "times_paths", **row})
        del x, want
    torch.cuda.empty_cache()
    # the headline shape: SCAN, SUM float32, p=8, 1 MiB per rank (osu_scan's
    # largest default message)
    head = next(r for r in rows
                if (r["coll"], r["p"], r["bytes_per_rank"]) == ("SCAN", 8, 1 << 20))
    return {
        **kernel_ident("k1"),
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "timing": head["timing"],
        "event_ms": head["event_ms"],
        "path": "register",
    }


def phase_times_onchip(torch, card, launches, cases):
    """K3-K5 rows at the entry shapes; returns their kernels-line entries,
    each from its kernel's headline row."""
    rows = []
    for case in cases:
        big = case.nbytes >= (64 << 20) or case.flops >= 1e10
        iters = 10 if big else 100
        name = KERNELS[case.key][3]
        bound_ms, bound_by = case.bound(card)
        dev = {
            "ms": device_ms(torch, case.call, iters, name=name),
            "plain_ms": device_ms(torch, case.plain, max(3, iters // 5)),
            "library_ms": (device_ms(torch, case.library, iters)
                           if case.library else None),
        }
        event = {"ms": time_ms(torch, case.call, iters)}
        # one source for every field: events when a trace would not do
        complete = dev["ms"] is not None and dev["plain_ms"] is not None and (
            case.library is None or dev["library_ms"] is not None)
        timing = "profiler" if complete else "events"
        if timing == "events":
            dev = {"ms": event["ms"],
                   "plain_ms": time_ms(torch, case.plain, max(3, iters // 5)),
                   "library_ms": (time_ms(torch, case.library, iters)
                                  if case.library else None)}
        got = case.call()
        want = case.plain()
        torch.cuda.synchronize()
        err = assert_match(torch, got, want, *case.tol, f"times {case.label}")
        del got, want
        row = {"kernel": case.key, "call": case.label, "head": case.head,
               **dev, "timing": timing,
               "event_ms": event["ms"], "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / dev["ms"],
               "max_abs_err": err, "launches_in_entry": launches[case.key],
               "launches_per_call": case.launches}
        if case.path is not None:
            row["path"] = case.path
        if case.flops:
            row["tflops"] = case.flops / dev["ms"] / 1e9
        rows.append(row)
        emit({"phase": "times", **row})
    torch.cuda.empty_cache()
    head = {row["kernel"]: row for row in rows if row["head"]}
    return [
        {**kernel_ident(key), "launches": launches[key],
         **{f: head[key][f] for f in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "timing", "event_ms")},
         "shape": head[key]["call"]}
        for key in ("k3", "k4", "k5")
    ]


def phase_times_k4(torch, device, card):
    """K4's chunked path beside its column path (the first port's kernel) at
    Mamba2-130m's (8, 4096, 1536) in float32 and bf16, timed in turns a, b,
    b, a (device time of every activity of the call, the chunked path's
    memset included); the chunked kernel alone; the chunked path with h0;
    the bytes bound; and the same-bytes time of ``torch.add(a, b, out=h)``,
    which reads two arrays of that shape and writes one (the rate the card
    streams at, not the same function)."""
    from repro_torch.kernels import ops, ref

    k4 = kernel_modules()["k4"]
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    shape = (8, 4096, 1536)
    iters = 20
    for dtype in (torch.float32, torch.bfloat16):
        a = (0.9 + 0.1 * torch.rand(shape, generator=gen, device=device)).to(dtype)
        b = torch.randn(shape, generator=gen, device=device).to(dtype)
        h0 = torch.randn(shape[:1] + shape[2:], generator=gen, device=device).to(dtype)
        out = torch.empty_like(b)
        calls = {
            "chunked": (lambda: ops.ssd_scan(a, b)[0], None),
            "column": (lambda: k4.ssd_rows(a, b, path="column"), None),
        }
        want = ref.ref_ssd_scan(a, b)[0]
        err = {}
        for path, (fn, _) in calls.items():
            before = k4.path_launches[path]
            got = fn()
            if k4.path_launches[path] != before + 1:
                raise AssertionError(f"times K4 {path}: not one {path} launch")
            err[path] = assert_match(torch, got, want, *SSD_TOL[dtype_name(dtype)],
                                     f"times K4 {path} {dtype}")
            del got
        del want
        torch.cuda.synchronize()
        times = paths_in_turns(torch, calls, iters)
        nbytes = kernel_bytes("k4", rows=shape[0], time=shape[1],
                              width=shape[2], dtype=dtype)
        bound_ms = nbytes / mem_bandwidth(card) * 1e3
        same = lambda: torch.add(a, b, out=out)  # noqa: E731
        row = {
            "kernel": "k4", "shape": list(shape), "dtype": dtype_name(dtype),
            "paths": times,
            "chunked_kernel_ms": device_ms(torch, calls["chunked"][0], iters,
                                           name=K4_KERNELS["chunked"]),
            "chunked_h0_ms": device_ms(torch, lambda: ops.ssd_scan(a, b, h0),
                                       iters),
            "same_bytes": "torch.add(a, b, out=h)",
            "same_bytes_ms": device_ms(torch, same, iters),
            "same_bytes_event_ms": time_ms(torch, same, iters),
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": {k: (bound_ms / min(m for m in v["ms"] if m)
                                if any(v["ms"]) else None)
                            for k, v in times.items()},
            "max_abs_err": err,
            "blocks": {path: k4.plan_launch(*shape, dtype, path=path).blocks
                       for path in calls},
        }
        emit({"phase": "times_k4", **row})
        del a, b, h0, out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The serving path: the model substrate and ServeEngine, K3 under every
# Mamba prefill
# ---------------------------------------------------------------------------

#: the families run reduced on the card beside their CPU run, one arch each
SERVE_REDUCED = ("olmoe-1b-7b", "jamba-v0.1-52b", "qwen2-vl-7b",
                 "whisper-large-v3")
SERVE_REQUESTS = 8      # requests of the full-width serving runs
SERVE_NEW_TOKENS = 16   # new tokens a request
SERVE_FORWARD = (8, 4096)   # (B, S) of the full-width Mamba2-130m forward


def serve_prompts(vocab, n, high=24):
    """Prompts as ``launch/serve.py`` draws them: ``default_rng(0)``, a
    length of 4 to ``high - 1`` tokens, then the tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, high))
        out.append(rng.integers(2, vocab, size=plen).astype(np.int32))
    return out


def model_batch(torch, cfg, B, S, device, seed=0):
    """Seeded model inputs (tokens, and the stub frontends of audio / vlm),
    made on the host so a CPU run and a card run see the same values."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
        b["positions3"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want|, in float64 on the host."""
    g, w = got.double().cpu(), want.double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shapes {tuple(g.shape)} vs {tuple(w.shape)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite output")
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def hold(torch, got, want, rel, what) -> float:
    err = rel_err(torch, got, want)
    if err > rel:
        raise AssertionError(f"{what}: max error {err:.3g} of the largest "
                             f"magnitude, limit {rel}")
    return err


def profiled(torch, fn, names):
    """One run of ``fn`` under ``torch.profiler`` (device activity only):
    its host wall time in ms, the device time in ms of the kernels whose
    name contains each of ``names`` and of every device activity (``"*"``),
    and the kernels counted under each name. The device times are None when
    the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals = dict.fromkeys(("*",) + tuple(names), 0.0)
    counts = dict.fromkeys(names, 0)
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us <= 0:
            continue
        totals["*"] += us
        for name in names:
            if name in evt.key:
                totals[name] += us
                counts[name] += evt.count
    if totals["*"] <= 0:
        return wall_ms, None, counts
    return wall_ms, {k: v / 1e3 for k, v in totals.items()}, counts


class TimedServe:
    """A ``ServeEngine`` whose prefills and decode steps are timed (host
    clock bracketed by synchronize for a prefill, CUDA events for a decode
    step) and whose K3 launches are read around each call."""

    def __init__(self, torch, engine, k3):
        self.torch, self.engine, self.k3 = torch, engine, k3
        self.prefill_ms, self.decode_ms = [], []
        self.prefill_k3, self.decode_k3 = [], []
        api = engine.api
        prefill, decode = api.prefill, api.decode_step

        def timed_prefill(m, batch):
            torch.cuda.synchronize()
            before, t0 = k3.launches, time.perf_counter()
            out = prefill(m, batch)
            torch.cuda.synchronize()
            self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
            self.prefill_k3.append(k3.launches - before)
            return out

        def timed_decode(m, tok, cache, clen):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = k3.launches
            start.record()
            out = decode(m, tok, cache, clen)
            end.record()
            end.synchronize()
            self.decode_ms.append(start.elapsed_time(end))
            self.decode_k3.append(k3.launches - before)
            return out

        engine.api = dataclasses.replace(api, prefill=timed_prefill,
                                         decode_step=timed_decode)


def serve_full_width(torch, device, arch, smi, mods):
    """One full-width family in bf16 through ServeEngine(batch_size=4,
    max_len=256): 8 requests of 16 new tokens, until drained. Returns its
    JSON line."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.sharding import Topology

    cfg = get_config(arch)
    api = build_model(cfg)
    t0 = time.perf_counter()
    model = api.init(torch.Generator().manual_seed(7), device=device)
    init_s = time.perf_counter() - t0
    mamba_layers = cfg.num_layers if cfg.family == "ssm" else 0

    def engine():
        return ServeEngine(api, model, Topology(mesh=None), batch_size=4,
                           max_len=256, device=device)

    # warm-up: cuBLAS handles, allocator pools, K3's library
    warm = engine()
    warm.submit(Request(rid=0, prompt=serve_prompts(cfg.vocab_size, 1)[0],
                        max_new_tokens=3))
    warm.run_until_drained()
    del warm

    eng = engine()
    timed = TimedServe(torch, eng, mods["k3"])
    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS)
            for i, p in enumerate(serve_prompts(cfg.vocab_size, SERVE_REQUESTS))]
    for r in reqs:
        eng.submit(r)
    for key in mods:
        mods[key].launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {key: mods[key].launches for key in mods}
    tokens = sum(len(r.generated) for r in reqs)
    for r in reqs:
        if not r.done or not (len(r.generated) == SERVE_NEW_TOKENS
                              or r.generated[-1] == eng.eos_id):
            raise AssertionError(f"{arch} request {r.rid}: {len(r.generated)} "
                                 f"tokens, done={r.done}")
        if not all(0 <= t < cfg.padded_vocab for t in r.generated):
            raise AssertionError(f"{arch} request {r.rid}: token out of range")
    if len(timed.prefill_ms) != len(reqs):
        raise AssertionError(f"{arch}: {len(timed.prefill_ms)} prefills for "
                             f"{len(reqs)} requests")
    if any(n != mamba_layers for n in timed.prefill_k3):
        raise AssertionError(f"{arch}: K3 launches per prefill "
                             f"{timed.prefill_k3}, {mamba_layers} expected")
    if any(timed.decode_k3):
        raise AssertionError(f"{arch}: a decode step launched K3 "
                             f"({timed.decode_k3})")
    if launches["k3"] != mamba_layers * len(reqs):
        raise AssertionError(f"{arch}: K3 launched {launches['k3']} times in "
                             f"the run, {mamba_layers} x {len(reqs)} expected")

    line = {
        "phase": "serve_model", "arch": arch, "dtype": cfg.dtype,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "batch_size": 4, "max_len": 256, "requests": len(reqs),
        "prompt_tokens": [len(r.prompt) for r in reqs],
        "tokens": tokens, "decode_steps": len(timed.decode_ms),
        "wall_s": wall_s, "tokens_per_s": tokens / wall_s,
        "prefill_ms_per_request": statistics.mean(timed.prefill_ms),
        "prefill_ms": timed.prefill_ms,
        "decode_step_ms_median": statistics.median(timed.decode_ms),
        "decode_step_ms_min": min(timed.decode_ms),
        "k3_launches_per_prefill": timed.prefill_k3[0],
        "k3_launches_per_decode_step": max(timed.decode_k3),
        "launches": launches,
        "init_s": init_s, "card": smi,
    }
    del eng, model
    torch.cuda.empty_cache()
    emit(line)
    return line


def times_serve_model(torch, device, arch, smi, mesh=None):
    """The profiler readings of one full-width family in bf16: one prefill
    (K3's device time in it, one launch a Mamba layer) and 8 decode steps
    of a full ``ServeEngine(4, 256)`` (a decode step's device-busy time
    and its host share, 1 - device / wall); under a co-resident mesh of
    shape ``mesh`` when one is given."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.sharding import Topology, make_topology, use_topology

    cfg = get_config(arch)
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(7), device=device)
    prompts = serve_prompts(cfg.vocab_size, 4)
    topo = (Topology(mesh=None) if mesh is None
            else make_topology(_mesh(device, mesh)))
    eng = ServeEngine(api, model, topo, batch_size=4,
                      max_len=256, device=device)
    for p in prompts:
        eng.submit(Request(rid=0, prompt=p, max_new_tokens=64))
    eng._admit()
    eng.step()                                   # warm-up
    prompt = torch.as_tensor(prompts[0], device=device)[None]
    with torch.inference_mode(), use_topology(topo):
        api.prefill(model, {"tokens": prompt})   # warm-up
        _, pf, pf_counts = profiled(
            torch, lambda: api.prefill(model, {"tokens": prompt}),
            ("k3_scan_kernel",))

    def decode_steps():
        for _ in range(8):
            eng.step()

    dec_wall, dec, _ = profiled(torch, decode_steps, ())
    line = {
        "phase": "times_serve_model", "arch": arch, "dtype": cfg.dtype,
        "mesh": mesh, "prompt_tokens": len(prompts[0]),
        "prefill_device_ms": None if pf is None else pf["*"],
        "decode_profiled_ms_per_step": dec_wall / 8,
        "decode_device_ms_per_step": None if dec is None else dec["*"] / 8,
        "decode_host_share": None if dec is None else 1.0 - dec["*"] / dec_wall,
        "card": smi,
    }
    if cfg.family == "ssm":
        line["k3_device_ms_per_prefill"] = None if pf is None else pf["k3_scan_kernel"]
        line["k3_launches_profiled"] = pf_counts["k3_scan_kernel"]
    del eng, model
    torch.cuda.empty_cache()
    emit(line)
    return line


def serve_parity(torch, device, smi, mods):
    """Mamba2-130m at full width in float32: lm_prefill at (2, 256) on the
    card (K3, 24 launches) against the same module on the CPU (the plain
    scan): the prefill's logits and its final SSD states and conv tails to
    1e-3 of the largest magnitude.

    Also reported, not held: every position's logits of ``lm_forward``,
    with K3 and with the segment scan summed in float64 on the card. 24
    layers of random weights amplify float32 rounding: the two differ from
    the CPU's by about the same amount, so the scan is not what sets it."""
    import copy
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import mamba as M
    from repro_torch.models import transformer as T

    cfg = dc.replace(get_config("mamba2-130m"), dtype="float32")
    api = build_model(cfg)
    cpu_model = api.init(torch.Generator().manual_seed(20), device="cpu")
    card_model = copy.deepcopy(cpu_model).to(device)
    batch = model_batch(torch, cfg, 2, 256, "cpu", seed=20)
    card_batch = {k: v.to(device) for k, v in batch.items()}
    k3 = mods["k3"]

    def f64_scan(dAc):
        seg = torch.cumsum(torch.movedim(dAc, 2, 3).double(), -1).float()
        return torch.movedim(seg, 3, 2)

    with torch.inference_mode():
        torch.cuda.synchronize()
        before = k3.launches
        last, cache = api.prefill(card_model, card_batch)
        torch.cuda.synchronize()
        launched = k3.launches - before
        if launched != cfg.num_layers:
            raise AssertionError(f"full-width prefill launched K3 {launched} "
                                 f"times, {cfg.num_layers} layers")
        logits, _ = T.lm_forward(card_model, card_batch["tokens"], cfg)
        segment_scan, M._segment_scan = M._segment_scan, f64_scan
        try:
            logits_f64, _ = T.lm_forward(card_model, card_batch["tokens"], cfg)
        finally:
            M._segment_scan = segment_scan
        cpu_last, cpu_cache = api.prefill(cpu_model, batch)
        cpu_logits, _ = T.lm_forward(cpu_model, batch["tokens"], cfg)
    err = {
        "last_logits": hold(torch, last, cpu_last, 1e-3, "prefill last logits"),
        "ssm_state": hold(torch, cache["mamba"]["ssm"], cpu_cache["mamba"]["ssm"],
                          1e-3, "final SSD states"),
        "conv_x": hold(torch, cache["mamba"]["conv_x"],
                       cpu_cache["mamba"]["conv_x"], 1e-3, "conv tails"),
        "conv_bc": hold(torch, cache["mamba"]["conv_bc"],
                        cpu_cache["mamba"]["conv_bc"], 1e-3, "conv tails"),
    }
    reported = {
        "forward_logits": rel_err(torch, logits, cpu_logits),
        "forward_logits_f64_scan": rel_err(torch, logits_f64, cpu_logits),
    }
    line = {"phase": "serve_parity", "arch": cfg.name, "dtype": "float32",
            "shape": [2, 256], "k3_launches": launched, "rel_err": err,
            "tolerance": 1e-3, "reported_rel_err": reported, "card": smi,
            "ok": True}
    emit(line)
    del card_model, cpu_model
    torch.cuda.empty_cache()
    return line


def serve_reduced(torch, device, smi, mods):
    """Every other family, reduced, float32: one lm_forward and a
    prefill-then-decode on the card against the same module on the CPU,
    to 1e-4 of the largest logit (decode: the same next tokens and caches)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core.trees import tree_leaves, tree_map
    from repro_torch.models import build_model

    rows = []
    for arch in SERVE_REDUCED:
        cfg = get_config(arch).reduced()
        api = build_model(cfg)
        cpu_model = api.init(torch.Generator().manual_seed(21), device="cpu")
        card_model = copy.deepcopy(cpu_model).to(device)
        B, S = 2, 32
        batch = model_batch(torch, cfg, B, S, "cpu", seed=21)
        card_batch = {k: v.to(device) for k, v in batch.items()}
        mamba_layers = (cfg.num_layers - cfg.num_layers // (cfg.attn_every or 8)
                        if cfg.family == "hybrid" else 0)
        err = {}
        with torch.inference_mode():
            out = api.forward(card_model, card_batch)
            want = api.forward(cpu_model, batch)
            out = out[0] if isinstance(out, tuple) else out
            want = want[0] if isinstance(want, tuple) else want
            err["logits"] = hold(torch, out, want, 1e-4, f"{arch} forward")
            before = mods["k3"].launches
            last, cache = api.prefill(card_model, card_batch)
            torch.cuda.synchronize()
            if mods["k3"].launches - before != mamba_layers:
                raise AssertionError(f"{arch} prefill: K3 launched "
                                     f"{mods['k3'].launches - before} times, "
                                     f"{mamba_layers} Mamba layers")
            cpu_last, cpu_cache = api.prefill(cpu_model, batch)
            err["prefill_logits"] = hold(torch, last, cpu_last, 1e-4, f"{arch} prefill")

            def placed(cache, dev):
                full = api.init_cache(B, S + 8, device=dev)
                def place(dst, src):
                    pads = []
                    for d, s in reversed(list(zip(dst.shape, src.shape))):
                        pads += [0, d - s]
                    return torch.nn.functional.pad(src.to(dst.dtype), pads)
                return tree_map(place, full, cache)

            tok = torch.argmax(cpu_last[:, -1:], -1).to(torch.int32)
            nxt, new = api.decode_step(card_model, tok.to(device),
                                       placed(cache, device), S)
            cpu_nxt, cpu_new = api.decode_step(cpu_model, tok,
                                               placed(cpu_cache, "cpu"), S)
            if not torch.equal(nxt.cpu(), cpu_nxt):
                raise AssertionError(f"{arch} decode: next tokens "
                                     f"{nxt.flatten().tolist()} vs "
                                     f"{cpu_nxt.flatten().tolist()}")
            worst = 0.0
            for g, w in zip(tree_leaves(new), tree_leaves(cpu_new)):
                worst = max(worst, hold(torch, g, w, 1e-4, f"{arch} decode cache"))
            err["decode_cache"] = worst
        rows.append({"arch": arch, "family": cfg.family, "rel_err": err,
                     "k3_launches_per_prefill": mamba_layers})
        del card_model, cpu_model
    emit({"phase": "serve_reduced", "runs": rows, "tolerance": 1e-4,
          "card": smi, "ok": True})
    return rows


def serve_tenancy(torch, device, smi, mods):
    """Reduced Mamba2-130m served with a collective_client on the card's
    DescriptorBroker: each step's slot statistics are an ALLREDUCE the
    broker dispatches through K1; collect_service_stats() must equal the
    totals counted on the host, and K1's launches must rise."""
    from repro_torch import OffloadEngine
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.service import DescriptorBroker
    from repro_torch.sharding import Topology

    cfg = get_config("mamba2-130m").reduced()
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(22), device=device)
    k1 = mods["k1"]
    with DescriptorBroker(OffloadEngine()) as broker:
        client = broker.client("serve")
        eng = ServeEngine(api, model, Topology(mesh=None), batch_size=4,
                          max_len=64, collective_client=client, device=device)
        # prompts no longer than the reduced chunk of 16
        for i, p in enumerate(serve_prompts(cfg.vocab_size, SERVE_REQUESTS, high=17)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4 + i % 5))
        host = {"service_steps": 0, "slot_steps": 0, "tokens_emitted": 0,
                "requests_finished": 0}
        before = k1.launches
        while eng.queue or any(s is not None for s in eng.slots):
            eng._admit()
            active = [s for s in range(eng.B) if eng.slots[s] is not None]
            eng.step()
            host["service_steps"] += 1
            host["slot_steps"] += len(active)
            host["tokens_emitted"] += len(active)
            host["requests_finished"] += sum(eng.slots[s] is None for s in active)
        got = eng.collect_service_stats()
        torch.cuda.synchronize()
        launched = k1.launches - before
        snap = broker.engine.telemetry.snapshot()
    if got != host:
        raise AssertionError(f"tenancy totals {got}, counted on the host {host}")
    if launched < 1:
        raise AssertionError("the tenancy run launched no K1")
    if snap["backend_fallbacks"]:
        raise AssertionError(f"fallbacks: {snap['backend_fallback_reasons']}")
    line = {"phase": "serve_tenancy", "arch": cfg.name, "totals": got,
            "k1_launches": launched, "dispatches": snap["dispatches"],
            "card": smi, "ok": True}
    emit(line)
    return line


def times_serve_forward(torch, device, smi, mods):
    """One Mamba2-130m lm_forward at (8, 4096) in bf16 under the profiler:
    K3's device time at its (8, 16, 24, 256) segment-scan shape inside the
    model, beside the same scan alone on a tensor of that shape (the entry
    phase's input) and its bytes bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg = get_config("mamba2-130m")
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(23), device=device)
    B, S = SERVE_FORWARD
    tokens = model_batch(torch, cfg, B, S, device, seed=23)["tokens"]
    k3 = mods["k3"]

    def forward():
        with torch.inference_mode():
            return api.forward(model, {"tokens": tokens})[0]

    logits = forward()                       # warm-up, and the output check
    torch.cuda.synchronize()
    if logits.shape != (B, S, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"forward: {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    before = k3.launches
    wall_ms, dev, counts = profiled(torch, forward, ("k3_scan_kernel",))
    if k3.launches - before != cfg.num_layers or counts["k3_scan_kernel"] not in (
            0, cfg.num_layers):
        raise AssertionError(f"forward: K3 launched {k3.launches - before} "
                             f"times, {counts['k3_scan_kernel']} profiled")
    # the entry phase's input for this shape: the same scan alone, 20 calls
    # in one profile
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    seg = -0.1 * torch.rand((8, 16, 24, 256), generator=gen, device=device)

    def scans():
        for _ in range(20):
            ops.prefix_scan(seg)

    scans()
    _, alone_dev, alone_counts = profiled(torch, scans, ("k3_scan_kernel",))
    alone = (None if alone_dev is None or not alone_counts["k3_scan_kernel"]
             else alone_dev["k3_scan_kernel"] / alone_counts["k3_scan_kernel"])
    line = {
        "phase": "times_serve_forward", "arch": cfg.name, "dtype": cfg.dtype,
        "shape": [B, S], "wall_ms": wall_ms,
        "device_ms": None if dev is None else dev["*"],
        "host_share": None if dev is None else 1.0 - dev["*"] / wall_ms,
        "k3_launches": cfg.num_layers,
        "k3_ms_per_launch_in_model": (None if dev is None
                                      else dev["k3_scan_kernel"] / cfg.num_layers),
        "k3_ms_alone": alone, "k3_shape": [8, 16, 24, 256],
        # read once, written once, at the card's memory rate
        "k3_bound_ms": scan_bytes(seg)
        / mem_bandwidth(torch.cuda.get_device_name(0)) * 1e3,
        "card": smi,
    }
    del model
    torch.cuda.empty_cache()
    emit(line)
    return line


def phase_serve(torch, device, smi):
    """The model substrate and the serving path on the card (see the
    module docstring, phase 4); its profiler readings come later, in
    :func:`phase_times_serve`."""
    mods = kernel_modules()
    t0 = time.perf_counter()
    parity = serve_parity(torch, device, smi, mods)
    full = [serve_full_width(torch, device, arch, smi, mods)
            for arch in ("mamba2-130m", "smollm-360m")]
    serve_reduced(torch, device, smi, mods)
    tenancy = serve_tenancy(torch, device, smi, mods)
    keys = ("tokens_per_s", "prefill_ms_per_request", "decode_step_ms_median",
            "k3_launches_per_prefill", "k3_launches_per_decode_step")
    emit({"phase": "serve", "seconds": time.perf_counter() - t0,
          "parity_rel_err": parity["rel_err"],
          "models": {row["arch"]: {k: row.get(k) for k in keys} for row in full},
          "tenancy": tenancy["totals"], "k1_launches": tenancy["k1_launches"],
          "card": smi, "ok": True})
    return {"parity": parity, "full": full, "tenancy": tenancy}


def phase_times_serve(torch, device, smi):
    """The serving path's profiler readings, taken right before the
    ``profile`` phase (the order in which ``profile_offload`` once lost its
    device events, which ``profile`` now holds):
    K3's device time a Mamba2-130m prefill, a decode step's host share for
    both full-width models, and the (8, 4096) forward."""
    mods = kernel_modules()
    rows = [times_serve_model(torch, device, arch, smi)
            for arch in ("mamba2-130m", "smollm-360m")]
    forward = times_serve_forward(torch, device, smi, mods)
    return rows, forward


# ---------------------------------------------------------------------------
# The model code's mesh paths: the sequence-parallel Mamba mixer, the
# expert-parallel MoE region, sequence-sharded decode, K3 in every shard
# ---------------------------------------------------------------------------

MESH_MIXER = (2, 4096)        # (B, S) of the full-width SP mixer, float32
MESH_MOE = (4, 512)           # (B, S) of the full-width OLMoE block, float32
MESH_MOE_MESHES = ((1, 8), (2, 4))
#: the bound on the (8, 4096) bf16 forward's logits, meshed against
#: unmeshed, relative to the largest logit (stated in PERF.md before the
#: first run): its max and its median gap
MESH_FORWARD_BOUND = {"max": 0.25, "median": 1e-2}
#: an unmeshed token whose top-2 logit margin is above this must be served
#: alike under the mesh: the bf16 logits of SmolLM-360M's random weights
#: (largest about 3) step by 1/64-1/32, and a CPU rehearsal at 2 of its 32
#: layers found the two runs 1/32 apart where their tokens agreed
SERVE_SAFE_MARGIN = 0.25


def _mesh(device, shape):
    from repro_torch.compat import Mesh

    return Mesh(shape, ("data", "model"), device=device)


def _under(mesh, fn):
    from repro_torch.sharding import make_topology, use_topology

    with use_topology(make_topology(mesh)):
        return fn()


def _zeroed(mods):
    for key in mods:
        mods[key].launches = 0


def mesh_mixer(torch, device, smi, mods):
    """Mamba2-130m's mixer at full width (d_model 768, 24 heads of 64,
    state 128, chunk 256), float32, x (2, 4096, 768): sequence-parallel
    under a co-resident (1, 8) mesh (512 tokens, 2 chunks a shard) against
    the unsharded mixer on the card, at the reference check's tolerances
    (``repro_torch.testing.mamba_sp_check.compare``); K3 launches once for
    all shards."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import mamba as M
    from repro_torch.testing import mamba_sp_check

    cfg = get_config("mamba2-130m")
    p = M.init_mamba(torch.Generator().manual_seed(31), cfg, torch.float32,
                     device)
    B, S = MESH_MIXER
    x = torch.from_numpy((np.random.default_rng(31).normal(
        size=(B, S, cfg.d_model)) * 0.1).astype(np.float32)).to(device)
    mesh = _mesh(device, (1, 8))
    with torch.inference_mode():
        y_ref, cache_ref = M.mamba_mixer(p, x, cfg)
        _under(mesh, lambda: M.mamba_mixer(p, x, cfg, seq_parallel=True))
        torch.cuda.synchronize()
        _zeroed(mods)
        t0 = time.perf_counter()
        y_sp, cache_sp = _under(
            mesh, lambda: M.mamba_mixer(p, x, cfg, seq_parallel=True))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {key: mods[key].launches for key in mods}
    checks = mamba_sp_check.compare(torch, y_ref, cache_ref, y_sp, cache_sp)
    failed = [c for c in checks if not c[1]]
    if failed:
        raise AssertionError(f"full-width SP mixer: {failed}")
    if launches["k3"] != 1:
        raise AssertionError(f"SP mixer: K3 launched {launches['k3']} times, "
                             "1 predicted")
    # the fourth check: the gradient through dist_exscan, held to the
    # unsharded mixer's; K3 once forward and once back to front for all 8
    # shards
    del y_sp, cache_sp
    g_ref = mamba_sp_check.mixer_grads(torch, p, lambda: M.mamba_mixer(
        p, x, cfg))
    _zeroed(mods)
    mods["k3"].reverse_launches = 0
    g_sp = mamba_sp_check.mixer_grads(torch, p, lambda: _under(
        mesh, lambda: M.mamba_mixer(p, x, cfg, seq_parallel=True)))
    torch.cuda.synchronize()
    grad_launches = (mods["k3"].launches - mods["k3"].reverse_launches,
                     mods["k3"].reverse_launches)
    grad_checks = mamba_sp_check.compare_grads(torch, g_sp, g_ref)
    failed = [c for c in grad_checks if not c[1]]
    if failed or grad_launches != (1, 1):
        raise AssertionError(f"full-width SP mixer gradient: {failed}, K3 "
                             f"(forward, reverse) {grad_launches}")
    del g_ref, g_sp
    line = {"phase": "mesh_mixer", "arch": cfg.name, "dtype": "float32",
            "shape": [B, S, cfg.d_model], "mesh": [1, 8],
            "max_abs_err": {name: err for name, _, err in checks},
            "grad": {name: err for name, _, err in grad_checks},
            "tolerance": {"output": mamba_sp_check.TOL,
                          "ssm": mamba_sp_check.TOL,
                          "conv_tail": mamba_sp_check.CONV_TOL,
                          "grad": mamba_sp_check.GRAD_TOL},
            "k3_launches": launches["k3"],
            "grad_k3_launches": list(grad_launches),
            "wall_ms": wall_ms, "card": smi, "ok": True}
    emit(line)
    del p, x, y_ref, cache_ref
    torch.cuda.empty_cache()
    return line


def logits_gap(torch, got, want):
    """|got - want| over max |want| for (B, S, V) logits, on the card in
    float32 one sequence at a time: the largest over every logit, and the
    median over every 16th position's (a 16th of the logits: the median of
    all 1.6e9 would sort them)."""
    scale = max(float(want.abs().max()), 1e-30)
    worst, sample = 0.0, []
    for b in range(want.shape[0]):
        d = (got[b].float() - want[b].float()).abs()
        worst = max(worst, float(d.max()))
        sample.append(d[::16].flatten())
    return {"max": worst / scale,
            "median": float(torch.cat(sample).median()) / scale}


def mesh_forward(torch, device, smi, mods):
    """The Mamba2-130m ``lm_forward`` at (8, 4096) in bf16, full width (24
    layers, weights from a seed), under the co-resident (1, 8) mesh and
    without one: the paper's scan carries every layer's SSD state across 8
    shards. The logits' gap is held to ``MESH_FORWARD_BOUND``; K3 launches
    once a layer for all shards; each forward's ms on the host clock
    (synchronized), in turns."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("mamba2-130m")
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(23), device=device)
    B, S = SERVE_FORWARD
    tokens = model_batch(torch, cfg, B, S, device, seed=23)["tokens"]
    mesh = _mesh(device, (1, 8))

    def plain():
        return api.forward(model, {"tokens": tokens})[0]

    def meshed():
        return _under(mesh, plain)

    times = {"plain": [], "mesh": []}
    with torch.inference_mode():
        want, got = plain(), meshed()            # warm-up, and the outputs
        torch.cuda.synchronize()
        for name in ("plain", "mesh", "mesh", "plain", "plain", "mesh"):
            fn = plain if name == "plain" else meshed
            _zeroed(mods)
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if name == "mesh":
                k3 = mods["k3"].launches
                if k3 != cfg.num_layers:
                    raise AssertionError(f"meshed forward: K3 launched {k3} "
                                         f"times, {cfg.num_layers} layers")
            del out
    if got.shape != (B, S, cfg.padded_vocab) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"meshed forward: {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    gap = logits_gap(torch, got, want)
    for key, bound in MESH_FORWARD_BOUND.items():
        if gap[key] > bound:
            raise AssertionError(f"meshed forward logits: {key} gap "
                                 f"{gap[key]:.3g}, bound {bound}")
    line = {"phase": "mesh_forward", "arch": cfg.name, "dtype": cfg.dtype,
            "shape": [B, S], "mesh": [1, 8], "layers": cfg.num_layers,
            "logits_gap": gap, "bound": MESH_FORWARD_BOUND,
            "k3_launches": cfg.num_layers,
            "ms": {k: statistics.median(v) for k, v in times.items()},
            "ms_runs": times, "card": smi, "ok": True}
    emit(line)
    del model, want, got
    torch.cuda.empty_cache()
    return line


def mesh_moe(torch, device, smi, mods):
    """One OLMoE-1B-7B MoE block at full width (d_model 2048, 64 experts,
    top-8, d_ff 1024), float32, x (4, 512, 2048): the EP region under
    co-resident (1, 8) and (2, 4) meshes against ``_dense_moe`` on the card
    at capacity factor 8.0 (``repro_torch.testing.moe_check``'s tolerances),
    and at 0.25 a finite output with dropped picks; K3 (the per-expert
    offsets, the (8, 64) counts in one launch) once a block."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import moe as MO
    from repro_torch.testing import moe_check

    cfg = dc.replace(get_config("olmoe-1b-7b"), capacity_factor=8.0)
    drop = dc.replace(cfg, capacity_factor=0.25)
    p = MO.init_moe(torch.Generator().manual_seed(32), cfg, torch.float32,
                    device)
    B, S = MESH_MOE
    x = torch.from_numpy(np.random.default_rng(32).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)).to(device)
    rows = []
    with torch.inference_mode():
        want, aux = MO._dense_moe(p, x, cfg, "silu")
        probs = torch.softmax(x.reshape(-1, cfg.d_model).float() @ p.router, -1)
        top = torch.topk(probs, cfg.moe_top_k + 1, dim=-1).values
        margin = float((top[:, -2] - top[:, -1]).min())
        for shape in MESH_MOE_MESHES:
            mesh = _mesh(device, shape)
            torch.cuda.synchronize()
            _zeroed(mods)
            t0 = time.perf_counter()
            y, got_aux = _under(mesh, lambda: MO.moe_block(p, x, cfg))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            k3 = mods["k3"].launches
            err = float((y - want).abs().max())
            lb_err = abs(float(got_aux["load_balance"]) - float(aux["load_balance"]))
            if not bool(torch.allclose(y, want, atol=moe_check.TOL,
                                       rtol=moe_check.TOL)):
                raise AssertionError(f"EP {shape}: max error {err:.3g} "
                                     f"against the dense path")
            if lb_err >= moe_check.LB_TOL:
                raise AssertionError(f"EP {shape}: load_balance off by {lb_err}")
            if k3 != 1:
                raise AssertionError(f"EP {shape}: K3 launched {k3} times, "
                                     "1 predicted")
            del y
            y_drop, _ = _under(mesh, lambda: MO.moe_block(p, x, drop))
            dropped = moe_check.dropped_picks(p, x, drop, mesh)
            if not bool(torch.isfinite(y_drop).all()) or dropped <= 0:
                raise AssertionError(f"EP {shape} at capacity 0.25: finite "
                                     f"{bool(torch.isfinite(y_drop).all())}, "
                                     f"{dropped} picks dropped")
            del y_drop
            rows.append({"mesh": list(shape), "max_abs_err": err,
                         "load_balance_err": lb_err, "k3_launches": k3,
                         "wall_ms": wall_ms, "dropped_picks_at_0.25": dropped})
    line = {"phase": "mesh_moe", "arch": cfg.name, "dtype": "float32",
            "shape": [B, S, cfg.d_model], "experts": cfg.moe_num_experts,
            "top_k": cfg.moe_top_k, "d_ff": cfg.d_ff,
            "min_router_margin": margin,
            "tolerance": {"output": moe_check.TOL,
                          "load_balance": moe_check.LB_TOL},
            "runs": rows, "card": smi, "ok": True}
    emit(line)
    del p, x, want
    torch.cuda.empty_cache()
    return line


class LogitServe:
    """A ``ServeEngine`` whose every greedy token also keeps the logits it
    was read from, by request: the prefill's last logits for the first
    token, and each decode step's last-position logits (read where
    ``_greedy`` reads them). Rows are float32 on the host."""

    def __init__(self, torch, engine):
        from repro_torch.models import transformer as T

        self.rows = {}
        api = engine.api
        prefill, decode = api.prefill, api.decode_step

        def recorded_prefill(m, batch):
            out = prefill(m, batch)
            self._pending = out[0][0, -1].float().cpu()
            return out

        def recorded_decode(m, tok, cache, clen):
            slots = {s: r.rid for s, r in enumerate(engine.slots) if r is not None}
            greedy, seen = T._greedy, []

            def keeping(logits):
                seen.append(logits[:, -1].float().cpu())
                return greedy(logits)

            T._greedy = keeping
            try:
                out = decode(m, tok, cache, clen)
            finally:
                T._greedy = greedy
            for s, rid in slots.items():
                self.rows[rid].append(seen[-1][s])
            return out

        prefill_into = engine._prefill_into

        def recorded_prefill_into(slot, req):
            prefill_into(slot, req)
            self.rows[req.rid] = [self._pending]

        engine._prefill_into = recorded_prefill_into
        engine.api = dataclasses.replace(api, prefill=recorded_prefill,
                                         decode_step=recorded_decode)

    def margins(self, torch, rid):
        return [float(d[0] - d[1]) for d in
                (torch.topk(r, 2).values for r in self.rows[rid])]


def mesh_serve(torch, device, smi, mods):
    """SmolLM-360M at full width in bf16 through ``ServeEngine(4, 256)``
    under a co-resident (1, 4) mesh: decode takes ``kv_mode="seq"`` (its 5
    KV heads do not divide 4; 64 cache positions a shard), the serve
    phase's 8 requests of 16 new tokens. Each request's tokens equal the
    unmeshed engine's wherever their prefixes agree and the unmeshed top-2
    margin exceeds ``SERVE_SAFE_MARGIN`` (a request is compared up to its
    first differing token, whose margin must be below that). Reported: the
    largest logit gap between
    the two runs where a request's tokens so far agree, and both runs'
    tokens/s and decode-step ms."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import decode_kv_mode
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.sharding import Topology, make_topology

    cfg = get_config("smollm-360m")
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(7), device=device)
    mesh = _mesh(device, (1, 4))
    kv_mode = _under(mesh, lambda: decode_kv_mode(cfg))
    if kv_mode != "seq":
        raise AssertionError(f"SmolLM-360M on (1, 4): kv_mode {kv_mode!r}")
    runs = {}
    for name, topo in (("plain", Topology(mesh=None)),
                       ("mesh", make_topology(mesh))):
        warm = ServeEngine(api, model, topo, batch_size=4, max_len=256,
                           device=device)
        warm.submit(Request(rid=0, prompt=serve_prompts(cfg.vocab_size, 1)[0],
                            max_new_tokens=3))
        warm.run_until_drained()
        del warm
        eng = ServeEngine(api, model, topo, batch_size=4, max_len=256,
                          device=device)
        logits = LogitServe(torch, eng)
        timed = TimedServe(torch, eng, mods["k3"])
        reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS)
                for i, p in enumerate(serve_prompts(cfg.vocab_size,
                                                    SERVE_REQUESTS))]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        tokens = sum(len(r.generated) for r in reqs)
        runs[name] = {
            "tokens": [list(r.generated) for r in reqs], "logits": logits,
            "tokens_per_s": tokens / wall_s, "wall_s": wall_s,
            "decode_step_ms_median": statistics.median(timed.decode_ms),
            "decode_steps": len(timed.decode_ms),
        }
        del eng
    compared, gap, scale, min_margin = 0, 0.0, 0.0, float("inf")
    plain, meshed = runs["plain"]["logits"], runs["mesh"]["logits"]
    for rid, (want, got) in enumerate(zip(runs["plain"]["tokens"],
                                          runs["mesh"]["tokens"])):
        margin = plain.margins(torch, rid)
        min_margin = min(min_margin, min(margin))
        # the first token the two runs differ on: its margin must not have
        # been safe; before it every token with a safe margin was compared
        agree = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                     len(want))
        if agree < len(want) and margin[agree] > SERVE_SAFE_MARGIN:
            raise AssertionError(f"request {rid}: meshed tokens {got} against "
                                 f"{want}, margin {margin[agree]:.4g} at "
                                 f"token {agree}")
        compared += sum(m > SERVE_SAFE_MARGIN for m in margin[:agree + 1])
        for a, b in zip(plain.rows[rid][:agree + 1], meshed.rows[rid][:agree + 1]):
            gap = max(gap, float((a - b).abs().max()))
            scale = max(scale, float(a.abs().max()))
    line = {"phase": "mesh_serve", "arch": cfg.name, "dtype": cfg.dtype,
            "mesh": [1, 4], "kv_mode": kv_mode, "batch_size": 4,
            "max_len": 256, "requests": SERVE_REQUESTS,
            "safe_margin": SERVE_SAFE_MARGIN, "tokens_compared": compared,
            "tokens_total": sum(map(len, runs["plain"]["tokens"])),
            "tokens_equal": runs["plain"]["tokens"] == runs["mesh"]["tokens"],
            "min_margin": min_margin,
            "logits_gap_where_tokens_agree": gap, "largest_logit": scale,
            **{f"{k}_{name}": runs[name][k] for name in runs
               for k in ("tokens_per_s", "decode_step_ms_median", "decode_steps")},
            "card": smi, "ok": True}
    emit(line)
    del model
    torch.cuda.empty_cache()
    return line


def phase_mesh(torch, device, smi):
    """The model code's mesh paths on the card (see the module docstring,
    phase 5); their device times come later, in
    :func:`phase_times_mesh`."""
    mods = kernel_modules()
    t0 = time.perf_counter()
    # the reference's two checks, reduced, on the card (ALL-OK each)
    check_module("mamba_sp_check", [], device)
    check_module("moe_check", [], device)
    mixer = mesh_mixer(torch, device, smi, mods)
    forward = mesh_forward(torch, device, smi, mods)
    moe = mesh_moe(torch, device, smi, mods)
    serve = mesh_serve(torch, device, smi, mods)
    # one meshed run of each: the mixer, the 24-layer forward, the block
    # at each mesh
    k3 = (mixer["k3_launches"] + forward["k3_launches"]
          + sum(r["k3_launches"] for r in moe["runs"]))
    emit({"phase": "mesh", "seconds": time.perf_counter() - t0,
          "mixer_max_abs_err": mixer["max_abs_err"],
          "forward_logits_gap": forward["logits_gap"],
          "forward_ms": forward["ms"],
          "moe_max_abs_err": {str(r["mesh"]): r["max_abs_err"]
                              for r in moe["runs"]},
          "serve_tokens_compared": serve["tokens_compared"],
          "k3_launches": k3, "card": smi, "ok": True})
    return {"k3_launches": k3}


def kernel_times(torch, fn):
    """One run of ``fn`` under ``torch.profiler`` (device activity only):
    its host wall ms and each kernel's (device ms, launches) by name; the
    table is empty when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us > 0:
            table[evt.key] = (us / 1e3, evt.count)
    return wall_ms, table


def phase_times_mesh(torch, device, smi):
    """The mesh paths' profiler readings: the Mamba2-130m (8, 4096) bf16
    forward under the (1, 8) mesh beside the unmeshed one (device ms, host
    share, K3's device ms, and the kernels whose device time the mesh adds
    most), and SmolLM-360M's meshed decode step (device ms, host share)
    through :func:`times_serve_model`."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("mamba2-130m")
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(23), device=device)
    B, S = SERVE_FORWARD
    tokens = model_batch(torch, cfg, B, S, device, seed=23)["tokens"]
    mesh = _mesh(device, (1, 8))
    line = {"phase": "times_mesh", "arch": cfg.name, "dtype": cfg.dtype,
            "shape": [B, S], "mesh": [1, 8], "card": smi}
    tables = {}
    for name in ("plain", "mesh"):
        def forward():
            with torch.inference_mode():
                if name == "plain":
                    return api.forward(model, {"tokens": tokens})[0]
                return _under(mesh, lambda: api.forward(
                    model, {"tokens": tokens})[0])

        forward()
        wall_ms, table = kernel_times(torch, forward)
        tables[name] = table
        dev = sum(ms for ms, _ in table.values()) if table else None
        k3 = [v for k, v in table.items() if "k3_scan_kernel" in k]
        line[name] = {
            "wall_ms": wall_ms, "device_ms": dev,
            "host_share": None if dev is None else 1.0 - dev / wall_ms,
            "k3_device_ms": sum(ms for ms, _ in k3) if k3 else None,
            "k3_launches_profiled": sum(n for _, n in k3)}
    added = sorted(
        ((tables["mesh"].get(k, (0.0, 0))[0] - tables["plain"].get(k, (0.0, 0))[0],
          k) for k in set(tables["mesh"]) | set(tables["plain"])),
        reverse=True)[:8]
    line["mesh_adds_most"] = [
        {"kernel": k[:96], "ms": ms,
         "launches": [tables[n].get(k, (0.0, 0))[1] for n in ("plain", "mesh")]}
        for ms, k in added]
    emit(line)
    del model
    torch.cuda.empty_cache()
    serve = times_serve_model(torch, device, "smollm-360m", smi, mesh=(1, 4))
    return line, serve


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

#: K3's backward checks: Mamba2-130m's segment-scan rows at (8, 1024)
#: (8 x 4 chunks x 24 heads, chunk 256), a ragged row length in one tile,
#: and a ragged row of five tiles (the carry across tiles, back to front)
TRAIN_K3_SHAPES = ((768, 256), (96, 1000), (64, 5000))
#: the full-width run through ``launch.train``: (steps, batch, seq)
TRAIN_RUN = (20, 8, 1024)
#: card-against-CPU gradient parity: layers, (B, S); a leaf's gap over its
#: largest magnitude
TRAIN_PARITY = (2, (2, 512))
TRAIN_PARITY_TOL = 1e-3
#: the offloaded DP step: mesh, (global batch, seq), steps, timed steps
TRAIN_DP = ((2, 2), (8, 512), 2, 3)


def k3_grad_case(torch, device, shape, exclusive, seed):
    """K3's Function on the card against ``torch.cumsum``'s autograd on the
    same card and inputs: the input gradient of an add scan (one forward
    launch, one back-to-front launch)."""
    from repro_torch.kernels.ops import prefix_scan

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device, requires_grad=True)
    g = torch.randn(shape, generator=gen, device=device)
    (got,) = torch.autograd.grad(prefix_scan(x, exclusive=exclusive), x, g)
    ref = torch.cumsum(x, dim=-1)
    if exclusive:
        ref = torch.cat([torch.zeros_like(ref[:, :1]), ref[:, :-1]], dim=-1)
    (want,) = torch.autograd.grad(ref, x, g)
    return got, want


def train_k3(torch, device, smi, mods):
    """K3's backward (the Function's back-to-front launch) against its plain
    version at the training shapes, inclusive and exclusive; a ``max`` scan
    of a tensor that requires grad raises."""
    from repro_torch.kernels.ops import prefix_scan

    k3 = mods["k3"]
    rtol, atol = scan_tolerance(torch, "add", torch.float32)
    cases = []
    for i, shape in enumerate(TRAIN_K3_SHAPES):
        for exclusive in (False, True):
            before = (k3.launches, k3.reverse_launches)
            got, want = k3_grad_case(torch, device, shape, exclusive, 40 + i)
            torch.cuda.synchronize()
            made = (k3.launches - before[0], k3.reverse_launches - before[1])
            if made != (2, 1):
                raise AssertionError(f"K3 grad {shape}: launches (all, "
                                     f"reverse) {made}, (2, 1) predicted")
            err = assert_match(torch, got, want, rtol, atol,
                               f"K3 backward {shape} exclusive={exclusive}")
            cases.append({"shape": list(shape), "exclusive": exclusive,
                          "max_abs_err": err, "forward_launches": 1,
                          "backward_launches": made[1]})
    x = torch.zeros(4, 8, device=device, requires_grad=True)
    try:
        prefix_scan(x, op="max")
    except NotImplementedError:
        pass
    else:
        raise AssertionError("a max scan of a tensor that requires grad "
                             "did not raise")
    line = {"phase": "train_k3", "cases": cases,
            "tolerance": {"rtol": rtol, "atol": atol}, "card": smi,
            "ok": True}
    emit(line)
    return line


def train_launcher(torch, device, smi, mods):
    """Mamba2-130m at full width (24 layers, bf16, weights from seed 0)
    through ``launch.train.main``, ``TRAIN_RUN`` steps of the seeded
    pipeline: every loss finite, the last five's mean below the first
    five's; K3 launched 48 times a step forward (the layer, then its
    recomputation in the backward) and 24 back to front."""
    import statistics
    import tempfile

    from repro_torch.launch import train

    steps, B, S = TRAIN_RUN
    k3 = mods["k3"]
    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as ckpt:
        _zeroed(mods)
        k3.reverse_launches = 0
        t0 = time.perf_counter()
        out = train.main(["--arch", "mamba2-130m", "--full", "--steps",
                          str(steps), "--batch", str(B), "--seq", str(S),
                          "--ckpt-dir", ckpt, "--device", str(device)])
        wall_s = time.perf_counter() - t0
        launches = {key: mods[key].launches for key in mods}
        reverse = k3.reverse_launches
    cfg, hist = out["config"], out["history"]
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"launch.train losses {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"loss did not fall: first five {first}, last "
                             f"five {last}")
    L = cfg.num_layers
    forward = launches["k3"] - reverse
    if (forward, reverse) != (steps * 2 * L, steps * L):
        raise AssertionError(
            f"K3 over {steps} steps: {forward} forward and {reverse} "
            f"reverse launches, {steps * 2 * L} and {steps * L} predicted")
    step_ms = statistics.median(h["step_time_s"] for h in hist) * 1e3
    line = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
            "layers": L, "batch": [B, S], "steps": steps,
            "losses": losses, "first5_mean": first, "last5_mean": last,
            "k3_launches_per_step": {"forward": forward / steps,
                                     "backward": reverse / steps},
            "other_launches": {k: v for k, v in launches.items()
                               if k != "k3"},
            "median_step_ms": step_ms,
            "tokens_per_s": B * S / (step_ms / 1e3),
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated(device) / 2**30,
            "wall_s": wall_s, "card": smi, "ok": True}
    emit(line)
    torch.cuda.empty_cache()
    return line


def train_parity(torch, device, smi):
    """One step's gradients of Mamba2-130m at full width in float32 (d_model
    768, 24 heads, state 128), cut to ``TRAIN_PARITY``'s layers, on the
    card against the port on the CPU, same weights (one seed) and batch:
    each leaf within ``TRAIN_PARITY_TOL`` of its largest magnitude."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.launch.steps import batch_to, loss_and_grads
    from repro_torch.models import build_model

    layers, (B, S) = TRAIN_PARITY
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=layers,
                              dtype="float32")
    api = build_model(cfg)
    batch = next(batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B, seed=7)))
    got = []
    for where in (device, torch.device("cpu")):
        model = api.init(torch.Generator().manual_seed(7), device=where)
        got.append(loss_and_grads(api, model, batch_to(batch, where)))
        del model
    (l_card, _, g_card), (l_cpu, _, g_cpu) = got
    gaps = {k: rel_err(torch, g_card[k], g) for k, g in g_cpu.items()}
    worst = max(gaps, key=gaps.get)
    if gaps[worst] > TRAIN_PARITY_TOL:
        raise AssertionError(f"card-vs-CPU gradient of {worst}: "
                             f"{gaps[worst]:.3g} of its largest magnitude")
    line = {"phase": "train_parity", "arch": cfg.name, "dtype": cfg.dtype,
            "layers": layers, "batch": [B, S],
            "loss": {"card": float(l_card), "cpu": float(l_cpu)},
            "worst_leaf": worst, "worst_gap": gaps[worst],
            "tolerance": TRAIN_PARITY_TOL, "leaves": len(gaps),
            "card": smi, "ok": True}
    emit(line)
    del got
    torch.cuda.empty_cache()
    return line


def train_dp(torch, device, smi, mods):
    """``train_offload_check``'s bitwise scenario on the card: Mamba2-130m
    at full width in float32 on a co-resident (2, 2) ``("pod", "data")``
    mesh, the engine's driver-mode descriptors against the raw
    ``compat.psum`` step (loss, grad_norm and every parameter bitwise over
    two steps, step 2 a plan-cache hit, ``examples_seen`` the global batch),
    then ms a step of each."""
    from repro_torch import compat
    from repro_torch.testing import train_offload_check as toc

    mesh_shape, (B, S), steps, iters = TRAIN_DP
    _zeroed(mods)
    rep = toc.bitwise_scenario(
        compat.Mesh(mesh_shape, ("pod", "data"), device=device), device,
        steps=steps, bench_iters=iters, arch="mamba2-130m", full=True,
        dtype="float32", batch=B, seq=S)
    launches = {key: mods[key].launches for key in mods}
    failed = [name for name, ok in rep.checks if not ok]
    if failed:
        raise AssertionError(f"offloaded DP step: {failed}; {rep.rows}")
    line = {"phase": "train_dp", "arch": "mamba2-130m", "dtype": "float32",
            "mesh": list(mesh_shape), "batch": [B, S], "steps": steps,
            "checks": [name for name, _ in rep.checks], "rows": rep.rows,
            "raw_ms": rep.values["raw_lax_ms"],
            "engine_ms": rep.values["offload_engine_ms"],
            "launches": launches, "card": smi, "ok": True}
    emit(line)
    del rep
    torch.cuda.empty_cache()
    return line


def phase_train(torch, device, smi):
    """The training path on the card (see the module docstring, phase 6);
    its profiler readings come later, in :func:`phase_times_train`."""
    mods = kernel_modules()
    t0 = time.perf_counter()
    k3 = train_k3(torch, device, smi, mods)
    run = train_launcher(torch, device, smi, mods)
    parity = train_parity(torch, device, smi)
    dp = train_dp(torch, device, smi, mods)
    check_module("compressed_dp_check", [], device)
    emit({"phase": "train_summary", "seconds": time.perf_counter() - t0,
          "k3_backward_max_abs_err": max(c["max_abs_err"]
                                         for c in k3["cases"]),
          "k3_launches_per_step": run["k3_launches_per_step"],
          "losses_first_last": [run["losses"][0], run["losses"][-1]],
          "parity_worst": [parity["worst_leaf"], parity["worst_gap"]],
          "dp_ms": {"raw": dp["raw_ms"], "engine": dp["engine_ms"]},
          "card": smi, "ok": True})
    return {"k3_launches_per_step": run["k3_launches_per_step"]}


def phase_times_train(torch, device, smi, card):
    """The training path's profiler readings: a reverse K3 launch beside a
    forward one at Mamba2-130m's (768, 256) segment-scan rows and at the
    memory-bound (8192, 8192) f32, each with its bytes bound, and one full-width bf16 training step (the
    launcher's model and shape) under ``torch.profiler``: host wall ms,
    device ms, the device share and K3's device ms and launches in it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.launch.steps import build_train_step, trainable
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.sharding import Topology

    k3 = kernel_modules()["k3"]

    def forward_and_reverse(shape):
        x = torch.randn(*shape, device=device)
        scan = {}
        for name, rev in (("forward", False), ("reverse", True)):
            scan[name] = {
                "device_ms": device_ms(
                    torch, lambda: k3.scan_rows(x, reverse=rev), 100,
                    name=KERNELS["k3"][3]),
                "event_ms": time_ms(
                    torch, lambda: k3.scan_rows(x, reverse=rev), 100)}
        bound = scan_bytes(x) / mem_bandwidth(card) * 1e3
        rtol, atol = scan_tolerance(torch, "add", x.dtype)
        scan["reverse"]["max_abs_err"] = assert_match(
            torch, k3.scan_rows(x, reverse=True),
            torch.cumsum(x.flip(-1), dim=-1).flip(-1), rtol, atol,
            f"K3 reverse {tuple(shape)}")
        return scan, bound

    R, L = TRAIN_K3_SHAPES[0]
    scan, bound_ms = forward_and_reverse((R, L))
    # the memory-bound shape of the onchip phase, where a launch's fixed
    # cost does not hide a slower reverse indexing
    big, big_bound_ms = forward_and_reverse((8192, 8192))
    torch.cuda.empty_cache()
    steps, B, S = TRAIN_RUN
    cfg = get_config("mamba2-130m")
    api = build_model(cfg)
    step_fn, _, _ = build_train_step(
        api, Topology(mesh=None), ShapeConfig("cli", S, B, "train"),
        AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps))
    model = trainable(api.init(torch.Generator().manual_seed(0),
                               device=device))
    opt = init_opt_state(model)
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                              global_batch=B))
    state = [model, opt]

    def step():
        state[0], state[1], m = step_fn(state[0], state[1], next(data))
        return float(m["loss"])

    for _ in range(2):
        step()
    wall_ms, table = kernel_times(torch, step)
    dev = sum(ms for ms, _ in table.values()) if table else None
    k3_rows = [v for k, v in table.items() if KERNELS["k3"][3] in k]
    line = {"phase": "times_train", "card": smi,
            "k3_rows": [R, L], "k3_bound_ms": bound_ms, "k3": scan,
            "k3_big": {"rows": [8192, 8192], "bound_ms": big_bound_ms,
                       **big},
            "step": {"arch": cfg.name, "dtype": cfg.dtype, "batch": [B, S],
                     "wall_ms": wall_ms, "device_ms": dev,
                     "device_share": None if dev is None else dev / wall_ms,
                     "k3_device_ms": (sum(ms for ms, _ in k3_rows)
                                      if k3_rows else None),
                     "k3_launches_profiled": sum(n for _, n in k3_rows)}}
    emit(line)
    del state, model, opt
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# the roofline: the op count of a whole model call, K3 charged where it
# launches, beside the same call's device time; and the dry run
# ---------------------------------------------------------------------------

#: the full-width Mamba2-130m training step of the roofline phase: (B, S),
#: ``TRAIN_RUN``'s
ROOFLINE_STEP = (8, 1024)
#: a count's bound may not exceed the call's measured device time
ROOFLINE_BOUND_SHARE_MAX = 1.05
#: the dry run's cells: Mamba2-130m at every shape, one pod
DRYRUN_CELLS = (("mamba2-130m", "train_4k"), ("mamba2-130m", "prefill_32k"),
                ("mamba2-130m", "decode_32k"), ("mamba2-130m", "long_500k"))
#: the reference's dry-run record keys (``src/repro/launch/dryrun.py:75-105``)
DRYRUN_KEYS = {"arch", "shape", "mesh", "n_chips", "kind", "lower_s",
               "compile_s", "memory", "roofline", "collectives",
               "raw_cost_analysis", "model_flops_total", "useful_flops_ratio",
               "params_total", "params_active", "opt"}


def roofline_calls(torch, device):
    """The roofline's two calls of Mamba2-130m at full width in bf16, each
    built when reached and freed after: the (8, 4096) ``lm_forward`` of
    ``times_serve_forward`` (weights from seed 23) and one training step at
    ``ROOFLINE_STEP`` as ``launch.train`` builds it (seed 0). Yields
    ``(call, fn, model_flops, K3 (forward, reverse) launches predicted,
    K3's shape)``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.launch.steps import batch_to, build_train_step, trainable
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.sharding import Topology

    an = roofline()
    cfg = get_config("mamba2-130m")
    api = build_model(cfg)
    L, H, Q = cfg.num_layers, cfg.ssm_num_heads, cfg.ssm_chunk
    model = api.init(torch.Generator().manual_seed(23), device=device)
    B, S = SERVE_FORWARD
    tokens = model_batch(torch, cfg, B, S, device, seed=23)["tokens"]

    def forward():
        with torch.inference_mode():
            return api.forward(model, {"tokens": tokens})[0]

    yield ("forward", forward,
           an.model_flops(cfg, ShapeConfig("roofline", S, B, "prefill"),
                          "prefill"),
           (L, 0), {"rows": B * (S // Q) * H, "length": Q,
                    "dtype": torch.float32})
    del model, forward
    torch.cuda.empty_cache()

    B, S = ROOFLINE_STEP
    shape = ShapeConfig("roofline", S, B, "train")
    step_fn, _, _ = build_train_step(
        api, Topology(mesh=None), shape,
        AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=TRAIN_RUN[0]))
    model = trainable(api.init(torch.Generator().manual_seed(0),
                               device=device))
    state = [model, init_opt_state(model)]
    del model
    batch = batch_to(next(batches(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))), device)

    def step():
        state[0], state[1], metrics = step_fn(state[0], state[1], batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"roofline train_step: loss {loss}")
        return loss

    yield ("train_step", step, an.model_flops(cfg, shape, "train"),
           (2 * L, L), {"rows": B * (S // Q) * H, "length": Q,
                        "dtype": torch.float32})
    del state, step
    torch.cuda.empty_cache()


def device_seconds(torch, fn):
    """The device time of one run of ``fn``: the profiler's sum of every
    device activity, after an untimed primer launch in the same session (a
    session's first launch can leave no record); CUDA events around the
    call when the trace holds no device time (then the span, idle gaps
    included). Returns (seconds, how, wall ms)."""
    primer = torch.zeros(1, device="cuda")

    def primed():
        primer.add_(1)
        torch.cuda.synchronize()
        fn()

    wall_ms, table = kernel_times(torch, primed)
    if table:
        return sum(ms for ms, _ in table.values()) / 1e3, "profiler", wall_ms
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, "events", wall_ms


def phase_roofline(torch, device, smi, card):
    """Each of :func:`roofline_calls`, after a warm-up, counted once under
    ``CostMode`` and then run again, uncounted, under the profiler
    (:func:`device_seconds`): FLOPs, bytes, the compute and memory terms,
    the bound and its bottleneck, ``model_flops``, the device time,
    ``bound_share = t_bound / device_s`` (at most
    ``ROOFLINE_BOUND_SHARE_MAX``: a bound above the measured time is a
    wrong count) and ``mfu = model_flops / (device_s x bf16 peak)``; K3's
    charges equal to its launches in the counted run (forward, back to
    front) and to the prediction, each at ``kernel_cost("k3", ...)`` of
    the model's segment-scan shape."""
    from repro_torch.roofline.op_cost import CostMode

    an = roofline()
    k3 = kernel_modules()["k3"]
    peak = peak_flops(card, "bfloat16")
    t0 = time.perf_counter()
    rows = {}
    for what, fn, mf, want_k3, k3_shape in roofline_calls(torch, device):
        fn()                                  # warm-up
        torch.cuda.synchronize()
        before = (k3.launches, k3.reverse_launches)
        t1 = time.perf_counter()
        with CostMode() as mode:
            fn()
            torch.cuda.synchronize()
        count_s = time.perf_counter() - t1
        made = (k3.launches - before[0] - (k3.reverse_launches - before[1]),
                k3.reverse_launches - before[1])
        charges = [c for c in mode.charges if c.kind == "k3"]
        charged = (sum(not c.shape["reverse"] for c in charges),
                   sum(bool(c.shape["reverse"]) for c in charges))
        if not charged == made == want_k3:
            raise AssertionError(
                f"roofline {what}: K3 charges (forward, reverse) {charged}, "
                f"launches {made}, {want_k3} predicted")
        one = an.kernel_cost("k3", **k3_shape)
        for c in charges:
            got = {k: c.shape[k] for k in k3_shape}
            if got != k3_shape or c.bytes != one.bytes:
                raise AssertionError(
                    f"roofline {what}: a K3 charge of {got}, {c.bytes} B; "
                    f"{k3_shape}, {one.bytes} B predicted")
        roof = an.analyze(mode.cost, 1, card=an.card_for(card))
        device_s, timing, wall_ms = device_seconds(torch, fn)
        share = roof.t_bound / device_s
        rows[what] = {
            "call": what, "flops": mode.cost.flops, "bytes": mode.cost.bytes,
            "t_compute_s": roof.t_compute, "t_memory_s": roof.t_memory,
            "t_bound_s": roof.t_bound, "bottleneck": roof.bottleneck,
            "model_flops": mf, "useful_flops_ratio": mf / mode.cost.flops,
            "device_s": device_s, "timing": timing, "wall_ms": wall_ms,
            "bound_share": share, "mfu": mf / (device_s * peak),
            "k3_charges": list(charged), "k3_launches": list(made),
            "k3_charge_bytes": one.bytes, "unpriced": mode.unpriced,
            # where the counted bytes are: the eight heaviest ops
            "top_bytes": sorted(((name, fb[1]) for name, fb in
                                 mode.by_op.items()),
                                key=lambda nb: -nb[1])[:8],
            "count_s": count_s, "card": smi}
        emit({"phase": "roofline_call", **rows[what]})
        if not 0 < share <= ROOFLINE_BOUND_SHARE_MAX:
            raise AssertionError(
                f"roofline {what}: bound {roof.t_bound:.4g} s over "
                f"{device_s:.4g} s on the device ({share:.3f})")
    emit({"phase": "roofline", "seconds": time.perf_counter() - t0,
          "arch": "mamba2-130m", "dtype": "bfloat16",
          "calls": {w: {k: r[k] for k in (
              "flops", "bytes", "t_bound_s", "bottleneck", "device_s",
              "bound_share", "mfu", "k3_charges")} for w, r in rows.items()},
          "card": smi, "ok": True})
    return rows


def phase_dryrun(smi):
    """``launch.dryrun.run_cell`` for ``DRYRUN_CELLS`` on one pod on the
    ``meta`` device (no GPU time): every reference key, 256 chips, FLOPs
    and bytes above 0, a named bottleneck, a useful share in (0, 1.05];
    each record's roofline and seconds."""
    import tempfile

    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cells = []
    with tempfile.TemporaryDirectory() as out:
        for arch, shape in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shape, "single", Path(out))
            r = rec["roofline"]
            bad = [
                what for what, ok in (
                    ("keys", set(rec) == DRYRUN_KEYS),
                    ("n_chips", rec["n_chips"] == r["n_chips"] == 256),
                    ("flops", r["flops_per_device"] > 0),
                    ("bytes", r["bytes_per_device"] > 0),
                    ("bottleneck", r["bottleneck"] in (
                        "compute", "memory", "collective")),
                    ("useful", 0 < rec["useful_flops_ratio"] <= 1.05))
                if not ok]
            if bad:
                raise AssertionError(f"dryrun {arch} x {shape}: {bad}; {rec}")
            cells.append({"arch": arch, "shape": shape,
                          "seconds": rec["lower_s"], "roofline": r,
                          "useful_flops_ratio": rec["useful_flops_ratio"],
                          "collectives": rec["collectives"]["counts"],
                          "memory": rec["memory"]})
            emit({"phase": "dryrun_cell", **cells[-1]})
    emit({"phase": "dryrun", "seconds": time.perf_counter() - t0,
          "cells": [[c["arch"], c["shape"], c["seconds"],
                     c["roofline"]["bottleneck"]] for c in cells],
          "card": smi, "ok": True})
    return cells


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
    phase_onchip(torch, device)
    serve = phase_serve(torch, device, smi)
    mesh = phase_mesh(torch, device, smi)
    train = phase_train(torch, device, smi)
    launches = phase_main(torch, device)
    phase_service(torch, device)
    phase_reliability(torch, device)
    phase_health(torch, device)
    entry_launches, cases = phase_entry(torch, device)
    spmd_launches = phase_spmd(torch, device)
    phase_baseline(torch, device)
    phase_tune(torch, device)
    # the serving path's and the mesh paths' profiler readings, then
    # ``profile``: the order in which profile_offload once lost its device
    # events
    phase_times_serve(torch, device, smi)
    phase_times_mesh(torch, device, smi)
    phase_times_train(torch, device, smi, card)
    phase_profile(torch, device)
    # the roofline and the dry run after ``profile``: run right after
    # ``train``, they left ``profile``'s two sessions in a row without a
    # device event
    roof = phase_roofline(torch, device, smi, card)
    phase_dryrun(smi)
    k1 = phase_times(torch, device, card, launches)
    k2 = phase_times_spmd(torch, device, card, spmd_launches)
    onchip = phase_times_onchip(torch, card, entry_launches, cases)
    phase_times_k4(torch, device, card)
    # the serving path's launches beside each kernel's own path: K3 under
    # every Mamba2-130m prefill and in every mesh shard, K1 under the
    # serving tenancy
    onchip[0]["serve_launches"] = serve["full"][0]["launches"]["k3"]
    onchip[0]["mesh_launches"] = mesh["k3_launches"]
    onchip[0]["train_launches"] = train["k3_launches_per_step"]
    # K3's charges in the roofline's counted forward and training step,
    # each equal to its launches there
    onchip[0]["roofline_launches"] = {
        call: row["k3_charges"] for call, row in roof.items()}
    k1["serve_launches"] = serve["tenancy"]["k1_launches"]
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    emit({"kernels": [k1, k2, *onchip]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
