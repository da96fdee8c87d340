"""K3's launch plan and the arithmetic of its three paths.

``repro_torch.kernels.prefix_scan.plan_launch`` picks the path of a call
(``rows``: a warp a short row; ``tiles``: a block a long row, many rows;
``lookback``: chunks of few long rows joined by a decoupled look-back), its
vector width, block, grid and scratch; the CUDA kernel follows it on the
card. Here the plan's properties are checked over every shape
``chip_smoke.py`` drives, and two emulations of the kernel's combine order
in plain PyTorch are held against the JAX package's scan (its Pallas kernel
in interpret mode and its ``ref`` oracle) and the port's plain version, on
numpy-seeded inputs:

* :func:`rows_reference`: the rows path, one lane group a row: each lane's
  vector scanned serially, the lane totals by doubling (the shuffles), the
  carry across the row's segments;
* :func:`chunked_reference`: the tiles and lookback paths: a block's tile of
  vectors scanned as above up to the warp, the warp totals by doubling, and
  the carry from the chunks before, their aggregates folded in chunk order
  back to the nearest inclusive prefix in windows of 32 (the look-back
  warp's reads). The tiles path is its ``reach="near"`` case: each tile's
  carry is the one before it.

Both run back to front by flipping (the kernel reads each vector from the
row's end and reverses it in registers: the same arithmetic on the same
logical elements).

Tolerances, stated per comparison: bitwise for ``max`` and the integer types
(the combines are exact; sums and products wrap); float32 ``add`` and
``mul`` rtol = atol = 1e-4, the reference suite's K3 tolerance
(``test_torch_kernels.py::test_prefix_scan_matches_reference_kernel``);
bfloat16 2.5e-1, the reference suite's bf16 tolerance (the reference rounds
at every combine, the kernel once per output from a float32 carry).
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import prefix_scan as j_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from test_torch_interop import BF16, assert_same, to_both

K3 = importlib.import_module("repro_torch.kernels.prefix_scan")



# ---------------------------------------------------------------------------
# the kernel's arithmetic, in plain PyTorch
# ---------------------------------------------------------------------------


def _wrap(t: torch.Tensor, bits: int) -> torch.Tensor:
    half = 1 << (bits - 1)
    return (t + half) % (2 * half) - half


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One combine in the carry type: float32 rounds as ``__fadd_rn`` /
    ``__fmul_rn``; integers (carried in int64 here) wrap to 32 bits; max
    propagates NaN."""
    if op == "add":
        r = a + b
    elif op == "mul":
        r = a * b
    else:
        r = torch.maximum(a, b)
    return _wrap(r, 32) if r.dtype == torch.int64 else r


def _identity(op: str, dtype: torch.dtype):
    if op == "add":
        return 0
    if op == "mul":
        return 1
    return float("-inf") if dtype.is_floating_point else -(1 << 31)


def _widen(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype.is_floating_point else x.long()


def _narrow(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype.is_floating_point:
        return t.to(dtype)  # round to nearest even, once an output
    return _wrap(t, 8 * dtype.itemsize).to(dtype)


def _doubling(t: torch.Tensor, op: str) -> torch.Tensor:
    """Inclusive scan along the last axis as the shuffles compute it: at
    offset 1, 2, 4, ... a lane combines the value that many lanes below with
    its own."""
    off = 1
    while off < t.shape[-1]:
        t = torch.cat([t[..., :off], _combine(op, t[..., :-off], t[..., off:])],
                      dim=-1)
        off *= 2
    return t


def _shift(t: torch.Tensor, ident) -> torch.Tensor:
    """What the earlier lanes hold: the inclusive values moved up one lane,
    the identity in lane 0."""
    return torch.cat([torch.full_like(t[..., :1], ident), t[..., :-1]], dim=-1)


def _vector_scan(v: torch.Tensor, op: str) -> torch.Tensor:
    for k in range(1, v.shape[-1]):
        v = torch.cat([v[..., :k], _combine(op, v[..., k - 1:k], v[..., k:k + 1]),
                       v[..., k + 1:]], dim=-1)
    return v


def _outputs(op: str, before: torch.Tensor, v: torch.Tensor,
             exclusive: bool) -> torch.Tensor:
    """A vector's outputs from the prefix before it and its scanned values."""
    b = before[..., None]
    if exclusive:
        return torch.cat([b, _combine(op, b, v[..., :-1])], dim=-1)
    return _combine(op, b, v)


def _finish(out, x, op, exclusive):
    R, L = x.shape
    out = out.reshape(R, -1)[:, :L]
    if exclusive:
        out = out.clone()
        out[:, 0] = float(tref.scan_identity(op, x.dtype))
    return _narrow(out, x.dtype)


def _padded(x, op, multiple):
    R, L = x.shape
    a = _widen(x)
    pad = -L % multiple
    ident = _identity(op, x.dtype)
    return torch.cat([a, torch.full((R, pad), ident, dtype=a.dtype)], dim=1), ident


def rows_reference(x: torch.Tensor, op: str = "add", exclusive: bool = False,
                   reverse: bool = False, *, vec: int = 1,
                   lanes: int = 32) -> torch.Tensor:
    """The rows path: ``lanes`` lanes a row, one ``vec``-element vector a
    lane a segment, the carry across segments in a register."""
    if reverse:
        return rows_reference(x.flip(-1), op, exclusive, vec=vec,
                              lanes=lanes).flip(-1)
    R = x.shape[0]
    a, ident = _padded(x, op, lanes * vec)
    v = _vector_scan(a.reshape(R, -1, lanes, vec), op)
    incl = _doubling(v[..., -1], op)          # (R, segments, lanes)
    carry = torch.full((R,), ident, dtype=a.dtype)
    out = []
    for s in range(v.shape[1]):
        earlier = _combine(op, carry[:, None], incl[:, s, :-1])
        before = torch.cat([carry[:, None], earlier], dim=1)
        out.append(_outputs(op, before, v[:, s], exclusive))
        carry = _combine(op, carry, incl[:, s, -1])
    return _finish(torch.stack(out, 1), x, op, exclusive)


def chunked_reference(x: torch.Tensor, op: str = "add",
                      exclusive: bool = False, reverse: bool = False, *,
                      vec: int = 1, threads: int = 256, vecs: int = 4,
                      reach: str = "near", seed: int = 0) -> torch.Tensor:
    """The tiles and lookback paths: chunks of ``threads * vec * vecs``
    elements, vector u of thread t at ``(u * threads + t) * vec``.

    ``reach`` says where each chunk's look-back finds its nearest inclusive
    prefix: ``"near"`` its predecessor (the tiles path, whose carry is the
    tile before's), ``"far"`` chunk 0 (every other predecessor still an
    aggregate), ``"random"`` a seeded draw. The look-back folds, in windows
    of 32 chunks, the latest window first, each window's values in chunk
    order."""
    if reverse:
        return chunked_reference(x.flip(-1), op, exclusive, vec=vec,
                                 threads=threads, vecs=vecs, reach=reach,
                                 seed=seed).flip(-1)
    R = x.shape[0]
    warps = threads // 32
    a, ident = _padded(x, op, threads * vec * vecs)
    # (R, chunks, entries (u, warp) in tile order, lanes, vec)
    v = _vector_scan(a.reshape(R, -1, vecs * warps, 32, vec), op)
    incl = _doubling(v[..., -1], op)
    lane_before = _shift(incl, ident)
    totals = _doubling(incl[..., -1], op)  # one warp scans the warp totals
    warp_before = _shift(totals, ident)
    agg = totals[..., -1]                  # (R, chunks)
    rng = np.random.default_rng(seed)
    carry, inclusive = [], []
    for c in range(agg.shape[1]):
        nearest = {"near": c - 1, "far": 0}.get(reach)
        if nearest is None:
            nearest = int(rng.integers(0, c)) if c else -1
        run = torch.full((R,), ident, dtype=a.dtype)
        pred = c - 1
        while pred >= 0:
            take = min(pred - nearest + 1, 32)
            acc = torch.full((R,), ident, dtype=a.dtype)
            for q in range(pred - take + 1, pred + 1):
                acc = _combine(op, acc, inclusive[q] if q == nearest else agg[:, q])
            run = _combine(op, acc, run)
            if pred - take < nearest:
                break
            pred -= take
        carry.append(run)
        inclusive.append(agg[:, 0] if c == 0 else _combine(op, run, agg[:, c]))
    carry = torch.stack(carry, 1)[..., None, None]
    before = _combine(op, _combine(op, carry, warp_before[..., None]),
                      lane_before)
    return _finish(_outputs(op, before, v, exclusive), x, op, exclusive)


# ---------------------------------------------------------------------------
# inputs and tolerances
# ---------------------------------------------------------------------------


def _input(rng, shape, op, dtype, *, nan=False):
    if dtype in (np.int32, np.int8):
        hi = 4 if op == "mul" else (1 << 30 if dtype == np.int32 else 128)
        return rng.integers(-hi, hi, size=shape).astype(dtype)
    if op == "mul":
        # log-symmetric factors: a long product stays a normal float
        x = np.exp(0.01 * rng.standard_normal(shape))
    else:
        x = rng.standard_normal(shape)
    x = x.astype(np.float32)
    if nan:
        x[1, shape[1] // 3] = np.nan
    return x.astype(dtype)


def _tol(op, dtype):
    """bitwise for max and integers, 1e-4 float32 add / mul, 2.5e-1 bf16."""
    if op == "max" or dtype in (np.int32, np.int8):
        return 0.0
    return 2.5e-1 if dtype == BF16 else 1e-4


def _wide(dtype) -> int:
    return max(1, K3.VEC_BYTES // np.dtype(dtype).itemsize)


#: small designs for the emulations, so that short rows already have many
#: segments, tiles and chunks (lanes a row; threads and vectors a tile or
#: chunk): the shipped design's arithmetic at other sizes
SMALL = dict(lanes=8, threads=64, vecs=2)


def _emulations(tx, op, exclusive, reverse, vec):
    return {
        "rows": rows_reference(tx, op, exclusive, reverse, vec=vec,
                               lanes=SMALL["lanes"]),
        "rows_warp": rows_reference(tx, op, exclusive, reverse, vec=vec),
        "tiles": chunked_reference(tx, op, exclusive, reverse, vec=vec,
                                   threads=SMALL["threads"],
                                   vecs=SMALL["vecs"]),
        "lookback_far": chunked_reference(tx, op, exclusive, reverse,
                                          vec=vec, threads=32, vecs=1,
                                          reach="far"),
        "lookback_random": chunked_reference(tx, op, exclusive, reverse,
                                             vec=vec, threads=32, vecs=1,
                                             reach="random", seed=7),
    }


# ---------------------------------------------------------------------------
# the emulations against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int32, np.int8])
@pytest.mark.parametrize("op", ["add", "max", "mul"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_paths_match_both_references(dtype, op, exclusive):
    """Every path's combine order, at the vector width and at one element a
    lane, against the reference's Pallas kernel (interpret mode), its
    ``ref`` oracle and the port's plain version; a NaN in each float max
    row set."""
    rng = np.random.default_rng(len(op) * 10 + int(exclusive))
    L = 2 * 16 * 11  # a multiple of every vector width, 352
    x = _input(rng, (3, L), op, dtype, nan=op == "max" and dtype != np.int32
               and dtype != np.int8)
    jx, tx = to_both(x)
    tol = _tol(op, dtype)
    wants = {
        "pallas": j_scan(jx, op=op, exclusive=exclusive, force_pallas=True),
        "ref": jref.ref_prefix_scan(jx, op, exclusive=exclusive),
    }
    plain = tref.ref_prefix_scan(tx, op, exclusive=exclusive)
    for vec in sorted({1, _wide(dtype)}):
        for name, got in _emulations(tx, op, exclusive, False, vec).items():
            what = f"{name} vec={vec} {op} {np.dtype(dtype)} exclusive={exclusive}"
            for ref_name, want in wants.items():
                assert_same(want, got, rtol=tol, atol=tol,
                            what=f"{what} vs {ref_name}")
            torch.testing.assert_close(got, plain, rtol=tol, atol=tol,
                                       equal_nan=True, msg=what)


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int32, np.int8])
@pytest.mark.parametrize("exclusive", [False, True])
def test_reverse_matches_the_flipped_reference(dtype, exclusive):
    """The back-to-front add scan (K3's backward) against the reference's
    scan of the flipped rows, flipped back; a ragged L (one element a
    lane)."""
    rng = np.random.default_rng(20 + int(exclusive))
    for L in (2 * 16 * 11, 349):
        x = _input(rng, (2, L), "add", dtype)
        jx, tx = to_both(np.ascontiguousarray(x[:, ::-1]))
        want = j_scan(jx, op="add", exclusive=exclusive, force_pallas=True)
        want = np.ascontiguousarray(np.asarray(want)[:, ::-1])
        _, tfwd = to_both(x)
        tol = _tol("add", dtype)
        vecs = sorted({1, _wide(dtype)}) if L % _wide(dtype) == 0 else [1]
        for vec in vecs:
            for name, got in _emulations(tfwd, "add", exclusive, True,
                                         vec).items():
                assert_same(want, got, rtol=tol, atol=tol,
                            what=f"reverse {name} vec={vec} L={L}")
        plain = K3.scan_rows(tfwd, exclusive=exclusive, reverse=True)
        assert_same(want, plain, rtol=tol, atol=tol, what=f"plain L={L}")


@pytest.mark.parametrize("reach", ["near", "far", "random"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_lookback_windows_fold_every_chunk_once(reach, dtype):
    """More than 32 chunks a row, so that a far look-back takes several
    windows: the fold counts every chunk once (int32 bitwise) and in order
    (float32 at the scan tolerance), inclusive and exclusive."""
    rng = np.random.default_rng(30)
    x = _input(rng, (2, 32 * 70 + 5), "add", dtype)
    _, tx = to_both(x)
    for exclusive in (False, True):
        want = tref.ref_prefix_scan(tx, "add", exclusive=exclusive)
        got = chunked_reference(tx, "add", exclusive, threads=32, vecs=1,
                                reach=reach, seed=3)
        tol = _tol("add", dtype)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_ragged_and_one_element_rows():
    """L = 1, 2, 3 and around a vector width: every path at one element a
    lane against the plain version, bitwise in int32."""
    rng = np.random.default_rng(40)
    for L in (1, 2, 3, 15, 16, 17, 255, 257):
        x = torch.from_numpy(_input(rng, (3, L), "add", np.int32))
        for exclusive in (False, True):
            want = tref.ref_prefix_scan(x, "add", exclusive=exclusive)
            for name, got in _emulations(x, "add", exclusive, False, 1).items():
                assert torch.equal(got, want), (name, L, exclusive)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

A16 = 1 << 20  # an aligned pointer
#: (shape, dtype, op, reverse, path, vec): every K3 shape chip_smoke.py
#: drives (onchip, entry, times, the models' segment scans and offsets, the
#: training path's gradients), with the path and width the plan gives
#: aligned pointers
CHIP_SHAPES = [
    ((1, 1), torch.float32, "add", False, "rows", 1),
    ((5, 1), torch.int32, "add", False, "rows", 1),
    ((5, 2), torch.float32, "max", False, "rows", 1),
    ((5, 3), torch.bfloat16, "mul", False, "rows", 1),
    ((3, 257), torch.float32, "add", True, "rows", 1),
    ((3, 257), torch.int8, "add", False, "rows", 1),
    ((7, 255), torch.float32, "add", False, "rows", 1),
    ((7, 256), torch.float32, "add", True, "rows", 4),
    ((7, 256), torch.bfloat16, "add", False, "rows", 8),
    ((9, 17), torch.int8, "add", False, "rows", 1),
    ((9, 32), torch.int8, "mul", False, "rows", 16),
    ((2, 1000), torch.float32, "mul", False, "rows", 4),
    ((6, 64), torch.int32, "max", False, "rows", 4),
    ((30, 700), torch.bfloat16, "add", False, "rows", 1),
    ((1, 64), torch.int32, "add", False, "rows", 4),        # OLMoE offsets
    ((8, 64), torch.int32, "add", False, "rows", 4),        # EP offsets
    ((48, 256), torch.float32, "add", False, "rows", 4),    # a (2, 256) prefill
    ((3072, 256), torch.float32, "add", False, "rows", 4),  # (8, 4096) forward
    ((768, 256), torch.float32, "add", False, "rows", 4),   # (8, 1024) step
    ((768, 256), torch.float32, "add", True, "rows", 4),    # its backward
    ((96, 1000), torch.float32, "add", True, "rows", 4),
    ((300, 4096), torch.float32, "add", True, "tiles", 4),
    ((300, 4097), torch.float32, "max", False, "tiles", 1),
    ((264, 5000), torch.bfloat16, "add", True, "tiles", 8),
    ((8192, 8192), torch.float32, "add", False, "tiles", 4),
    ((8192, 8192), torch.float32, "add", True, "tiles", 4),
    ((8192, 8192), torch.float32, "max", False, "tiles", 4),
    ((8192, 8192), torch.float32, "mul", False, "tiles", 4),
    ((8192, 8192), torch.bfloat16, "add", False, "tiles", 8),
    ((8192, 8192), torch.int32, "add", False, "tiles", 4),
    ((64, 5000), torch.float32, "add", True, "lookback", 4),
    ((1, 70000), torch.float32, "add", True, "lookback", 4),
    ((1, 70000), torch.int8, "max", False, "lookback", 16),
    ((1, 70000), torch.float16, "mul", False, "lookback", 8),
    ((3, 70001), torch.float32, "add", False, "lookback", 1),
    ((4, 1 << 22), torch.float32, "add", True, "lookback", 4),
    ((1, 67108864), torch.float32, "add", False, "lookback", 4),
]


@pytest.mark.parametrize("case", CHIP_SHAPES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_plan_of_every_chip_shape(case):
    (R, L), dtype, op, reverse, path, vec = case
    plan = K3.plan_launch(R, L, dtype, op, False, reverse,
                          (A16, A16 + 16 * R * L))
    assert (plan.path, plan.vec) == (path, vec)
    assert L % plan.vec == 0
    assert plan.chunks * plan.chunk >= L > (plan.chunks - 1) * plan.chunk
    # the grid covers every row, each once
    assert plan.blocks * plan.rows_per_block >= R * plan.chunks
    assert (plan.blocks - 1) * plan.rows_per_block < R * plan.chunks
    if path == "lookback":
        assert plan.blocks == R * plan.chunks
        assert plan.status_words == K3.HEAD_WORDS + plan.blocks
    else:
        assert plan.status_words == 0 and plan.chunks == 1 and plan.chunk == L
    assert plan.threads % 32 == 0 and plan.threads <= 1024


def test_plan_at_the_models_shapes():
    """Mamba2-130m's segment scan: 384 blocks of 8 warps, one row a warp
    (one wave at 8 blocks an SM); its training step's rows 96 blocks."""
    seg = K3.plan_launch(3072, 256, torch.float32)
    assert (seg.path, seg.blocks, seg.threads, seg.rows_per_block) == (
        "rows", 384, 256, 8)
    assert K3.plan_launch(768, 256, torch.float32, reverse=True).blocks == 96
    big = K3.plan_launch(8192, 8192, torch.float32)
    assert (big.path, big.blocks, big.threads) == ("tiles", 8192, 256)
    long = K3.plan_launch(1, 67108864, torch.float32)
    assert (long.chunk, long.chunks) == (4096, 16384)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.int8])
def test_plan_vector_width_follows_alignment_and_length(dtype):
    wide = K3.VEC_BYTES // dtype.itemsize
    assert wide * dtype.itemsize == 16
    for R, L in ((8, 256), (8192, 8192), (1, 1 << 20)):
        assert K3.plan_launch(R, L, dtype, ptrs=(A16, A16)).vec == wide
        # a pointer 4 bytes off 16-byte alignment, in or out
        assert K3.plan_launch(R, L, dtype, ptrs=(A16 + 4, A16)).vec == 1
        assert K3.plan_launch(R, L, dtype, ptrs=(A16, A16 + 4)).vec == 1
        # an odd L: no whole vectors
        assert K3.plan_launch(R, L + 1, dtype, ptrs=(A16, A16)).vec == 1
    assert K3.plan_launch(2, 257, dtype).vec == 1


def test_plan_path_thresholds():
    rows_max = K3.ROWS_MAX_BYTES // 4
    assert K3.plan_launch(1, rows_max, torch.float32).path == "rows"
    assert K3.plan_launch(K3.TILES_MIN_ROWS, rows_max + 1,
                          torch.float32).path == "tiles"
    assert K3.plan_launch(K3.TILES_MIN_ROWS - 1, rows_max + 1,
                          torch.float32).path == "lookback"
    # the same bytes: bf16 rows twice as long stay on the rows path
    assert K3.plan_launch(1, 2 * rows_max, torch.bfloat16).path == "rows"


def test_plan_named_paths_and_widths_for_comparisons():
    for path in ("rows", "tiles", "lookback"):
        plan = K3.plan_launch(8192, 8192, torch.float32, path=path)
        assert plan.path == path
        assert plan.chunks * plan.chunk >= 8192
        assert plan.blocks * plan.rows_per_block >= 8192 * plan.chunks
    assert K3.plan_launch(8192, 8192, torch.float32, vec=1).vec == 1
    with pytest.raises(ValueError):
        K3.plan_launch(8, 256, torch.float32, path="columns")
    with pytest.raises(ValueError):
        K3.plan_launch(8, 256, torch.float32, vec=2)
    with pytest.raises(ValueError):
        K3.plan_launch(8, 257, torch.float32, vec=4)


@pytest.mark.parametrize("op", ["max", "mul"])
def test_plan_rejects_what_no_kernel_takes(op):
    with pytest.raises(ValueError):
        K3.plan_launch(8, 256, torch.float32, op, reverse=True)
    with pytest.raises(ValueError):
        K3.scan_rows(torch.zeros(2, 3), op=op, reverse=True)
    with pytest.raises(ValueError):
        K3.plan_launch(8, 256, torch.float64, op)
    with pytest.raises(ValueError):
        K3.plan_launch(8, 256, torch.float32, "min")


def _constants(name: str, start: str = "", end: str = "") -> dict:
    """The ``constexpr int NAME = <integer>;`` values of ``csrc/<name>.cu``,
    of its text from ``start`` up to ``end`` where given."""
    src = (Path(K3.__file__).parent / "csrc" / f"{name}.cu").read_text()
    src = src[src.index(start) if start else 0:src.index(end) if end else None]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _mirrors(kernel: str) -> dict:
    """Each wrapper constant that mirrors a design value of its kernel's
    source: (the wrapper's value, the source's)."""
    if kernel == "k2":
        K2 = importlib.import_module("repro_torch.kernels.spmd_collective")
        cl = _constants("spmd_collective", "namespace cl {",
                        "}  // namespace cl")
        return {"CLUSTER_THREADS": (K2.CLUSTER_THREADS, cl["THREADS"])}
    if kernel == "k3":
        src = _constants("prefix_scan")
        return {name: (getattr(K3, name), src[name]) for name in (
            "VEC_BYTES", "ROW_THREADS", "TILE_THREADS", "CHUNK_THREADS",
            "CHUNK_VECS", "HEAD_WORDS")}
    if kernel == "k4":
        K4 = importlib.import_module("repro_torch.kernels.ssd_scan")
        src = _constants("ssd_scan")
        return {"STEPS": (K4.STEPS, src["STEPS"]),
                "TIME_WARPS": (K4.TIME_WARPS, src["TW"]),
                "FEATURE_WARPS": (K4.FEATURE_WARPS, src["FW"]),
                "VEC_BYTES": (K4.VEC_BYTES, src["VEC_BYTES"]),
                "HEAD_WORDS": (K4.HEAD_WORDS, src["HEAD_WORDS"])}
    K5 = importlib.import_module("repro_torch.kernels.flash_attention")
    tc = _constants("flash_attention", "namespace tc {", "}  // namespace tc")
    simt = _constants("flash_attention", end="namespace dec {")
    return {"TC_BLOCK_Q": (K5.TC_BLOCK_Q, tc["BQ"]),
            "TC_BLOCK_KV": (K5.TC_BLOCK_KV, tc["BKV"]),
            "SIMT_BLOCK_Q": (K5.SIMT_BLOCK_Q, simt["BQ"])}


@pytest.mark.parametrize("kernel", ["k2", "k3", "k4", "k5"])
def test_shipped_build_is_the_sources_default(kernel):
    """The wrappers of K2-K5 plan with constants that mirror their sources'
    ``constexpr`` design values: each pair must agree."""
    for name, (wrapper, source) in _mirrors(kernel).items():
        assert wrapper == source, f"{kernel} {name}: {wrapper} != {source}"


def test_cpu_calls_launch_nothing():
    before = (K3.launches, K3.reverse_launches, dict(K3.path_launches))
    x = torch.randn(4, 3000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(K3.scan_rows(x), tref.ref_prefix_scan(x, "add"))
    ops.prefix_scan(x, exclusive=True)
    x.requires_grad_(True)
    ops.prefix_scan(x).sum().backward()
    assert (K3.launches, K3.reverse_launches, dict(K3.path_launches)) == before
