"""K4's launch plan, the chunked path's arithmetic, and ``ssd_scan``'s ``h0``
broadcasting.

``repro_torch.kernels.ssd_scan.plan_launch`` picks the path of a call (the
chunked scan with a decoupled look-back for ``T`` of at least two chunks,
the column walk otherwise), its tile, vector width, grid and scratch; the
CUDA kernel follows it on the card. Here the plan's properties are checked,
and :func:`chunked_reference` (the chunked kernel's arithmetic in plain
PyTorch: each warp's pair over its steps, the block's pair over its warps,
the carry-in folded through the predecessors' aggregates back to the nearest
inclusive state, then the re-walk from the carry) is held against the port's
``ref_ssd_scan`` and the JAX package's ``ssd_scan`` (its ``ref`` path and
its Pallas kernel in interpret mode) on numpy-seeded inputs.

Tolerance: rtol = atol = 2e-3, the reference suite's K4 tolerance
(``test_torch_kernels.py::test_ssd_scan_matches_reference_kernel``); the
chunked form only reassociates float32 products and sums. With ``a = b =
1`` every state is an integer below 2^24, exact in float32, so there the
comparison is bitwise: a carry dropped or counted twice shows as a wrong
integer.
"""

import importlib
from typing import Optional

import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd_scan as j_ssd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from test_torch_interop import assert_same, to_both

K4 = importlib.import_module("repro_torch.kernels.ssd_scan")

L = K4.CHUNK                # time steps a block
SUB = K4.STEPS              # time steps a warp
TOL = 2e-3


# ---------------------------------------------------------------------------
# the chunked kernel's arithmetic, in plain PyTorch
# ---------------------------------------------------------------------------


def _compose(A, B, x, y):
    """(A, B) o (x, y): the map h -> A h + B applied after h -> x h + y, as
    the kernel's ``compose`` rounds it (product, then sum)."""
    return A * x, A * y + B


def chunked_reference(
    a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor],
    chunk: int = L, sub: int = SUB, *, reach: str = "near", seed: int = 0,
) -> torch.Tensor:
    """h of ``(N, T, D)`` operands as the chunked kernel computes it, in
    float32, rounded once to the inputs' dtype.

    ``reach`` says where each chunk's look-back finds its nearest inclusive
    state: ``"near"`` its predecessor, ``"far"`` none (every aggregate back
    to ``h0``), ``"random"`` a seeded draw. The look-back folds the
    aggregates in between latest first, whatever rounds its reads took."""
    dtype = b.dtype
    a, b = a.float(), b.float()
    N, T, D = b.shape
    warps = chunk // sub
    chunks = -(-T // chunk)
    pad = chunks * chunk - T
    # a ragged last chunk: a = 1, b = 0
    a = torch.cat([a, torch.ones(N, pad, D)], dim=1)
    b = torch.cat([b, torch.zeros(N, pad, D)], dim=1)
    a = a.reshape(N, chunks, warps, sub, D)
    b = b.reshape(N, chunks, warps, sub, D)
    # phase 1: each warp's pair over its steps, in time order
    wa, wb = torch.ones(N, chunks, warps, D), torch.zeros(N, chunks, warps, D)
    for s in range(sub):
        wa, wb = _compose(a[:, :, :, s], b[:, :, :, s], wa, wb)
    # the block's pair: later warps apply after earlier ones
    Ac, Bc = torch.ones(N, chunks, D), torch.zeros(N, chunks, D)
    for w in reversed(range(warps)):
        Ac, Bc = _compose(Ac, Bc, wa[:, :, w], wb[:, :, w])
    # phase 2: the carry-in of each chunk
    start = torch.zeros(N, D) if h0 is None else h0.float()
    rng = np.random.default_rng(seed) if reach == "random" else None
    carry = [start]
    incl = [Ac[:, 0] * start + Bc[:, 0]]
    for c in range(1, chunks):
        distance = {"near": 1, "far": c + 1}.get(reach)
        if distance is None:
            distance = int(rng.integers(1, c + 2))
        RA, RB = torch.ones(N, D), torch.zeros(N, D)
        nxt = c - 1
        for _ in range(distance - 1):
            RA, RB = _compose(RA, RB, Ac[:, nxt], Bc[:, nxt])
            nxt -= 1
        h_in = start if nxt < 0 else incl[nxt]
        carry.append(RA * h_in + RB)
        incl.append(Ac[:, c] * carry[c] + Bc[:, c])
    # phase 3: each warp folds the carry through the earlier warps, then
    # re-walks its steps
    out = torch.empty(N, chunks, warps, sub, D)
    for c in range(chunks):
        for w in range(warps):
            hs = carry[c]
            for v in range(w):
                hs = wa[:, c, v] * hs + wb[:, c, v]
            for s in range(sub):
                hs = a[:, c, w, s] * hs + b[:, c, w, s]
                out[:, c, w, s] = hs
    return out.reshape(N, chunks * chunk, D)[:, :T].to(dtype)


def _ssd_input(rng, shape, with_h0):
    a = rng.uniform(0.6, 1.0, size=shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h0 = (rng.standard_normal(shape[:-2] + shape[-1:]).astype(np.float32)
          if with_h0 else None)
    return a, b, h0


@pytest.mark.parametrize("T", [1, L - 1, L, L + 1, 3 * L + 5])
@pytest.mark.parametrize("D", [1, 3, 4, 130])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_arithmetic_matches_both_references(T, D, with_h0):
    rng = np.random.default_rng(T * 1000 + D)
    a, b, h0 = _ssd_input(rng, (2, T, D), with_h0)
    (ja, jb), (ta, tb) = to_both((a, b))
    jh0, th0 = to_both(h0) if with_h0 else (None, None)
    wants = {pallas: j_ssd(ja, jb, jh0, force_pallas=pallas)[0]
             for pallas in (False, True)}
    plain = tref.ref_ssd_scan(ta, tb, th0)[0].numpy()
    for reach in ("near", "far", "random"):
        got = chunked_reference(ta, tb, th0, reach=reach, seed=T + D)
        what = f"T={T} D={D} h0={with_h0} reach={reach}"
        for pallas, want in wants.items():
            assert_same(want, got, rtol=TOL, atol=TOL,
                        what=f"{what} pallas={pallas}")
        np.testing.assert_allclose(got.numpy(), plain, rtol=TOL, atol=TOL,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_chunked_arithmetic_in_half_types(dtype):
    """bf16 / fp16 operands: float32 state, h rounded once, as the port's
    plain version does; one rounding step of the output type apart at most."""
    rng = np.random.default_rng(11)
    a, b, h0 = (torch.from_numpy(v).to(dtype)
                for v in _ssd_input(rng, (2, 3 * L + 5, 130), True))
    got = chunked_reference(a, b, h0, reach="random", seed=3)
    want = tref.ref_ssd_scan(a, b, h0)[0]
    assert got.dtype == dtype
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=step, atol=step)


@pytest.mark.parametrize("T", [1, L - 1, L + 1, 2 * L, 70 * L + 3, 4096])
@pytest.mark.parametrize("reach", ["near", "far", "random"])
def test_exact_case_counts_every_step_once(T, reach):
    """a = b = 1: h_t = t + 1 + h0, an integer exact in float32. Every carry
    that the look-back drops or folds twice moves it by a chunk's length."""
    N, D = 2, 5
    a = torch.ones(N, T, D)
    h0 = torch.arange(N * D, dtype=torch.float32).reshape(N, D) - 3
    want = torch.arange(1, T + 1, dtype=torch.float32)[None, :, None] + h0[:, None]
    got = chunked_reference(a, a, h0, reach=reach, seed=T)
    assert torch.equal(got, want)
    assert torch.equal(ops.ssd_scan(a, a, h0)[0], want)
    jh, _ = j_ssd(*to_both((a.numpy(), a.numpy(), h0.numpy()))[0])
    np.testing.assert_array_equal(np.asarray(jh), want.numpy())


# ---------------------------------------------------------------------------
# ops.ssd_scan: h0 broadcasts as the reference's h0[..., None, :]
# ---------------------------------------------------------------------------

H0_SHAPES = [(4,), (1,), (3, 4), (1, 4), (2, 1, 4), (1, 3, 4), (2, 3, 1),
             (2, 3, 4), (3, 2, 4), (5, 2, 3, 4), (1, 2, 3, 4), ()]


@pytest.mark.parametrize("h0_shape", H0_SHAPES, ids=str)
@pytest.mark.parametrize("force_pallas", [False, True])
def test_h0_broadcasts_like_the_reference(h0_shape, force_pallas):
    """a, b of (2, 3, 16, 4): the port's result has the reference's shape and
    values, or both raise (the reference TypeError / IndexError, the port
    ValueError)."""
    rng = np.random.default_rng(len(h0_shape))
    a, b, _ = _ssd_input(rng, (2, 3, 16, 4), False)
    h0 = np.asarray(rng.standard_normal(h0_shape), dtype=np.float32)
    (ja, jb, jh0), (ta, tb) = to_both((a, b, h0))[0], to_both((a, b))[1]
    th0 = torch.from_numpy(h0.copy())  # 0-d stays 0-d
    try:
        want = j_ssd(ja, jb, jh0, force_pallas=force_pallas)
    except (TypeError, IndexError, ValueError):
        want = None
    if want is None:
        with pytest.raises(ValueError):
            ops.ssd_scan(ta, tb, th0)
        return
    got = ops.ssd_scan(ta, tb, th0)
    assert_same(want, got, rtol=TOL, atol=TOL, what=f"h0 {h0_shape}")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [1, L, 2 * L - 1, 2 * L, 2 * L + 1, 4096])
def test_plan_path_follows_the_number_of_chunks(dtype, T):
    plan = K4.plan_launch(8, T, 1536, dtype)
    assert plan.path == ("chunked" if T >= 2 * L else "column")
    assert plan.launches == 1


def test_plan_at_mamba2_130m_width():
    """(8, 4096, 1536) float32: 256-feature tiles (two warps of 16-byte
    loads) of 64 steps, 8 * 6 * 64 blocks of 256 threads; bf16 loads 8
    values at once, so 512-feature tiles."""
    plan = K4.plan_launch(8, 4096, 1536, torch.float32, (0, 256, 1 << 20))
    assert (plan.path, plan.vec, plan.d_tile, plan.chunk) == ("chunked", 4, 256, 64)
    assert (plan.chunks, plan.blocks, plan.threads) == (64, 8 * 6 * 64, 256)
    # a status word for each (tile, feature warp), three floats a feature
    assert plan.status_words == K4.HEAD_WORDS + plan.blocks * 2
    assert plan.value_floats == 3 * 256 * plan.blocks
    half = K4.plan_launch(8, 4096, 1536, torch.bfloat16, (0, 256, 1 << 20))
    assert (half.vec, half.d_tile, half.blocks) == (8, 512, 8 * 3 * 64)


@pytest.mark.parametrize("N,T,D", [(1, 2 * L, 1), (2, 3 * L + 5, 3),
                                   (2, 3 * L + 5, 130), (3, 4096, 1536),
                                   (1, 10000, 48)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_grid_covers_every_tile_once(N, T, D, dtype):
    plan = K4.plan_launch(N, T, D, dtype)
    assert plan.d_tile == 32 * plan.vec * K4.FEATURE_WARPS
    assert plan.chunks == -(-T // L)
    assert plan.blocks == N * -(-D // plan.d_tile) * plan.chunks
    # the last tile of a column starts inside it, and the tiles cover D
    assert (plan.chunks - 1) * plan.chunk < T <= plan.chunks * plan.chunk
    assert plan.blocks < 2 ** 31


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_vector_width_follows_alignment_and_ragged_d(dtype):
    """16-byte loads: 4 floats or 8 bf16 / fp16 values a thread, so tiles of
    256 or 512 features over two warps; one value a thread (64 features)
    where D or a pointer does not allow them."""
    size = dtype.itemsize
    vec = 16 // size
    warps = K4.FEATURE_WARPS
    aligned = (0, 1 << 12, 1 << 20)
    plan = K4.plan_launch(2, 4096, 256, dtype, aligned)
    assert (plan.vec, plan.d_tile) == (vec, 32 * vec * warps)
    # D no multiple of the vector: one value a thread
    ragged = K4.plan_launch(2, 4096, 258, dtype, aligned)
    assert (ragged.vec, ragged.d_tile) == (1, 32 * warps)
    # a view one element in: one pointer off the vector's alignment
    for i in range(3):
        ptrs = list(aligned)
        ptrs[i] += size
        assert K4.plan_launch(2, 4096, 256, dtype, ptrs).vec == 1
    # every pointer must sit on 16 bytes, not only on the type's size
    assert K4.plan_launch(2, 4096, 256, dtype, (8,) * 3).vec == 1


def test_plan_named_paths_for_comparisons():
    column = K4.plan_launch(8, 4096, 1536, torch.float32, path="column")
    assert (column.path, column.vec, column.d_tile, column.chunk) == (
        "column", 1, K4.COLUMN_THREADS, 4096)
    assert column.blocks == 8 * 1536 // K4.COLUMN_THREADS
    assert column.status_words == column.value_floats == 0
    with pytest.raises(ValueError):
        K4.plan_launch(8, 2 * L - 1, 64, torch.float32, path="chunked")
    with pytest.raises(ValueError):
        K4.plan_launch(8, 4096, 64, torch.float32, path="rows")


def test_plan_rejects_what_no_kernel_takes():
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(ValueError):
            K4.plan_launch(1, 4096, 64, dtype)


def test_cpu_calls_launch_nothing():
    before = (K4.launches, dict(K4.path_launches))
    a = torch.full((2, 4096, 8), 0.5)
    h = K4.ssd_rows(a, a, torch.ones(2, 8))
    assert torch.equal(h, tref.ref_ssd_scan(a, a, torch.ones(2, 8))[0])
    ops.ssd_scan(a, a)
    assert (K4.launches, dict(K4.path_launches)) == before
