"""Parity of ``repro_torch.kernels`` (K3 prefix scan, K4 SSD scan, K5 flash
attention, their wrappers and plain versions) with ``repro.kernels``.

The CUDA kernels run only on a GPU (``chip_smoke.py`` holds each against its
plain version there). Here the port's public wrappers, given CPU tensors, run
the plain versions, which are held against the reference's kernels in Pallas
interpret mode (``force_pallas=True``, as ``tests/test_kernels.py`` runs
them) and against the reference's ``ref`` oracles. Inputs are normal or
uniform draws from a seeded numpy generator, never subnormals.

Tolerances are the reference suite's: K3 1e-4 for float32 add/mul, bitwise
for max and for int32 add, 2.5e-1 for bfloat16 add; K4 2e-3; K5 2e-3 in
float32 and 2e-2 in bfloat16 (one bf16 rounding of the output). The port's
plain K4 folds ``h0`` in after the scan, as the reference does; the CUDA
kernel starts its recurrence from ``h0`` instead (the same function up to
rounding) and is held to the plain version on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import flash_attention as j_flash
from repro.kernels.ops import prefix_scan as j_scan
from repro.kernels.ops import ssd_scan as j_ssd
from repro_torch.kernels import flash_attention as t_flash
from repro_torch.kernels import prefix_scan as t_scan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as t_ssd
from test_torch_interop import BF16, assert_same, to_both

K3 = importlib.import_module("repro_torch.kernels.prefix_scan")
K4 = importlib.import_module("repro_torch.kernels.ssd_scan")
K5 = importlib.import_module("repro_torch.kernels.flash_attention")

SCAN_SHAPES = [(1, 1), (3, 257), (2, 1000), (2, 3, 64)]


def _scan_input(rng, shape, op, dtype=np.float32):
    if dtype == np.int32:
        return rng.integers(-(1 << 30), 1 << 30, size=shape).astype(np.int32)
    if op == "mul":
        x = rng.uniform(0.5, 1.5, size=shape)
    else:
        x = rng.standard_normal(shape)
    return x.astype(np.float32).astype(dtype)


# ---------------------------------------------------------------------------
# K3: prefix scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("op", ["add", "max", "mul"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_matches_reference_kernel(shape, op, exclusive):
    rng = np.random.default_rng(SCAN_SHAPES.index(shape) * 10 + len(op))
    x = _scan_input(rng, shape, op)
    jx, tx = to_both(x)
    want = j_scan(jx, op=op, exclusive=exclusive, force_pallas=True)
    got = t_scan(tx, op=op, exclusive=exclusive)
    tol = 0.0 if op == "max" else 1e-4
    assert_same(want, got, rtol=tol, atol=tol, what=f"{shape} {op} {exclusive}")


@pytest.mark.parametrize("case", [
    ("add", np.int32, False), ("add", np.int32, True), ("max", np.int32, True),
    ("add", BF16, False),
])
def test_prefix_scan_dtypes_match_reference_kernel(case):
    op, dtype, exclusive = case
    rng = np.random.default_rng(3)
    x = _scan_input(rng, (8, 256), op, dtype)
    jx, tx = to_both(x)
    want = j_scan(jx, op=op, exclusive=exclusive, force_pallas=True)
    got = t_scan(tx, op=op, exclusive=exclusive)
    # int32 sums wrap identically; bf16: the reference rounds at every
    # combine, the port once per output
    tol = 2.5e-1 if dtype == BF16 else 0.0
    assert_same(want, got, rtol=tol, atol=tol, what=f"{op} {dtype}")


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int32])
@pytest.mark.parametrize("op", ["add", "max", "mul"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_plain_matches_reference_ref(dtype, op, exclusive):
    rng = np.random.default_rng(4)
    if dtype == np.int32 and op == "mul":
        x = rng.integers(-4, 4, size=(3, 40)).astype(np.int32)
    else:
        x = _scan_input(rng, (3, 40), op, dtype)
    jx, tx = to_both(x)
    want = jref.ref_prefix_scan(jx, op, exclusive=exclusive)
    got = tref.ref_prefix_scan(tx, op, exclusive=exclusive)
    tol = {np.float32: 1e-5, BF16: 2.5e-1, np.int32: 0.0}[dtype]
    if op == "max":
        tol = 0.0
    assert_same(want, got, rtol=tol, atol=tol, what=f"{dtype} {op}")


def test_prefix_scan_max_propagates_nan_like_the_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 50)).astype(np.float32)
    x[1, 7] = np.nan
    jx, tx = to_both(x)
    for exclusive in (False, True):
        want = j_scan(jx, op="max", exclusive=exclusive, force_pallas=True)
        got = t_scan(tx, op="max", exclusive=exclusive)
        assert_same(want, got, what=f"nan exclusive={exclusive}")
        assert np.isnan(np.asarray(got[1, 10]))


def test_prefix_scan_identities_are_the_references():
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert tref.scan_identity("max", dt) == torch.finfo(dt).min
    assert tref.scan_identity("max", torch.int32) == -(1 << 31)
    assert tref.scan_identity("max", torch.int8) == -128
    assert (tref.scan_identity("add", torch.int8),
            tref.scan_identity("mul", torch.int8)) == (0, 1)
    with pytest.raises(ValueError):
        tref.scan_identity("min", torch.float32)


def test_prefix_scan_integer_sums_wrap_in_their_type():
    x = torch.tensor([[2 ** 31 - 1, 1, 1]], dtype=torch.int32)
    got = t_scan(x, op="add")
    assert got.dtype == torch.int32
    assert got.tolist() == [[2 ** 31 - 1, -(2 ** 31), -(2 ** 31) + 1]]
    x8 = torch.tensor([[100, 100, -128]], dtype=torch.int8)
    assert t_scan(x8, op="add").tolist() == [[100, -56, 72]]


def test_prefix_scan_rows_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        K3.scan_rows(torch.zeros(2, 3, 4))
    # a meta tensor takes the plain version (shapes alone, for a counted
    # dry run): nothing launched
    before = K3.launches
    got = K3.scan_rows(torch.zeros(2, 3, device="meta"), reverse=True)
    assert got.device.type == "meta" and got.shape == (2, 3)
    assert K3.launches == before
    with pytest.raises(ValueError):
        t_scan(torch.zeros(()))
    assert [K3.block_threads(n) for n in (1, 128, 129, 1024, 10 ** 6)] == [
        32, 32, 64, 256, 256]


def test_prefix_scan_ignores_block_hints():
    x = torch.randn(4, 300, generator=torch.Generator().manual_seed(0))
    a = t_scan(x, block_rows=8, block_len=128)
    b = t_scan(x, block_rows=256, block_len=512)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K4: SSD scan
# ---------------------------------------------------------------------------


def _ssd_input(rng, shape, with_h0):
    a = rng.uniform(0.6, 1.0, size=shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    h0 = (rng.standard_normal(shape[:-2] + shape[-1:]).astype(np.float32)
          if with_h0 else None)
    return a, b, h0


@pytest.mark.parametrize("shape", [(2, 64, 8), (1, 300, 4), (3, 128, 16),
                                   (1, 1, 2), (2, 2, 37, 3)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_reference_kernel(shape, with_h0):
    rng = np.random.default_rng(len(shape) * 100 + shape[-2])
    a, b, h0 = _ssd_input(rng, shape, with_h0)
    (ja, jb), (ta, tb) = to_both((a, b))
    jh0, th0 = to_both(h0) if with_h0 else (None, None)
    want = j_ssd(ja, jb, jh0, force_pallas=True)
    got = t_ssd(ta, tb, th0)
    assert_same(want, got, rtol=2e-3, atol=2e-3, what=f"{shape} h0={with_h0}")


def test_ssd_scan_plain_matches_a_python_loop():
    """The plain version against the recurrence written out."""
    rng = np.random.default_rng(7)
    a, b, h0 = _ssd_input(rng, (2, 37, 3), True)
    h = h0.copy()
    hs = []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        hs.append(h.copy())
    want = np.stack(hs, axis=1)
    got, last = tref.ref_ssd_scan(*(torch.from_numpy(v) for v in (a, b, h0)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(last.numpy(), got.numpy()[:, -1])


def test_ssd_scan_bf16_plain_matches_reference_ref():
    rng = np.random.default_rng(8)
    a, b, h0 = _ssd_input(rng, (2, 50, 4), True)
    (ja, jb, jh0), (ta, tb, th0) = to_both(tuple(v.astype(BF16) for v in (a, b, h0)))
    want = jref.ref_ssd_scan(ja, jb, jh0)
    got = tref.ref_ssd_scan(ta, tb, th0)
    # the reference rounds every combine to bf16, the port once per output
    assert_same(want, got, rtol=5e-2, atol=5e-2, what="ssd bf16")


def test_chunk_state_plain_matches_reference_ref():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 10, 4)).astype(np.float32)
    B = rng.standard_normal((2, 3, 10, 5)).astype(np.float32)
    (jx, jB), (tx, tB) = to_both((x, B))
    want = jref.ref_chunk_state(None, jx, jB)
    got = tref.ref_chunk_state(None, tx, tB)
    assert_same(want, got, rtol=1e-5, atol=1e-5, what="chunk state")


def test_ssd_rows_wrapper_checks_its_input():
    a = torch.ones(2, 3, 4)
    with pytest.raises(ValueError):
        K4.ssd_rows(a, torch.ones(2, 3, 5))
    with pytest.raises(ValueError):
        K4.ssd_rows(a, a, torch.ones(2, 3))
    # a meta tensor takes the plain version: nothing launched
    before = K4.launches
    got = K4.ssd_rows(a.to("meta"), a.to("meta"))
    assert got.device.type == "meta" and got.shape == a.shape
    assert K4.launches == before
    with pytest.raises(ValueError):
        t_ssd(torch.ones(3), torch.ones(3))


# ---------------------------------------------------------------------------
# K5: flash attention
# ---------------------------------------------------------------------------


def _qkv(rng, BH, Sq, Skv, D, dtype=np.float32):
    q = rng.standard_normal((BH, Sq, D)).astype(np.float32).astype(dtype)
    k = rng.standard_normal((BH, Skv, D)).astype(np.float32).astype(dtype)
    v = rng.standard_normal((BH, Skv, D)).astype(np.float32).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("case", [
    # (BH, Sq, Skv, D, causal, window, q_offset)
    (2, 128, 128, 64, True, 0, 0),
    (2, 128, 128, 64, False, 0, 0),
    (1, 100, 260, 32, True, 0, 160),
    (1, 100, 260, 32, False, 0, 0),
    (2, 1, 300, 64, True, 0, 299),
    (2, 128, 128, 64, True, 16, 0),
    (1, 64, 200, 128, False, 64, 100),
])
def test_flash_attention_matches_reference_kernel(case):
    BH, Sq, Skv, D, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case))
    q, k, v = _qkv(rng, BH, Sq, Skv, D)
    (jq, jk, jv), (tq, tk, tv) = to_both((q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = j_flash(jq, jk, jv, force_pallas=True, **kw)
    got = t_flash(tq, tk, tv, **kw)
    assert_same(want, got, rtol=2e-3, atol=2e-3, what=str(case))


@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_flash_attention_plain_matches_reference_ref(dtype):
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 3, 40, 90, 32, dtype)
    (jq, jk, jv), (tq, tk, tv) = to_both((q, k, v))
    for kw in (dict(causal=True, q_offset=50), dict(causal=False, window=8),
               dict(causal=True, kv_len=70, q_offset=30)):
        want = jref.ref_flash_attention(jq, jk, jv, **kw)
        got = tref.ref_flash_attention(tq, tk, tv, **kw)
        tol = 2e-3 if dtype == np.float32 else 2e-2
        assert_same(want, got, rtol=tol, atol=tol, what=f"{dtype} {kw}")


def test_flash_attention_fully_masked_rows_average_v_like_the_reference():
    """A row that sees no key gets softmax over -1e30 scores: the mean of v
    over every key (masked scores are -1e30, not -inf)."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, 1, 4, 6, 32)
    (jq, jk, jv), (tq, tk, tv) = to_both((q, k, v))
    want = jref.ref_flash_attention(jq, jk, jv, causal=True, q_offset=-3)
    got = t_flash(tq, tk, tv, causal=True, q_offset=-3)
    assert_same(want, got, rtol=2e-3, atol=2e-3, what="masked rows")
    np.testing.assert_allclose(np.asarray(got[0, 0]), v[0].mean(0), atol=1e-6)


def test_flash_attention_wrapper_checks_its_input():
    q = torch.ones(2, 4, 32)
    with pytest.raises(ValueError):
        K5.attention(q, torch.ones(2, 4, 16), torch.ones(2, 4, 16))
    with pytest.raises(ValueError):
        K5.attention(q, torch.ones(2, 0, 32), torch.ones(2, 0, 32))
    # a meta tensor takes the plain version: nothing launched
    before = K5.launches
    got = K5.attention(q.to("meta"), q.to("meta"), q.to("meta"))
    assert got.device.type == "meta" and got.shape == q.shape
    assert K5.launches == before
    out = t_flash(q, q, q, block_q=16, block_kv=16)
    assert out.shape == q.shape and out.dtype == q.dtype


# ---------------------------------------------------------------------------
# the package
# ---------------------------------------------------------------------------


def test_package_exports_the_reference_entry_points():
    import repro.kernels as jk
    import repro_torch.kernels as tk

    for name in ("prefix_scan", "ssd_scan", "flash_attention"):
        assert callable(getattr(jk, name)) and callable(getattr(tk, name))
    assert tk.SOURCES == ("fused_collective", "spmd_collective",
                          "prefix_scan", "ssd_scan", "flash_attention")
    for mod in (K3, K4, K5):
        assert mod.launches == 0  # CPU tensors never launch a kernel


def test_entry_points_keep_the_reference_layouts():
    """Mamba's within-chunk scan (B, nc, H, Q) and MoE's exclusive expert
    offsets (1, E) int32, at small size."""
    rng = np.random.default_rng(13)
    seg = -np.abs(rng.standard_normal((2, 3, 4, 16))).astype(np.float32)
    counts = rng.integers(0, 9, size=(1, 8)).astype(np.int32)
    for x, kw, tol in ((seg, {}, 1e-4),
                       (counts, dict(op="add", exclusive=True), 0.0)):
        jx, tx = to_both(x)
        want = j_scan(jx, force_pallas=True, **kw)
        got = t_scan(tx, **kw)
        assert_same(want, got, rtol=tol, atol=tol, what=str(x.shape))
