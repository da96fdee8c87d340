"""K1's packed launch (``fused_collective.pack_call``, the C entry
``k1_fused_packed``). On the CPU: which plans lower to one packed launch,
and the code word against the C entry's layout. On the card alone (``-m
card``): a stacked schedule of one comm phase launches K1 straight from a
packed call, bitwise the unpacked entry ``k1_fused_comm`` with the same
plan, one launch a call, a fresh result each call, on the stream current at
the call (a CUDA graph's capture too); the phase loop's one-leaf launches
take the packed entry too. The CPU tests of the prepared dispatch above it
are ``tests/test_torch_engine_prepared.py``.
"""

import ctypes

import pytest
import torch

from repro_torch.core.operators import get_operator
from repro_torch.kernels import fused_collective as tfc
from repro_torch.obs import tracing as ttracing
from repro_torch.offload import OffloadEngine
from repro_torch.offload.planner import PhaseKind
from repro_torch.roofline.op_cost import CostMode

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 runs only there")
    return torch.device("cuda", torch.cuda.current_device())


def engine_plan(coll, axes, nbytes=4096):
    """The plan the engine lowers for a fused-backend request of one chunk,
    as the osu8 cell makes it."""
    eng = OffloadEngine(device="cpu")
    desc = eng.make_descriptor(coll, axes=axes, payload_bytes=nbytes,
                               backend="pallas", chunks=1)
    return eng._plan_for(desc)[0]


def lowering(coll, p, device):
    return tfc.lower_fused(engine_plan(coll, (1, p)), "sum", device=device)


def stacked(p, M, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((p, M), generator=gen, device=device)
    return (x * 8).to(dtype) if not dtype.is_floating_point else x.to(dtype)


def phase_loop(run, x):
    """The same schedule's phase loop: a ``CostMode`` bypasses the packed
    shortcut (it must see each K1 charge)."""
    with CostMode() as mode:
        got = run(x)
    assert [c.kind for c in mode.charges] == ["k1"]
    return got


def unpacked(coll, p, x):
    """K1 on ``x`` through its unpacked C entry ``k1_fused_comm``, planned
    as :func:`~repro_torch.kernels.fused_collective.plan_launch` plans the
    call: the reference the packed entry is held to, bitwise."""
    one = tfc.single_launch_phase(engine_plan(coll, (1, p)))
    M = x.shape[1]
    y = torch.empty_like(x)
    plan = tfc.plan_launch(one.kind, p, M, x.dtype, 1,
                           tfc.aligned_rows([x, y], M))
    scratch = None
    if plan.scratch:
        scratch = torch.empty(plan.scratch, dtype=x.dtype, device=x.device)
    made = ctypes.c_int(0)
    rc = tfc._library().k1_fused_comm(
        tfc._PATH_CODES[plan.path], tfc._KIND_CODES[one.kind],
        tfc._KERNEL_OPS[get_operator("sum").combine][0],
        tfc._DTYPE_CODES[x.dtype], int(one.inclusive), p, M, plan.p_max,
        plan.vec, plan.block, plan.smem_bytes, *tfc._pointers([x]),
        *tfc._pointers([y]), *tfc._pointers(None),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream, ctypes.byref(made))
    assert rc == 0 and made.value == 1
    return y


#: (field, first bit, bits) of k1_fused_packed's code word
LAYOUT = (("path", 0, 1), ("kind", 1, 2), ("op", 3, 3), ("dtype", 6, 3),
          ("inclusive", 9, 1), ("vec", 10, 5), ("p_max", 15, 5),
          ("block", 20, 9), ("smem_bytes", 29, 16), ("p", 45, 18))


def fields(code):
    return {name: code >> lo & ((1 << bits) - 1) for name, lo, bits in LAYOUT}


@pytest.mark.parametrize("coll,axes,packs", [
    ("SCAN", (1, 8), True), ("EXSCAN", (1, 8), True),
    ("ALLREDUCE", (1, 8), True), ("ALLREDUCE", (8, 1), True),
    ("SCAN", (1, 2), True), ("SCAN", (1, 16), True),
    ("SCAN", (8, 1), False), ("SCAN", (2, 4), False),
    ("REDUCE", (1, 8), False), ("BARRIER", (1, 8), False),
])
def test_plans_of_one_launch(coll, axes, packs):
    plan = engine_plan(coll, axes)
    assert (tfc.single_launch_phase(plan) is not None) == packs


@pytest.mark.parametrize("kind,p,M,dtype", [
    (PhaseKind.SCAN, 8, 1 << 24, torch.float32),
    (PhaseKind.SCAN, 16, 1001, torch.bfloat16),
    (PhaseKind.SCAN, 2, 4096, torch.int32),
    (PhaseKind.TOTAL, 8, 4096, torch.float16),
    (PhaseKind.SCAN, 64, 4096, torch.int8),
    (PhaseKind.SCAN, 4096, 1 << 12, torch.float32),
])
def test_the_code_word_holds_the_plan(kind, p, M, dtype):
    op = get_operator("max")
    call = tfc.pack_call(kind, p, op, False, (p, M), dtype)
    assert call.M == M
    for aligned, (plan, code) in enumerate(call.by_alignment):
        rows = aligned and (M * dtype.itemsize) % 16 == 0
        assert plan == tfc.plan_launch(kind, p, M, dtype, 1, rows)
        assert fields(code) == {
            "path": tfc._PATH_CODES[plan.path], "kind": tfc._KIND_CODES[kind],
            "op": tfc._KERNEL_OPS[op.combine][0],
            "dtype": tfc._DTYPE_CODES[dtype], "inclusive": 0,
            "vec": plan.vec, "p_max": plan.p_max, "block": plan.block,
            "smem_bytes": plan.smem_bytes, "p": p}
        assert code < 1 << 63


@pytest.mark.parametrize("case", ["fused_kind", "two_leaf_op", "rank_axis",
                                  "no_columns", "dtype"])
def test_calls_the_packed_entry_does_not_take(case):
    kind, op, shape, dtype = PhaseKind.SCAN, "sum", (8, 64), torch.float32
    if case == "fused_kind":
        kind = PhaseKind.FUSED_SCAN_TOTAL
    elif case == "two_leaf_op":
        op = "ssd"
    elif case == "rank_axis":
        shape = (4, 64)
    elif case == "no_columns":
        shape = (8, 0)
    else:
        dtype = torch.float64
    assert tfc.pack_call(kind, 8, get_operator(op), True, shape, dtype) is None


def test_a_named_path_is_packed_or_refused_as_planned():
    op = get_operator("sum")
    call = tfc.pack_call(PhaseKind.SCAN, 8, op, True, (8, 4096),
                         torch.float32, "column")
    for plan, code in call.by_alignment:
        assert plan.path == "column" and fields(code)["path"] == \
            tfc._PATH_CODES["column"]
    with pytest.raises(ValueError, match="no 'register' path for p=64"):
        tfc.pack_call(PhaseKind.SCAN, 64, op, True, (64, 4096),
                      torch.float32, "register")


@pytest.mark.card
@pytest.mark.parametrize("M", [4096, 1001], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("p", [2, 8, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_packed_launch_is_bitwise_the_phase_loop(card, dtype, p, M,
                                                  monkeypatch):
    run = lowering("SCAN", p, card)
    x = stacked(p, M, DTYPES[dtype], card)
    want = unpacked("SCAN", p, x)
    assert torch.equal(phase_loop(run, x), want)

    def refuse(*a, **kw):
        raise AssertionError("the packed call ran the phase loop's launch")

    monkeypatch.setattr(tfc, "_launch", refuse)
    before = tfc.launches
    got = run(x)
    torch.cuda.synchronize()
    assert tfc.launches == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("coll", ["EXSCAN", "ALLREDUCE"])
def test_exclusive_scan_and_butterfly_pack_too(card, coll):
    run = lowering(coll, 8, card)
    x = stacked(8, 4096, torch.float32, card)
    want = unpacked(coll, 8, x)
    assert torch.equal(phase_loop(run, x), want)
    before = tfc.launches
    got = run(x)
    torch.cuda.synchronize()
    assert tfc.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.card
def test_consecutive_calls_return_fresh_tensors(card):
    run = lowering("SCAN", 8, card)
    x = stacked(8, 4096, torch.float32, card)
    before = tfc.launches
    a, b = run(x), run(x)
    torch.cuda.synchronize()
    assert tfc.launches == before + 2
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    a.zero_()
    assert torch.equal(b, unpacked("SCAN", 8, x))


@pytest.mark.card
def test_a_graph_captured_on_a_side_stream_replays_the_call(card):
    run = lowering("SCAN", 8, card)
    x = stacked(8, 4096, torch.float32, card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(x)  # warm-up off the default stream, as capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(x)
    x2 = stacked(8, 4096, torch.float32, card, seed=1)
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, unpacked("SCAN", 8, x2))


@pytest.mark.card
@pytest.mark.parametrize("coll,axes,strided", [
    ("SCAN", (8, 1), False), ("EXSCAN", (8, 1), False),
    ("BARRIER", (1, 8), False), ("SCAN", (1, 8), True),
], ids=["scan_combine", "exscan_identity_combine", "barrier", "strided"])
def test_the_phase_loop_launches_one_leaf_through_the_packed_entry(
        card, coll, axes, strided, monkeypatch):
    plan = engine_plan(coll, axes)
    x = None
    if coll != "BARRIER":
        x = stacked(8, 4096, torch.int32, card)
        if strided:
            x = torch.empty((4096, 8), dtype=x.dtype, device=card).t() \
                .copy_(x)
            assert not x.is_contiguous()
        else:  # a loop of phases
            assert tfc.single_launch_phase(plan) is None
    # integer sums: the CPU's plain phases give the kernel's bits
    want = tfc.lower_fused(plan, "sum", device="cpu")(
        None if x is None else x.cpu())

    class Unpacked:
        """The unpacked C entry, which no launch here may take (its
        signature declared, as ``_library`` finds it)."""

        argtypes = ()

        def __call__(self, *a, **kw):
            raise AssertionError("a one-leaf launch took the unpacked entry")

    monkeypatch.setattr(tfc._library(), "k1_fused_comm", Unpacked())
    run = tfc.lower_fused(plan, "sum", device=card)
    before = tfc.launches
    got = run(x)
    torch.cuda.synchronize()
    assert tfc.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.card
def test_the_engine_repeat_runs_one_packed_launch(card, monkeypatch):
    eng = OffloadEngine(device=card)
    words = eng.make_descriptor("SCAN", axes=(1, 8), payload_bytes=4096 * 4,
                                backend="pallas", chunks=1).encode()
    x = stacked(8, 4096, torch.float32, card)
    want = eng.offload(words, x)
    monkeypatch.setattr(tfc, "_launch", None)  # the phase loop's launch
    before = tfc.launches
    reused = ttracing.span_totals().get("engine.reuse", (0, 0))[0]
    for _ in range(3):
        got = eng.offload(words, x)
    assert tfc.launches == before + 3
    assert ttracing.span_totals()["engine.reuse"][0] == reused + 3
    assert torch.equal(got, want)
