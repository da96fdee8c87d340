"""The launch plans of K1 (``fused_collective.plan_launch``) and K2
(``spmd_collective.plan_launch``), and K2's cluster protocol in plain
PyTorch.

The kernels run only on a GPU (``chip_smoke.py`` holds them against their
plain versions there and holds each path's launches to these plans). Here
the plans are checked for what the card needs of them: the path by rank
count, VEC and alignment, grids within CUDA's limits, shared memory within
a CTA's 232,448 bytes, one receive slot per exchange.

:func:`cluster_protocol` is K2's cluster path written out for ``p`` ranks:
each rank (a CTA of the cluster) owns one receive slot per exchange, every
put goes into ``slot[partner][exchange]``, and every rank then reads its
own slot, in the kernel's order of puts, waits and combines. The test holds
that each slot is written exactly once and read exactly once per launch,
and that the result is bitwise the plain version's
(``comm_phase_spmd_plain``) and the reference kernel's
(``repro.kernels.pallas_collective._spmd_comm_kernel`` in Pallas interpret
mode under ``shard_map`` on 16 forced host devices, in a subprocess), for
SCAN and FUSED_SCAN_TOTAL inclusive and exclusive, TOTAL and BARRIER at
p = 2, 4, 8 and 16, and SCAN at p = 3 and 6; and, where operand order
shows, over the non-commutative SSD operator at p = 3, 4 and 8.
"""

import os
import pickle
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.core import algorithms as alg
from repro_torch.core import operators as t_ops
from repro_torch.core.trees import tree_flatten, tree_unflatten
from repro_torch.interop import payload_from_numpy
from repro_torch.kernels import fused_collective as tfc
from repro_torch.kernels import spmd_collective as tsc
from repro_torch.offload.planner import PhaseKind as TK

REPO = Path(__file__).resolve().parents[1]

FORMS = [(TK.SCAN, True), (TK.SCAN, False), (TK.FUSED_SCAN_TOTAL, True),
         (TK.FUSED_SCAN_TOTAL, False), (TK.TOTAL, True), (TK.BARRIER, True)]
#: leaves of each operator the kernels combine
OPS = {"sum": 1, "prod": 1, "max": 1, "min": 1, "ssd": 2, "flash": 3}
DTYPES = (torch.int32, torch.float32, torch.bfloat16, torch.float16,
          torch.int8)
#: the most shared memory a CTA can use on an H100 (227 KiB)
SMEM_MAX = 232_448
GRID_X_MAX = 2**31 - 1
#: bytes per rank: DDP's 25 MiB bucket, and far beyond it
LARGE = (25 << 20, 1 << 30)


def _combos():
    """(op, n_leaves, dtype) the kernels take: 2- and 3-leaf operators only
    over floating types."""
    return [(op, n, dt) for op, n in OPS.items() for dt in DTYPES
            if n == 1 or dt.is_floating_point]


def _pow2(p):
    return p & (p - 1) == 0


def _form_id(i):
    kind, inclusive = FORMS[i]
    return f"{kind.name}-{inclusive}"


# ---------------------------------------------------------------------------
# K1's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", range(len(FORMS)), ids=_form_id)
def test_k1_plan_path_by_rank_count(form):
    kind, _ = FORMS[form]
    for p in (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 32, 64, 500):
        if kind in (TK.TOTAL, TK.BARRIER) and not _pow2(p):
            continue
        plan = tfc.plan_launch(kind, p, 1000, torch.float32, 1, True)
        if 2 <= p <= 16:
            assert plan.path == "register", p
            assert plan.p_max in tfc.REGISTER_P_MAX and plan.p_max >= p
            assert plan.p_max // 2 < p  # the smallest instance that holds p
            assert plan.block == tfc.REGISTER_THREADS and plan.smem_bytes == 0
            assert plan.scratch == 0
        else:
            assert plan.path == "column", p
            assert plan.p_max == 0 and plan.vec == 1
        assert plan.launches == 1
    assert tfc.plan_launch(kind, 8, 0, torch.float32, 1, True).launches == 0


@pytest.mark.parametrize("form", range(len(FORMS)), ids=_form_id)
def test_k1_plan_vec_is_16_bytes_shrunk_to_the_register_budget(form):
    kind, _ = FORMS[form]
    streams = 2 if kind == TK.FUSED_SCAN_TOTAL else 1
    for op, n, dtype in _combos():
        for p in (2, 3, 4, 8, 16):
            plan = tfc.plan_launch(kind, p, 4096, dtype, n, True)
            vec, item = plan.vec, dtype.itemsize
            assert vec >= 1 and vec & (vec - 1) == 0
            assert vec * item <= 16
            assert vec == 1 or streams * n * plan.p_max * vec <= tfc.REGISTER_BUDGET
            # the largest such VEC: doubling it would pass 16 bytes or the budget
            assert (2 * vec * item > 16
                    or streams * n * plan.p_max * 2 * vec > tfc.REGISTER_BUDGET)
            # rows off 16-byte alignment take the VEC = 1 instance
            assert tfc.plan_launch(kind, p, 4096, dtype, n, False).vec == 1


def test_k1_plan_vec_at_the_named_shapes():
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    def vec(kind, p, dtype, n=1):
        return tfc.plan_launch(kind, p, 1 << 16, dtype, n, True).vec

    assert vec(TK.SCAN, 8, f32) == 4            # the headline: 16-byte loads
    assert vec(TK.SCAN, 16, f32) == 4
    assert vec(TK.TOTAL, 8, f32) == 4
    assert vec(TK.SCAN, 8, bf16) == 8
    assert vec(TK.SCAN, 8, i8) == 16
    assert vec(TK.SCAN, 16, i8) == 8           # 256 int8 values would spill
    assert vec(TK.FUSED_SCAN_TOTAL, 16, f32) == 4
    assert vec(TK.FUSED_SCAN_TOTAL, 16, f32, 2) == 2   # SSD
    assert vec(TK.FUSED_SCAN_TOTAL, 16, f32, 3) == 1   # flash
    assert vec(TK.SCAN, 16, f32, 3) == 2


def test_k1_plan_alignment_follows_the_rows():
    x = torch.zeros(8 * 1000 + 1)
    aligned = x[:8000].view(8, 1000)
    offset = x[1:].view(8, 1000)
    assert tfc.aligned_rows([aligned], 1000)
    assert not tfc.aligned_rows([offset], 1000)
    assert not tfc.aligned_rows([aligned], 999)  # 3996-byte rows
    assert not tfc.aligned_rows([torch.zeros(8, 1001, dtype=torch.int8)], 1001)


@pytest.mark.parametrize("nbytes", LARGE)
def test_k1_plan_grid_covers_the_columns_within_cuda_limits(nbytes):
    for kind, _ in FORMS:
        for op, n, dtype in _combos():
            for p in (8, 16, 64):
                if kind in (TK.TOTAL, TK.BARRIER) and not _pow2(p):
                    continue
                M = nbytes // dtype.itemsize
                for aligned in (True, False):
                    plan = tfc.plan_launch(kind, p, M, dtype, n, aligned)
                    per_block = plan.block * plan.vec
                    assert 1 <= plan.grid <= GRID_X_MAX
                    assert plan.grid * per_block >= M > (plan.grid - 1) * per_block


def test_k1_plan_column_path_keeps_pr13_buffers():
    f32 = torch.float32
    plan = tfc.plan_launch(TK.SCAN, 64, 1000, f32, 1, True)
    assert (plan.block, plan.smem_bytes, plan.scratch) == (128, 32768, 0)
    plan = tfc.plan_launch(TK.FUSED_SCAN_TOTAL, 500, 1000, f32, 3, True)
    assert plan.smem_bytes == 0 and plan.scratch == 2 * 3 * 500 * 1000
    # a comparison may name the column path at p <= 16
    plan = tfc.plan_launch(TK.SCAN, 8, 1000, f32, 1, True, path="column")
    assert plan.path == "column" and plan.smem_bytes == 8 * 256 * 4


def test_k1_plan_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError, match="register"):
        tfc.plan_launch(TK.SCAN, 32, 10, torch.float32, 1, True, path="register")
    with pytest.raises(ValueError, match="register"):
        tfc.plan_launch(TK.SCAN, 1, 10, torch.float32, 1, True, path="register")
    with pytest.raises(ValueError, match="takes"):
        tfc.plan_launch(TK.SCAN, 8, 10, torch.float64, 1, True)


# ---------------------------------------------------------------------------
# K2's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", range(len(FORMS)), ids=_form_id)
def test_k2_plan_path_and_cluster_by_rank_count(form):
    kind, inclusive = FORMS[form]
    for p in (1, 2, 3, 6, 8, 12, 16, 17, 32, 64):
        if kind in (TK.TOTAL, TK.BARRIER) and not _pow2(p):
            continue
        plan = tsc.plan_launch(kind, p, 1000, torch.float32, 1,
                               inclusive=inclusive)
        if 2 <= p <= 16:
            assert plan.path == "cluster", p
            assert plan.cluster == (p, 1, 1)
            assert plan.tile == tsc.CLUSTER_THREADS * 4 * 4  # V = 4 float32
            assert plan.grid == (p * -(-1000 // plan.tile), 1, 1)
        else:
            assert plan.path == "flags", p
            assert plan.cluster == (1, 1, 1) and plan.shared_bytes == 0
            assert plan.grid == (-(-1000 // tsc.FLAGS_TILE), p, 1)
        assert plan.launches == 1


@pytest.mark.parametrize("form", range(len(FORMS)), ids=_form_id)
def test_k2_plan_has_one_slot_per_exchange(form):
    kind, inclusive = FORMS[form]
    for p in (2, 3, 4, 5, 6, 8, 12, 16, 32):
        if kind in (TK.TOTAL, TK.BARRIER) and not _pow2(p):
            continue
        for op, n, dtype in _combos():
            plan = tsc.plan_launch(kind, p, 4096, dtype, n, inclusive=inclusive)
            assert plan.slots == tsc.exchanges(kind, p, inclusive)
            if plan.path == "cluster":
                # the barriers, then a slot a leaf and exchange, each a
                # rank row of the tile
                barriers = -(-8 * plan.slots // 16) * 16
                row = plan.tile * dtype.itemsize
                assert row == tsc.CLUSTER_THREADS * 16 * tsc.cluster_row_vecs(
                    dtype.itemsize, n)
                assert plan.shared_bytes == barriers + plan.slots * n * row


@pytest.mark.parametrize("form", range(len(FORMS)), ids=_form_id)
def test_k2_plan_shared_memory_fits_every_operator_at_p16(form):
    kind, inclusive = FORMS[form]
    for op, n, dtype in _combos():
        plan = tsc.plan_launch(kind, 16, 1 << 20, dtype, n, inclusive=inclusive)
        assert plan.path == "cluster"
        assert plan.shared_bytes <= SMEM_MAX
        # room for more than one CTA on an SM, so a GPC holds several
        # 16-CTA clusters
        assert 2 * plan.shared_bytes <= SMEM_MAX


def test_k2_plan_row_vecs():
    """V: 4 vectors a thread where shared memory and registers allow."""
    assert tsc.cluster_row_vecs(4, 1) == 4   # float32, int32
    assert tsc.cluster_row_vecs(2, 1) == 4   # bf16, fp16
    assert tsc.cluster_row_vecs(1, 1) == 2   # int8: 16 elements a vector
    assert tsc.cluster_row_vecs(4, 2) == 2   # SSD
    assert tsc.cluster_row_vecs(4, 3) == 2   # flash
    assert tsc.cluster_row_vecs(2, 3) == 1
    for item in (1, 2, 4):
        for n in (1, 2, 3):
            v = tsc.cluster_row_vecs(item, n)
            assert v == 1 or (n * v <= 6 and 3 * n * (16 // item) * v <= 96)


def test_k2_plan_largest_case_is_fused_flash_at_p16():
    sizes = [tsc.plan_launch(kind, 16, 1 << 20, dt, n, inclusive=inc).shared_bytes
             for kind, inc in FORMS for op, n, dt in _combos()]
    plan = tsc.plan_launch(TK.FUSED_SCAN_TOTAL, 16, 1 << 20, torch.float32, 3,
                           inclusive=True)
    assert plan.slots == 9  # 4 rounds x 2 streams + the exit
    assert plan.shared_bytes == max(sizes) == 80 + 9 * 3 * 4096


@pytest.mark.parametrize("nbytes", LARGE)
def test_k2_plan_grid_within_cuda_limits(nbytes):
    for kind, inclusive in FORMS:
        for op, n, dtype in _combos():
            for p in (2, 8, 16, 32):
                if kind in (TK.TOTAL, TK.BARRIER) and not _pow2(p):
                    continue
                M = nbytes // dtype.itemsize
                plan = tsc.plan_launch(kind, p, M, dtype, n, inclusive=inclusive)
                gx, gy, gz = plan.grid
                assert 1 <= gx <= GRID_X_MAX and gy <= 65535 and gz == 1
                tiles = gx // p if plan.path == "cluster" else gx
                assert tiles * plan.tile >= M > (tiles - 1) * plan.tile
                if plan.path == "cluster":
                    assert gx % p == 0  # whole clusters


def test_k2_plan_named_path_and_rejections():
    plan = tsc.plan_launch(TK.SCAN, 8, 1000, torch.float32, 1, path="flags")
    assert plan.path == "flags" and plan.shared_bytes == 0
    with pytest.raises(ValueError, match="cluster"):
        tsc.plan_launch(TK.SCAN, 32, 1000, torch.float32, 1, path="cluster")
    with pytest.raises(ValueError, match="cluster"):
        tsc.plan_launch(TK.SCAN, 1, 1000, torch.float32, 1, path="cluster")
    with pytest.raises(ValueError, match="takes"):
        tsc.plan_launch(TK.SCAN, 8, 1000, torch.float64, 1)


# ---------------------------------------------------------------------------
# K2's cluster protocol in plain PyTorch
# ---------------------------------------------------------------------------


def cluster_protocol(kind, p, op, tree, *, inclusive=True):
    """K2's cluster path over stacked ``(p, ...)`` leaves: p ranks, each
    with one receive slot per exchange; every put goes into
    ``slot[partner][exchange]`` and each rank reads its own slots, in the
    kernel's order. Returns the result (a tree, or ``(scan, total)`` for
    FUSED_SCAN_TOTAL) and the write and read counts of every slot."""
    leaves, spec = tree_flatten(tree)
    n_ex = tsc.exchanges(kind, p, inclusive)
    slots = [[None] * n_ex for _ in range(p)]
    writes = np.zeros((p, n_ex), dtype=int)
    reads = np.zeros((p, n_ex), dtype=int)

    def combine(lhs, rhs):
        merged = op.combine(tree_unflatten(lhs, spec), tree_unflatten(rhs, spec))
        return tree_flatten(merged)[0]

    def zeros(vals):
        return [torch.zeros_like(v) for v in vals]

    def put(e, partner, vals):
        """Every rank r puts ``vals[r]`` into slot e of rank partner(r)."""
        for r in range(p):
            dst = partner(r)
            writes[dst, e] += 1
            slots[dst][e] = [v.clone() for v in vals[r]]

    def receive(r, e):
        reads[r, e] += 1
        return slots[r][e]

    pre = [[leaf[r] for leaf in leaves] for r in range(p)]
    suf = [list(vals) for vals in pre]
    ex = 0
    if kind in (TK.TOTAL, TK.BARRIER):
        for d in (1 << k for k in range(alg.num_steps(p))):
            put(ex, lambda r, d=d: r ^ d, pre)
            for r in range(p):
                rv = receive(r, ex)
                # partner lower: combine(recv, acc)
                pre[r] = combine(rv, pre[r]) if r & d else combine(pre[r], rv)
            ex += 1
        out = pre
    else:
        fused = kind == TK.FUSED_SCAN_TOTAL
        if not inclusive:
            # structural entry shift: rank r starts from x_{r-1}
            put(ex, lambda r: (r + 1) % p, pre)
            rvs = [receive(r, ex) for r in range(p)]
            pre = [rvs[r] if r >= 1 else zeros(rvs[r]) for r in range(p)]
            ex += 1
        for d in (1 << k for k in range(alg.num_steps(p))):
            put(ex, lambda r, d=d: (r + d) % p, pre)
            if fused:  # both streams' puts before either wait
                put(ex + 1, lambda r, d=d: (r - d + p) % p, suf)
            for r in range(p):
                rv = receive(r, ex)
                pre[r] = combine(rv if r >= d else zeros(rv), pre[r])
                if fused:
                    rv = receive(r, ex + 1)
                    suf[r] = combine(suf[r], rv if r < p - d else zeros(rv))
            ex += 2 if fused else 1
        out = pre
        if fused:
            if inclusive:
                put(ex, lambda r: (r - 1 + p) % p, suf)
                rvs = [receive(r, ex) for r in range(p)]
                total = [combine(pre[r], rvs[r] if r < p - 1 else zeros(rvs[r]))
                         for r in range(p)]
                ex += 1
            else:
                total = [combine(pre[r], suf[r]) for r in range(p)]
                out = [pre[r] if r != 0 else zeros(pre[r]) for r in range(p)]
    assert ex == n_ex

    def stacked(rows):
        return tree_unflatten(
            [torch.stack([rows[r][i] for r in range(p)]) for i in range(len(leaves))],
            spec)

    result = stacked(out)
    if kind == TK.FUSED_SCAN_TOTAL:
        result = (result, stacked(total))
    return result, writes, reads


def _protocol_cases():
    """(kind, inclusive, ranks, operator): every phase form at p = 2, 4, 8 and
    16 over SUM (MAX for the barrier's token), SCAN at p = 3 and 6, and the
    non-commutative SSD operator, where operand order shows, at p = 3, 4
    and 8."""
    cases = []
    for kind, inclusive in FORMS:
        op = "max" if kind == TK.BARRIER else "sum"
        for p in (2, 4, 8, 16):
            cases.append((kind.name, inclusive, p, op))
    for p in (3, 6):
        cases += [("SCAN", True, p, "sum"), ("SCAN", False, p, "sum")]
    for kind, inclusive in FORMS[:5]:
        for p in (4, 8) if kind == TK.TOTAL else (3, 4, 8):
            cases.append((kind.name, inclusive, p, "ssd"))
    return cases


PROTOCOL_CASES = _protocol_cases()


def _name(spec):
    kind_name, inclusive, p, op = spec
    return f"{kind_name}-{'inc' if inclusive else 'exc'}-p{p}-{op}"


def _input(spec):
    """The case's stacked ``(p, 8)`` numpy payload, seeded by its name: an
    int32 and a float32 leaf for SUM, ones for the barrier, SSD's (a, b)."""
    kind_name, _, p, op = spec
    rng = np.random.default_rng(zlib.crc32(_name(spec).encode()))
    if op == "max":
        return np.ones((p, 8), np.float32)
    if op == "ssd":
        return (rng.uniform(0.5, 1.5, (p, 8)).astype(np.float32),
                rng.standard_normal((p, 8)).astype(np.float32))
    return (rng.integers(-1000, 1000, (p, 8)).astype(np.int32),
            rng.standard_normal((p, 8)).astype(np.float32))


_REF_PROTOCOL = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core.operators import get_operator
from repro.kernels import pallas_collective as pc
from repro.offload import planner

with open(sys.argv[1], "rb") as fh:
    cases = pickle.load(fh)
out = {}
for name, (kind_name, inclusive, p, op_name, x) in cases.items():
    mesh = Mesh(np.array(jax.devices()[:p]), ("i",))
    f = pc._spmd_comm_kernel(planner.PhaseKind[kind_name], p, "i",
                             get_operator(op_name), inclusive=inclusive,
                             interpret=True)
    run = jax.jit(shard_map(lambda a: f(a), mesh=mesh, in_specs=(P("i"),),
                            out_specs=P("i"), check_vma=False))
    got = run(jax.tree.map(jnp.asarray, x))
    out[name] = [np.asarray(a) for a in jax.tree.leaves(got)]
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
print("ALL-OK")
"""


@pytest.fixture(scope="module")
def ref_protocol(tmp_path_factory):
    work = tmp_path_factory.mktemp("ref_protocol")
    cases = {_name(spec): (*spec, _input(spec)) for spec in PROTOCOL_CASES}
    with open(work / "cases.pkl", "wb") as fh:
        pickle.dump(cases, fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REF_PROTOCOL, str(work / "cases.pkl"),
         str(work / "ref.pkl")],
        env=env, capture_output=True, text=True, timeout=900, cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ALL-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:]
    )
    with open(work / "ref.pkl", "rb") as fh:
        return pickle.load(fh)


def _flat(kind, out):
    """Every leaf of a result: the scan's, then the total's (FUSED)."""
    parts = out if kind == TK.FUSED_SCAN_TOTAL else (out,)
    return [leaf for part in parts for leaf in tree_flatten(part)[0]]


@pytest.mark.parametrize("spec", PROTOCOL_CASES, ids=_name)
def test_cluster_protocol_matches_plain_and_reference_kernel(spec, ref_protocol):
    kind_name, inclusive, p, opname = spec
    kind = TK[kind_name]
    op = t_ops.get_operator(opname)
    x = payload_from_numpy(_input(spec), "cpu")
    got, writes, reads = cluster_protocol(kind, p, op, x, inclusive=inclusive)
    # every slot written exactly once and read exactly once per launch
    assert writes.shape == (p, tsc.exchanges(kind, p, inclusive))
    assert (writes == 1).all() and (reads == 1).all()

    mesh = compat.Mesh((p,), ("i",), device="cpu")
    plain = compat.shard_map(
        lambda t: tsc.comm_phase_spmd_plain(kind, p, "i", op, t,
                                            inclusive=inclusive),
        mesh, ("i",), "i")(x)
    want_ref = ref_protocol[_name(spec)]
    got_leaves, plain_leaves = _flat(kind, got), _flat(kind, plain)
    assert len(got_leaves) == len(plain_leaves) == len(want_ref)
    # bitwise against the plain version (the same PyTorch ops); against the
    # reference bitwise too, but for SSD's products and sums, which XLA may
    # contract into a fused multiply-add (float32 rounding, 1e-5)
    tol = 1e-5 if opname == "ssd" else 0.0
    for g, w, r in zip(got_leaves, plain_leaves, want_ref):
        assert g.dtype == w.dtype
        assert torch.equal(g, w), _name(spec)
        np.testing.assert_allclose(g.numpy(), r.reshape(g.shape), rtol=tol,
                                   atol=tol, err_msg=_name(spec))
