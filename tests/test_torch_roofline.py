"""The port's roofline against the reference's.

Pairs: ``repro_torch.roofline.op_cost`` (an op count of a PyTorch run
under a ``TorchDispatchMode``) vs ``repro.roofline.hlo_cost`` (a parse of
the compiled XLA HLO), and ``repro_torch.roofline.analysis`` vs
``repro.roofline.analysis``. Tolerances:

* ``tests/test_hlo_cost.py``'s four closed-form cases in torch, at that
  file's tolerances, and the port's FLOPs within 5% of the reference's
  ``hlo_cost`` of the same JAX function;
* ``model_flops``: equal;
* ``kernel_cost``: ``PERF.md``'s bounds of K1-K5 to 0.1%;
* a K3 call and its backward: one charge each, exactly the kernel's cost;
* the rank-group collectives on a co-resident (1, 4) mesh: counts and wire
  bytes equal to the reference's ``analyze_hlo`` under 4 forced host
  devices (in a subprocess);
* reduced Mamba2-130m, SmolLM-360M and OLMoE-1B-7B forwards at (2, 64):
  the port's matmul FLOPs within 2% of the reference's dot FLOPs, total
  FLOPs within 10% (measured on the CPU: 0.959, 0.995 and 0.993 of the
  reference's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import SHAPES as RSHAPES
from repro.configs import applicable_shapes as r_applicable
from repro.configs import get_config as rget
from repro.models import build_model as rbuild
from repro.roofline import analysis as ranalysis
from repro.roofline import hlo_cost as H
from repro_torch import compat
from repro_torch.compat import P
from repro_torch.configs import SHAPES as PSHAPES
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import ARCH_IDS
from repro_torch.kernels import ops
from repro_torch.models import build_model as pbuild
from repro_torch.roofline import analysis as an
from repro_torch.roofline import op_cost as oc
from torch_mesh_helpers import run_reference
from torch_model_helpers import _batch, _pair

#: aten matmuls, the port's counterpart of the HLO's dot ops
MATMULS = ("mm", "bmm", "addmm", "baddbmm", "dot", "mv")


def _compile_text(fn, *shapes):
    return jax.jit(fn).lower(*shapes).compile().as_text()


# ---------------------------------------------------------------------------
# tests/test_hlo_cost.py's closed forms
# ---------------------------------------------------------------------------


def _j_loop(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    out, _ = lax.scan(body, x, None, length=7)
    return out


def _t_loop(x, w):
    for _ in range(7):
        x = torch.tanh(x @ w)
    return x


def _j_nested(x, w):
    def outer(c, _):
        def inner(c2, _):
            return c2 @ w, None
        c2, _ = lax.scan(inner, c, None, length=3)
        return c2, None
    out, _ = lax.scan(outer, x, None, length=5)
    return out


def _t_nested(x, w):
    for _ in range(5):
        for _ in range(3):
            x = x @ w
    return x


# (jax fn, torch fn, shapes, expected FLOPs, (lo, hi) of FLOPs / expected)
CLOSED_FORMS = {
    "single_matmul": (lambda a, b: a @ b, lambda a, b: a @ b,
                      ((256, 512), (512, 128)), 2 * 256 * 512 * 128,
                      (0.99, 1.01)),
    "scan_trip_count": (_j_loop, _t_loop, ((128, 128), (128, 128)),
                        7 * 2 * 128 ** 3, (0.95, 1.15)),
    "nested_scan": (_j_nested, _t_nested, ((128, 128), (128, 128)),
                    15 * 2 * 128 ** 3, (0.95, 1.15)),
    "gqa_einsum": (lambda q, k: jnp.einsum("bqhgd,bkhd->bhgqk", q, k),
                   lambda q, k: torch.einsum("bqhgd,bkhd->bhgqk", q, k),
                   ((2, 64, 4, 2, 32), (2, 128, 4, 32)),
                   2 * (2 * 4 * 2 * 64 * 128) * 32, (0.95, 1.1)),
}


@pytest.mark.parametrize("case", sorted(CLOSED_FORMS))
def test_closed_form_flops_match_the_reference(case):
    jfn, tfn, shapes, expect, (lo, hi) = CLOSED_FORMS[case]
    ref = H.hlo_cost(_compile_text(
        jfn, *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)), 1)
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    _, got = oc.op_cost(tfn, *args)
    assert lo < ref.flops / expect < hi
    assert lo < got.flops / expect < hi
    assert abs(got.flops / ref.flops - 1) < 0.05
    if case == "single_matmul":
        expect_bytes = (256 * 512 + 512 * 128 + 256 * 128) * 4
        assert 0.5 < got.bytes / expect_bytes < 2.5
        assert 0.5 < ref.bytes / expect_bytes < 2.5


def test_cost_and_roofline_keep_the_reference_fields():
    assert ([f.name for f in dataclasses.fields(oc.Cost)]
            == [f.name for f in dataclasses.fields(H.Cost)])
    assert oc.COLLECTIVES == H._COLLECTIVES
    r = an.Roofline(1e12, 1e9, 1e6, 4)
    ref = ranalysis.Roofline(1e12, 1e9, 1e6, 4)
    assert list(r.as_dict()) == list(ref.as_dict())
    # the card's data-sheet figures, not the TPU's
    assert (an.PEAK_FLOPS, an.HBM_BW, an.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert r.t_compute == 1e12 / 989e12 and r.bottleneck == "compute"


# ---------------------------------------------------------------------------
# model_flops and the kernels' own cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    rc, pc = rget(arch), pget(arch)
    for shape in r_applicable(rc):
        rs, ps = RSHAPES[shape], PSHAPES[shape]
        assert an.model_flops(pc, ps, ps.kind) == ranalysis.model_flops(
            rc, rs, rs.kind)


#: PERF.md's bounds, in µs: (kernel, shape, bound, bound_by)
BOUNDS = [
    ("k3", dict(rows=8192, length=8192, dtype=torch.float32),
     160.260, "bytes"),
    ("k4", dict(rows=8, time=4096, width=1536, dtype=torch.float32),
     180.292, "bytes"),
    ("k4", dict(rows=8, time=4096, width=1536, dtype=torch.bfloat16),
     90.146, "bytes"),
    ("k5", dict(bh=60, sq=2048, skv=2048, d=64, dtype=torch.bfloat16,
                causal=True, window=0, q_offset=0), 32.586, "operations"),
    ("k1", dict(phase="SCAN", p=8, numel=8 * (1 << 18), dtype=torch.float32),
     5.008, "bytes"),
    ("k1", dict(phase="TOTAL", p=8, numel=8 * (25 << 18),
                dtype=torch.float32), 125.203, "bytes"),
]


@pytest.mark.parametrize("kernel,shape,bound_us,by", BOUNDS,
                         ids=[f"{b[0]}-{b[2]}" for b in BOUNDS])
def test_kernel_cost_reproduces_the_kernel_table_bounds(kernel, shape,
                                                        bound_us, by):
    seconds, got_by = an.kernel_cost(kernel, **shape).bound(an.H100)
    assert got_by == by
    assert abs(seconds * 1e6 / bound_us - 1) < 1e-3


def test_a_k3_call_and_its_backward_are_charged_once_each():
    x = torch.randn(6, 300, requires_grad=True)
    g = torch.randn(6, 300)
    with oc.CostMode() as mode:
        y = ops.prefix_scan(x)
        (dx,) = torch.autograd.grad(y, x, g)
    one = an.kernel_cost("k3", rows=6, length=300, dtype=torch.float32)
    assert [(c.kind, c.shape["reverse"]) for c in mode.charges] == [
        ("k3", False), ("k3", True)]
    assert all(c.bytes == one.bytes for c in mode.charges)
    # none of the plain version's ops (cumsum, flips) is counted
    assert mode.cost.flops == 2 * one.flops
    assert mode.cost.bytes == 2 * one.bytes
    assert set(mode.by_op) == {"k3"}
    torch.testing.assert_close(dx, g.flip(-1).cumsum(-1).flip(-1))


def _k1(x):
    from repro_torch.core.operators import SUM
    from repro_torch.kernels import fused_collective
    from repro_torch.offload.planner import PhaseKind

    return fused_collective.comm_phase(PhaseKind.SCAN, 4, SUM, x)


def _k2(x):
    from repro_torch.core.operators import SUM
    from repro_torch.kernels import spmd_collective
    from repro_torch.offload.planner import PhaseKind

    mesh = compat.Mesh((4,), ("i",), device="cpu")
    return compat.shard_map(
        lambda t: spmd_collective.comm_phase_spmd(PhaseKind.SCAN, 4, "i",
                                                  SUM, t),
        mesh, in_specs=("i",), out_specs="i")(x)


# kernel: (call on (4, 64) float32 inputs, its kernel_cost shape)
ENTRIES = {
    "k1": (_k1, dict(phase="SCAN", p=4, numel=256, dtype=torch.float32)),
    "k2": (_k2, dict(phase="SCAN", p=4, numel=256, dtype=torch.float32)),
    "k4": (lambda x: ops.ssd_scan(x.reshape(1, 4, 64).sigmoid(),
                                  x.reshape(1, 4, 64))[0],
           dict(rows=1, time=4, width=64, dtype=torch.float32, h0=False)),
    "k5": (lambda x: ops.flash_attention(x[None], x[None], x[None]),
           dict(bh=1, sq=4, skv=4, d=64, dtype=torch.float32, causal=True,
                window=0, q_offset=0)),
}


@pytest.mark.parametrize("kernel", sorted(ENTRIES))
def test_a_kernel_entry_is_one_charge_at_its_own_cost(kernel):
    """K1's and K2's comm phases (their schedules' permutes nested, not
    counted), K4 and K5 on the CPU: one charge, the plain version's ops
    not counted."""
    call, shape = ENTRIES[kernel]
    x = torch.randn(4, 64)
    with oc.CostMode() as mode:
        call(x)
    want = an.kernel_cost(kernel, **shape)
    got = [(c.kind, c.flops, c.bytes) for c in mode.charges]
    assert got == [(kernel, want.flops, want.bytes)]
    assert mode.cost.total_coll_bytes == 0
    assert mode.by_op[kernel] == [want.flops, want.bytes]


def test_no_counter_active_means_no_charge():
    assert oc.active() is None
    with oc.charged("k3", rows=1, length=1, dtype=torch.float32):
        assert oc.active() is None


def test_inference_mode_counts_what_grad_mode_counts():
    """Composite ops reach the mode whole under inference mode (einsum);
    the count decomposes them as autograd would."""
    _, pc, _, module = _pair("mamba2-130m")
    tokens = torch.zeros((2, 64), dtype=torch.int32)
    counts = []
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx(), oc.CostMode() as mode:
            pbuild(pc).forward(module, {"tokens": tokens})
        counts.append((mode.cost.flops, mode.cost.bytes, len(mode.charges)))
    assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# the rank-group collectives against analyze_hlo on forced host devices
# ---------------------------------------------------------------------------

# name: (global shape, in spec, out spec)
COLLECTIVES = {
    "psum": ((8, 16), (None, "model"), (None, None)),
    "pmax": ((8, 16), (None, "model"), (None, None)),
    "pmean": ((8, 16), (None, "model"), (None, None)),
    "all_to_all": ((16, 8), ("model", None), (None, "model")),
    "ppermute": ((16, 8), ("model", None), ("model", None)),
}
PERM = [(i, (i + 1) % 4) for i in range(4)]

_REF = r"""
from repro.roofline.analysis import analyze_hlo

m = mesh((1, 4))
perm = [(i, (i + 1) % 4) for i in range(4)]
bodies = {
    "psum": lambda x: lax.psum(x, "model"),
    "pmax": lambda x: lax.pmax(x, "model"),
    "pmean": lambda x: lax.pmean(x, "model"),
    "all_to_all": lambda x: lax.all_to_all(x, "model", 1, 0, tiled=True),
    "ppermute": lambda x: lax.ppermute(x, "model", perm),
}
for name, (shape, ins, outs) in IN.items():
    f = jax.jit(shard_map(bodies[name], mesh=m, in_specs=(P(*ins),),
                          out_specs=P(*outs), check_vma=False))
    text = f.lower(jax.ShapeDtypeStruct(shape, jnp.float32)).compile().as_text()
    _, cost = analyze_hlo(text, 4, 4)
    OUT[name] = np.array([[cost.coll_counts[k], cost.coll_bytes[k]]
                          for k in ("all-reduce", "all-gather",
                                    "reduce-scatter", "all-to-all",
                                    "collective-permute")])
"""


@pytest.fixture(scope="module")
def reference_collectives(tmp_path_factory):
    # 4 of the helper's 8 forced host devices
    return run_reference(_REF, COLLECTIVES,
                         tmp_path_factory.mktemp("ref_roofline"))


def _port_body(name):
    return {
        "psum": lambda x: compat.psum(x, "model"),
        "pmax": lambda x: compat.pmax(x, "model"),
        "pmean": lambda x: compat.pmean(x, "model"),
        # the region's leaves lead with their rank rows: dims shift by one
        "all_to_all": lambda x: compat.all_to_all(x, "model", 2, 1),
        "ppermute": lambda x: compat.ppermute(x, "model", PERM),
    }[name]


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_counts_and_wire_bytes_match_analyze_hlo(
        name, reference_collectives):
    shape, ins, outs = COLLECTIVES[name]
    mesh = compat.Mesh((1, 4), ("data", "model"), device="cpu")
    fn = compat.block_shard_map(_port_body(name), mesh, (P(*ins),), P(*outs))
    _, cost = oc.op_cost(fn, torch.randn(shape))
    want = reference_collectives[name]
    got = np.array([[cost.coll_counts[k], cost.coll_bytes[k]]
                    for k in oc.COLLECTIVES])
    # XLA adds no resharding collective to these regions: every kind is
    # compared, the ones the code does not write included
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].sum() == 1


# ---------------------------------------------------------------------------
# reduced model forwards against the reference's HLO
# ---------------------------------------------------------------------------


def _dot_flops(text: str) -> float:
    """The reference's dot FLOPs: ``hlo_cost``'s ``_dot_flops`` summed over
    ``parse_module``'s computations, fusions entered, while bodies
    multiplied by their trip counts."""
    comps, entry = H.parse_module(text)
    memo = {}

    def walk(comp):
        if comp.name in memo:
            return memo[comp.name]
        total = 0.0
        for op in comp.ops:
            if op.kind in ("dot", "convolution"):
                total += H._dot_flops(op, comp)
            elif op.kind == "while":
                body = H._called(op.attrs, "body")
                cond = H._called(op.attrs, "condition")
                trip = H._trip_count(comps[cond], comps) if cond in comps else 1
                total += trip * (walk(comps[body]) if body in comps else 0.0)
            elif op.kind in ("fusion", "call", "async-start"):
                callee = (H._called(op.attrs, "calls")
                          or H._called(op.attrs, "to_apply"))
                if callee in comps:
                    total += walk(comps[callee])
        memo[comp.name] = total
        return total

    return walk(comps[entry])


@pytest.mark.parametrize("arch", ["mamba2-130m", "smollm-360m",
                                  "olmoe-1b-7b"])
def test_reduced_forward_flops_match_the_reference(arch):
    rc, pc, params, module = _pair(arch)
    jb, tb = _batch(rc, 2, 64)
    text = _compile_text(lambda p, b: rbuild(rc).forward(p, b), params, jb)
    ref = H.hlo_cost(text, 1)
    with torch.no_grad(), oc.CostMode() as mode:
        pbuild(pc).forward(module, tb)
    matmul = sum(v[0] for k, v in mode.by_op.items() if k in MATMULS)
    assert abs(matmul / _dot_flops(text) - 1) < 0.02
    assert abs(mode.cost.flops / ref.flops - 1) < 0.10
    assert mode.unpriced == {}
