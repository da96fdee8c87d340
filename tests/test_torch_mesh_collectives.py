"""The port's rank-group collectives and block-spec ``shard_map`` against the
reference.

Pairs: ``repro_torch.compat.{psum,pmax,pmean,all_to_all,block_shard_map}``
vs ``jax.lax.{psum,pmax,pmean,all_to_all}`` under ``repro.compat.shard_map``
(``check_vma=False``). Every case of ``repro_torch.testing.mesh_check`` (a
``(2, 2)`` mesh, one axis or a tuple of axes, float32 and int32) runs
co-resident in this process and in 4 processes joined in one gloo group (a
``file://`` store, killed after 120 s): the two kinds bitwise equal, and
so are the model code's regions of ``mesh_check.run_regions``
(sequence-sharded decode attention, explicit TP). The
reference runs in a subprocess on forced host devices: bitwise for pmax,
all_to_all, the block moves and int32; float32 psum and pmean at rtol =
atol = 1e-6 (XLA picks its reduction order, the port adds in group order).
"""

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.compat import P
from repro_torch.testing import mesh_check as mc
from torch_mesh_helpers import SPAWN_TIMEOUT_S, run_module, run_reference

CASES = mc.CASES
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def coresident():
    return mc.run_cases(compat.Mesh(*mc.MESH, device="cpu"))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return mc.run_gloo(tmp_path_factory.mktemp("gloo_mesh"),
                       timeout=SPAWN_TIMEOUT_S)


_REF = r"""
from repro_torch.testing import mesh_check as mc

m = mesh(mc.MESH[0], mc.MESH[1])
for case in mc.CASES:
    def body(x, case=case):
        if case.op == "all_to_all":
            return lax.all_to_all(x, case.axes, case.split, case.concat,
                                  tiled=True)
        if case.op == "identity":
            return x
        return getattr(lax, case.op)(x, case.axes)

    f = jax.jit(shard_map(body, mesh=m, in_specs=(P(*case.in_spec),),
                          out_specs=P(*case.out_spec), check_vma=False))
    OUT[case.name] = f(jnp.asarray(mc.case_input(case)))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(_REF, {}, tmp_path_factory.mktemp("ref_mesh"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_gloo_equals_coresident_bitwise(case, coresident, gloo):
    assert torch.equal(gloo[case.name], coresident[case.name])


@pytest.mark.parametrize("region", mc.REGIONS)
def test_region_gloo_equals_coresident_bitwise(region, gloo):
    """The model code's regions (sequence-sharded decode, explicit TP) in
    the gloo group and co-resident."""
    want = mc.run_regions(compat.Mesh(*mc.MESH, device="cpu"))[region]
    assert len(gloo[region]) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(gloo[region], want))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_collective_matches_lax(case, coresident, reference):
    got, want = coresident[case.name].numpy(), reference[case.name]
    assert got.shape == want.shape and got.dtype == want.dtype
    if case.op in ("psum", "pmean") and case.dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_mesh_check_prints_all_ok(tmp_path):
    out = run_module("repro_torch.testing.mesh_check", str(tmp_path))
    assert f"cases,{len(CASES)},regions,{len(mc.REGIONS)}" in out


def test_a_replicated_leaf_is_a_stride_0_expand():
    mesh = compat.Mesh((2, 2), ("data", "model"), device="cpu")
    w = torch.randn(3, 5)
    seen = []

    def region(x, w_l):
        seen.append(w_l)
        return compat.psum(x, "model")

    compat.block_shard_map(region, mesh, (P("data"), P()), P("data"))(
        torch.randn(4, 5), w)
    assert seen[0].shape == (4, 3, 5) and seen[0].stride(0) == 0
    assert seen[0].data_ptr() == w.data_ptr()


def test_psum_adds_in_group_order():
    """Co-resident ranks fold the group's rows in order 0..p-1, as a process
    does after its p - 1 shifts: (((x0 + x1) + x2) + x3)."""
    mesh = compat.Mesh((4,), ("i",), device="cpu")
    x = torch.tensor([1e8, 1.0, -1e8, 1.0], dtype=torch.float32)
    got = compat.block_shard_map(
        lambda a: compat.psum(a, "i"), mesh, (P("i"),), P())(x)
    want = ((x[0] + x[1]) + x[2]) + x[3]
    assert torch.equal(got, want.reshape(1))


@pytest.mark.parametrize("bad", [
    ("a spec naming more dims than the value", P("data", "model", None), (4, 4)),
    ("an axis named twice", P("data", "data"), (4, 4)),
    ("a dim that does not split", P("model"), (3, 4)),
    ("an axis the mesh lacks", P("pod"), (4, 4)),
])
def test_block_shard_map_refuses_a_bad_spec(bad):
    _, spec, shape = bad
    mesh = compat.Mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        compat.block_shard_map(lambda a: a, mesh, (spec,), spec)(
            torch.zeros(shape))


def test_collectives_refuse_what_is_not_ported():
    mesh = compat.Mesh((2, 2), ("data", "model"), device="cpu")

    def untiled(x):
        return compat.all_to_all(x, "model", 1, 2, tiled=False)

    with pytest.raises(NotImplementedError):
        compat.block_shard_map(untiled, mesh, (P(),), P())(torch.zeros(4, 4))
    with pytest.raises(NameError):
        compat.psum(torch.zeros(2), "model")    # no region binds the axis
