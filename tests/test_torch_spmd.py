"""The port's per-rank (spmd) forms against the reference: ``dist_scan`` /
``dist_exscan`` / ``dist_scan_pair``, the ``dist_*`` reduce ops,
``lower_spmd`` over 1-, 2- and 3-axis plans (chunked and not, raw and
optimized), ``dist_hierarchical_scan`` and the engine's spmd and driver
modes (``repro_torch.compat``, ``core.algorithms.SpmdBackend``,
``offload.planner.lower_spmd``, ``offload.engine``).

Every case of ``repro_torch.testing.spmd_check`` runs under both kinds of
rank group: co-resident ranks on the CPU (in this process) and one rank per
process in a gloo group (one spawn of 4 processes for the whole suite, one
of 8 for the cases that need 8 ranks; a ``file://`` store, no TCP port; each
spawn is killed after 120 s). Each result is held against the reference's
sim forms run here (``sim_scan``, ``sim_reduce``, ``sim_allreduce``,
``sim_barrier``, ``lower_sim``, ``sim_hierarchical_scan``, the engine's sim
mode), which the reference's own gates hold equal to its spmd form; the
plan cases are also held against the reference's ``lower_spmd`` under
``shard_map`` on forced host devices, in a subprocess. Bitwise for sum,
max and min on int32 and float32; ssd, prod and flash at rtol = atol =
1e-5 (multiply-add and exp in two compilers).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import operators as j_ops
from repro.core import reduce_ops as j_reduce
from repro.core.scan_collective import sim_scan as j_sim_scan
from repro.core.selector import select_algorithm as j_select
from repro.core.selector import set_active_tuning as j_set_tuning
from repro.offload import OffloadEngine as JEngine
from repro.offload import backends as j_backends
from repro.offload import passes as j_passes
from repro.offload import planner as j_planner
from repro_torch import compat
from repro_torch.core.selector import set_active_tuning as t_set_tuning
from repro_torch.offload import OffloadEngine as TEngine
from repro_torch.offload import passes as t_passes
from repro_torch.offload import planner as t_planner
from repro_torch.testing import spmd_check as sc
from test_torch_interop import assert_same, to_both

REPO = Path(__file__).resolve().parents[1]
P = 4
P_WIDE = 8
SPAWN_TIMEOUT_S = 120
TOL = dict(rtol=1e-5, atol=1e-5)

CASES = sc.spmd_cases(P)
WIDE = sc.wide_cases(P_WIDE)


@pytest.fixture(autouse=True)
def _no_active_tuning():
    j_set_tuning(None)
    t_set_tuning(None)
    yield
    j_set_tuning(None)
    t_set_tuning(None)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Rank 0's results of the two gloo spawns, by p."""
    return {
        P: sc.run_gloo("spmd", P, tmp_path_factory.mktemp("gloo4"),
                       timeout=SPAWN_TIMEOUT_S),
        P_WIDE: sc.run_gloo("wide", P_WIDE, tmp_path_factory.mktemp("gloo8"),
                            timeout=SPAWN_TIMEOUT_S),
    }


def _coresident(case):
    return sc.run_case(
        case, lambda shape, names: compat.Mesh(shape, names, device="cpu")
    )


def _tolerance(case):
    return TOL if case.get("op") in ("ssd", "prod", "flash") else {}


def reference(case):
    """The reference's sim-form result for one case (a jax pytree)."""
    x_np = sc.case_input(case)
    jx = None if x_np is None else to_both(x_np)[0]
    p = case.p
    op = case.get("op")
    k = case.kind
    if k in ("scan", "exscan"):
        algo = case.get("algorithm")
        if algo == "auto":
            algo = j_select(p, 4 * sc.N, j_ops.get_operator(op),
                            coll="scan" if k == "scan" else "exscan")
        return j_sim_scan(jx, op, p, algorithm=algo, inclusive=k == "scan")
    if k == "pair":
        jop = j_ops.get_operator(op)
        ex = j_sim_scan(jx, op, p, algorithm=case.get("algorithm"),
                        inclusive=False)
        return ex, jop.combine(ex, jx)
    if k == "reduce":
        return j_reduce.sim_reduce(jx, op, p, root=case.get("root"))
    if k == "allreduce":
        return j_reduce.sim_allreduce(jx, op, p,
                                      algorithm=case.get("algorithm"))
    if k == "barrier":
        return j_reduce.sim_barrier(p)
    if k == "plan":
        plan = sc.case_plan(case, j_planner, j_passes)
        return j_planner.lower_sim(plan, op)(jx)
    if k == "hier":
        po, pi = case.shape
        algo = case.get("algorithm")
        algo = "hillis_steele" if algo == "auto" else algo
        out = j_backends.sim_hierarchical_scan(
            jx.reshape((po, pi) + jx.shape[1:]), op, po, pi,
            inclusive=case.get("inclusive"), inner_algorithm=algo,
            outer_algorithm=algo,
        )
        return out.reshape((p,) + out.shape[2:])
    if k == "engine":
        eng = JEngine()
        planned = bool(case.get("planned"))
        from repro.core.packet import WireDType

        desc = eng.make_descriptor(
            case.get("coll"), p=p, axes=case.shape if planned else None,
            payload_bytes=4 * sc.N, op=op,
            data_type=getattr(WireDType, case.get("dtype").upper()),
        )
        return eng.offload(desc, jx)
    raise ValueError(k)


def _check(case, got):
    assert not isinstance(got, str), f"{case.name}: {got}"
    assert_same(reference(case), got, what=case.name, **_tolerance(case))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_coresident_matches_reference(case):
    _check(case, _coresident(case))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_gloo_matches_reference(case, gloo):
    _check(case, gloo[P][case.name])


@pytest.mark.parametrize("case", WIDE, ids=lambda c: c.name)
def test_eight_ranks_match_reference(case, gloo):
    _check(case, gloo[P_WIDE][case.name])
    _check(case, _coresident(case))


@pytest.mark.parametrize(
    "case", [c for c in CASES if c.kind == "plan"], ids=lambda c: c.name
)
def test_plans_equal_reference_plans(case):
    t_plan = sc.case_plan(case, t_planner, t_passes)
    j_plan = sc.case_plan(case, j_planner, j_passes)
    assert t_plan.describe() == j_plan.describe()


# ---------------------------------------------------------------------------
# the reference's lower_spmd under shard_map, and its driver-mode cache keys,
# on p forced host devices in a subprocess
# ---------------------------------------------------------------------------

_REF_SPMD = r"""
import os, pickle, sys
p = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={p}"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.offload import OffloadEngine, passes, planner
from repro_torch.testing import spmd_check as sc

out = {}
for case in sc.spmd_cases(p):
    if case.kind != "plan":
        continue
    mesh = Mesh(np.array(jax.devices()).reshape(case.shape), case.names)
    plan = sc.case_plan(case, planner, passes)
    spec = P(sc.spec_names(case, plan))
    f = planner.lower_spmd(plan, case.names, case.get("op"))
    x = sc.case_input(case)

    def body(*args):
        got = f(args[0] if args else None)
        return jax.tree.map(lambda a: a[None] if jnp.ndim(a) == 0 else a, got)

    run = jax.jit(shard_map(body, mesh=mesh,
                            in_specs=(spec,) if x is not None else (),
                            out_specs=spec, check_vma=False))
    got = run(*((jax.tree.map(jnp.asarray, x),) if x is not None else ()))
    out[case.name] = [np.asarray(a) for a in jax.tree.leaves(got)]

eng = OffloadEngine()
keys = {}
mesh1 = Mesh(np.array(jax.devices()), ("i",))
for coll in ("SCAN", "EXSCAN", "REDUCE", "ALLREDUCE", "BARRIER"):
    desc = eng.make_descriptor(coll, p=p, payload_bytes=4 * sc.N)
    keys[coll] = eng._cache_key(desc, "i", mesh1)
mesh2 = Mesh(np.array(jax.devices()).reshape(2, p // 2), ("a", "b"))
desc = eng.make_descriptor("SCAN", axes=(2, p // 2), payload_bytes=4 * sc.N)
plan, words = eng._plan_for(desc)
_, fields = eng._resolve_backend(desc, plan, ("a", "b"))
keys["planned"] = eng._planned_cache_key(words, plan, ("a", "b"), mesh2, fields)
with open(sys.argv[2], "wb") as fh:
    pickle.dump({"plans": out, "keys": keys}, fh)
print("ALL-OK")
"""


@pytest.fixture(scope="module")
def ref_spmd(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_spmd") / "ref.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SPMD, str(P), str(out)], env=env,
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert proc.returncode == 0 and "ALL-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:]
    )
    with open(out, "rb") as fh:
        return pickle.load(fh)


@pytest.mark.parametrize(
    "case", [c for c in CASES if c.kind == "plan"], ids=lambda c: c.name
)
def test_plans_match_reference_lower_spmd(case, ref_spmd, gloo):
    want = ref_spmd["plans"][case.name]
    tol = _tolerance(case) or dict(rtol=0, atol=0)
    for got in (_coresident(case), gloo[P][case.name]):
        assert len(got) == len(want), case.name
        for g, w in zip(got, want):
            assert g.numpy().dtype == w.dtype, case.name
            # the reference's per-rank barrier token comes back as (p, 1)
            np.testing.assert_allclose(g.numpy(), w.reshape(g.shape),
                                       err_msg=case.name, **tol)


@pytest.mark.parametrize("coll", ["SCAN", "EXSCAN", "REDUCE", "ALLREDUCE",
                                  "BARRIER", "planned"])
def test_driver_mode_cache_keys_equal_reference(coll, ref_spmd):
    eng = TEngine(device="cpu")
    if coll == "planned":
        mesh = compat.Mesh((2, P // 2), ("a", "b"), device="cpu")
        desc = eng.make_descriptor("SCAN", axes=(2, P // 2),
                                   payload_bytes=4 * sc.N)
        plan, words = eng._plan_for(desc)
        _, fields = eng._resolve_backend(desc, plan, ("a", "b"))
        key = eng._planned_cache_key(words, plan, ("a", "b"), mesh, fields)
    else:
        mesh = compat.Mesh((P,), ("i",), device="cpu")
        desc = eng.make_descriptor(coll, p=P, payload_bytes=4 * sc.N)
        key = eng._cache_key(desc, "i", mesh)
    assert key == ref_spmd["keys"][coll]


@pytest.mark.parametrize("axis_name", [None, "i", ("a", "b")], ids=str)
@pytest.mark.parametrize("planned", [False, True])
def test_sim_and_spmd_mode_cache_keys_equal_reference(axis_name, planned):
    j_eng, t_eng = JEngine(), TEngine(device="cpu")
    kw = dict(axes=(2, 4)) if planned else dict(p=8)
    jd = j_eng.make_descriptor("SCAN", payload_bytes=64, **kw)
    td = t_eng.make_descriptor("SCAN", payload_bytes=64, **kw)
    if not planned:
        assert t_eng._cache_key(td, axis_name) == j_eng._cache_key(jd, axis_name)
        return
    keys = []
    for eng, d in ((j_eng, jd), (t_eng, td)):
        plan, words = eng._plan_for(d)
        _, fields = eng._resolve_backend(d, plan, axis_name)
        keys.append(eng._planned_cache_key(words, plan, axis_name, None, fields))
    assert keys[0] == keys[1]
    assert t_eng._mode_tag(axis_name) == j_eng._mode_tag(axis_name)


# ---------------------------------------------------------------------------
# the engine's modes: telemetry, checks and errors
# ---------------------------------------------------------------------------


def test_spmd_mode_is_untimed_and_driver_mode_timed():
    eng = TEngine(device="cpu")
    mesh = compat.Mesh((P,), ("i",), device="cpu")
    desc = eng.make_descriptor("SCAN", p=P, payload_bytes=4 * sc.N)
    x = torch.arange(P * sc.N, dtype=torch.float32).reshape(P, sc.N)
    compat.shard_map(lambda t: eng.offload(desc, t, axis_name="i"), mesh,
                     ("i",), "i")(x)
    snap = eng.telemetry.snapshot()
    assert snap["dispatches"] == 1 and eng.telemetry.timed_dispatches == 0
    eng.offload(desc, x, axis_name="i", mesh=mesh)
    eng.offload(desc, x, axis_name="i", mesh=mesh)
    assert eng.telemetry.timed_dispatches == 2
    # spmd and driver modes cache apart; the repeat driver dispatch hits
    assert eng.cache_size() == 2 and eng.telemetry.hits == 1


def test_driver_mode_checks_mesh_against_descriptor():
    eng = TEngine(device="cpu")
    desc = eng.make_descriptor("SCAN", p=P, payload_bytes=4 * sc.N)
    x = torch.zeros((P, sc.N))
    with pytest.raises(ValueError, match="requires axis_name"):
        eng.offload(desc, x, mesh=compat.Mesh((P,), ("i",), device="cpu"))
    with pytest.raises(ValueError, match="not in mesh axes"):
        eng.offload(desc, x, axis_name="j",
                    mesh=compat.Mesh((P,), ("i",), device="cpu"))
    with pytest.raises(ValueError, match="mesh axis"):
        eng.offload(desc, torch.zeros((2 * P, sc.N)), axis_name="i",
                    mesh=compat.Mesh((2 * P,), ("i",), device="cpu"))
    planned = eng.make_descriptor("SCAN", axes=(2, 2), payload_bytes=16)
    with pytest.raises(ValueError, match="one mesh axis name per axis"):
        eng.offload(planned, torch.zeros((4, 4)), axis_name="i",
                    mesh=compat.Mesh((4,), ("i",), device="cpu"))
    assert eng.telemetry.errors == 3


def test_axis_names_are_bound_only_inside_shard_map():
    with pytest.raises(NameError, match="unbound axis name"):
        compat.axis_index("i")
    mesh = compat.Mesh((2, 3), ("a", "b"), device="cpu")
    seen = {}

    def body(t):
        seen["a"] = compat.axis_index("a").tolist()
        seen["b"] = compat.axis_index("b").tolist()
        seen["size"] = (compat.axis_size("a"), compat.axis_size("b"))
        return t

    x = torch.arange(6)
    # the spec's first name is major: rows in (b, a) order come back as given
    assert torch.equal(compat.shard_map(body, mesh, (("b", "a"),),
                                        ("b", "a"))(x), x)
    assert seen == {"a": [0, 0, 0, 1, 1, 1], "b": [0, 1, 2, 0, 1, 2],
                    "size": (2, 3)}
    with pytest.raises(NameError):
        compat.axis_size("a")


def test_mesh_defaults_to_cuda_for_both_kinds_of_group(monkeypatch, tmp_path):
    """Both kinds of rank group run on the card unless ``device`` names
    another, and raise without CUDA, as ``OffloadEngine()`` does: driver
    and spmd modes take their device from the mesh."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.Mesh((4,), ("i",))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            compat.Mesh((1,), ("i",), group=dist.group.WORLD)
        mesh = compat.Mesh((1,), ("i",), device="cpu", group=dist.group.WORLD)
        assert mesh.device == torch.device("cpu") and not mesh.coresident
    finally:
        dist.destroy_process_group()
    assert compat.Mesh((4,), ("i",), device="cpu").device == torch.device("cpu")
