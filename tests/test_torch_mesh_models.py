"""The model code's mesh paths against the reference: the sequence-parallel
Mamba mixer, the expert-parallel MoE region, and every family's forward
under a co-resident mesh.

Pairs: ``repro_torch.models.mamba.mamba_mixer(seq_parallel=True)`` vs
``repro.models.mamba.mamba_mixer`` (unsharded, and its SP path on 8 forced
host devices in a subprocess); ``repro_torch.models.moe.moe_block``'s EP
region vs ``repro.models.moe._dense_moe`` and the reference's EP
``moe_block`` (subprocess); ``repro_torch.models.transformer.lm_forward``
under ``(1, 4)`` and ``(2, 2)`` meshes, with and without the
``explicit_tp`` flag, vs the same model with no mesh. The reference's
reduced weights are carried into the port; inputs from a numpy seed,
float32.

Tolerances, the reference's own (``repro/testing/mamba_sp_check.py``,
``moe_check.py``): SP output and final SSD state atol = rtol = 2e-3, conv
tail atol 1e-4; EP output atol = rtol = 2e-4, ``load_balance`` 1e-3. A
forward under a mesh: 1e-4 of the largest logit (``_close``). The MoE
families' forwards run at capacity factor 8.0: at their configured 1.25 the
EP region drops tokens the dense path keeps, by design, and the two differ.
The gloo runs (8 processes, killed after 120 s) are the check modules'.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.models import mamba as RM
from repro.models import moe as RMOE

from repro_torch import compat, perf_flags
from repro_torch.configs import get_config as pget
from repro_torch.models import build_model as pbuild
from repro_torch.models import mamba as PM
from repro_torch.models import moe as PMOE
from repro_torch.sharding import make_topology, use_topology
from repro_torch.testing import moe_check

from torch_mesh_helpers import run_module, run_reference
from torch_model_helpers import (  # noqa: F401  (fixtures)
    _batch, _close, _first, _one_thread, _pair, _rand, _t, untied_router,
)

SP_TOL = 2e-3
CONV_TOL = 1e-4
EP_TOL = 2e-4
LB_TOL = 1e-3
EP_MESHES = [(1, 4), (2, 4), (1, 8)]
LM_MESHES = [(1, 4), (2, 2)]


def _mesh(shape):
    return compat.Mesh(shape, ("data", "model"), device="cpu")


def _under(shape, fn):
    with use_topology(make_topology(_mesh(shape))):
        return fn()


def _k3_rows(monkeypatch):
    """Every (rows, dtype) handed to K3's wrapper (its plain version runs)."""
    k3 = importlib.import_module("repro_torch.kernels.prefix_scan")
    seen = []
    scan_rows = k3.scan_rows

    def recording(x, *args, **kw):
        seen.append((tuple(x.shape), x.dtype))
        return scan_rows(x, *args, **kw)

    monkeypatch.setattr(k3, "scan_rows", recording)
    return seen


# ---------------------------------------------------------------------------
# the sequence-parallel Mamba mixer: 8 shards of 16 tokens, chunk 16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    rc, pc, params, module = _pair("mamba2_130m")
    rp = jax.tree.map(lambda a: np.asarray(a[0]), params["blocks"]["mamba"])
    x = (np.random.default_rng(0).normal(size=(2, 128, rc.d_model)) * 0.1
         ).astype(np.float32)
    pp = module.blocks[0].mamba
    y, cache = _under((1, 8), lambda: PM.mamba_mixer(pp, _t(x), pc,
                                                     seq_parallel=True))
    return rc, pc, rp, pp, x, (y, cache)


def _hold_sp(y, cache, want_y, want_cache):
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=SP_TOL,
                               rtol=SP_TOL)
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(want_cache["ssm"]),
                               atol=SP_TOL, rtol=SP_TOL)
    np.testing.assert_allclose(cache["conv_x"].numpy(),
                               np.asarray(want_cache["conv_x"]), atol=CONV_TOL,
                               rtol=0)


@pytest.mark.parametrize("unsharded", ["port", "reference"])
def test_sp_mixer_matches_the_unsharded_mixer(mamba, unsharded):
    rc, pc, rp, pp, x, (y, cache) = mamba
    if unsharded == "port":
        want = PM.mamba_mixer(pp, _t(x), pc, seq_parallel=False)
    else:
        want = jax.jit(lambda p, x: RM.mamba_mixer(p, x, rc))(
            rp, jnp.asarray(x))
    _hold_sp(y, cache, *want)


_REF_SP = r"""
from repro import perf_flags
from repro.configs import get_config
from repro.models.mamba import mamba_mixer

cfg = get_config("mamba2_130m").reduced()
topo = make_topology(mesh((1, 8)))
for bf16 in (False, True):
    perf_flags.set_flags(scan_payload_bf16=bf16)
    with use_topology(topo):
        OUT[bf16] = jax.jit(lambda p, x: mamba_mixer(p, x, cfg, seq_parallel=True))(
            IN["p"], IN["x"])
"""


@pytest.fixture(scope="module")
def reference_sp(mamba, tmp_path_factory):
    _, _, rp, _, x, _ = mamba
    return run_reference(_REF_SP, {"p": rp, "x": x},
                         tmp_path_factory.mktemp("ref_sp"))


@pytest.mark.parametrize("payload_bf16", [False, True])
def test_sp_mixer_matches_the_reference_sp_mixer(mamba, reference_sp,
                                                 payload_bf16):
    _, pc, _, pp, x, (y, cache) = mamba
    if payload_bf16:
        saved = perf_flags.FLAGS
        try:
            perf_flags.set_flags(scan_payload_bf16=True)
            y, cache = _under((1, 8), lambda: PM.mamba_mixer(
                pp, _t(x), pc, seq_parallel=True))
        finally:
            perf_flags.FLAGS = saved
    _hold_sp(y, cache, *reference_sp[payload_bf16])


def test_sp_mixer_scans_every_shard_in_one_k3_launch(mamba, monkeypatch):
    _, pc, _, pp, x, _ = mamba
    seen = _k3_rows(monkeypatch)
    _under((1, 8), lambda: PM.mamba_mixer(pp, _t(x), pc, seq_parallel=True))
    # 8 shards x batch 2 x 1 chunk x the heads: rows of the 16-step chunk
    assert seen == [((8 * 2 * pc.ssm_num_heads, 16), torch.float32)]


def test_mamba_sp_check_prints_all_ok(tmp_path):
    """The check module on the CPU: the reference check's four
    comparisons (the fourth, the gradient through ``dist_exscan``, also
    held to the unsharded mixer's), co-resident, and the forward in an
    8-process gloo group (bitwise)."""
    out = run_module("repro_torch.testing.mamba_sp_check", "--device", "cpu",
                     "--gloo", str(tmp_path))
    assert out.count(": OK") == 6 and "grad through dist_exscan: OK" in out


# ---------------------------------------------------------------------------
# the expert-parallel MoE region
# ---------------------------------------------------------------------------


def _moe_cfgs(capacity_factor):
    kw = dict(moe_num_experts=8, moe_top_k=2, capacity_factor=capacity_factor)
    from repro.configs import get_config as rget

    return (dataclasses.replace(rget("olmoe_1b_7b").reduced(), **kw),
            dataclasses.replace(pget("olmoe_1b_7b").reduced(), **kw))


@pytest.fixture(scope="module")
def moe():
    rc, pc = _moe_cfgs(8.0)
    rp = jax.tree.map(np.asarray, RMOE.init_moe(jax.random.key(0), rc,
                                                 jnp.float32))
    pp = PMOE.init_moe(torch.Generator(), pc, torch.float32, "cpu")
    for name in ("router", "w_in", "w_gate", "w_out"):
        getattr(pp, name).data.copy_(_t(rp[name]))
    return rp, pp


@pytest.mark.parametrize("layout", list(moe_check.LAYOUTS))
@pytest.mark.parametrize("shape", EP_MESHES, ids=str)
def test_ep_matches_the_reference_dense_moe(moe, shape, layout, untied_router):
    rp, pp = moe
    rc, pc = _moe_cfgs(8.0)
    B, S = moe_check.LAYOUTS[layout]
    x = _rand(np.random.default_rng(1), B, S, rc.d_model)
    y, aux = _under(shape, lambda: PMOE.moe_block(pp, _t(x), pc))
    want, want_aux = RMOE._dense_moe(rp, jnp.asarray(x), rc, "silu")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=EP_TOL,
                               rtol=EP_TOL)
    assert abs(float(aux["load_balance"]) - float(want_aux["load_balance"])) < LB_TOL
    assert y.shape == (B, S, rc.d_model) and aux["router_z"].shape == ()


_REF_EP = r"""
import dataclasses
from repro.configs import get_config
from repro.models.moe import moe_block

cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(), moe_num_experts=8,
                          moe_top_k=2, capacity_factor=0.25)
for shape in IN["meshes"]:
    with use_topology(make_topology(mesh(shape))):
        OUT[shape] = jax.jit(lambda p, x: moe_block(p, x, cfg))(IN["p"], IN["x"])
"""

DROP_X = _rand(np.random.default_rng(2), *moe_check.DROP_SHAPE, 64)


@pytest.fixture(scope="module")
def reference_ep(moe, tmp_path_factory):
    return run_reference(_REF_EP, {"p": moe[0], "x": DROP_X,
                                   "meshes": EP_MESHES},
                         tmp_path_factory.mktemp("ref_ep"))


@pytest.mark.parametrize("shape", EP_MESHES, ids=str)
def test_ep_drops_match_the_reference_ep(moe, reference_ep, shape,
                                         untied_router):
    """At capacity factor 0.25 both drop the same picks: their outputs (zero
    for a dropped pick) agree, and some picks are dropped."""
    _, pp = moe
    _, pc = _moe_cfgs(0.25)
    y, aux = _under(shape, lambda: PMOE.moe_block(pp, _t(DROP_X), pc))
    want_y, want_aux = reference_ep[shape]
    np.testing.assert_allclose(y.numpy(), want_y, atol=EP_TOL, rtol=EP_TOL)
    assert abs(float(aux["load_balance"]) - float(want_aux["load_balance"])) < LB_TOL
    assert moe_check.dropped_picks(pp, _t(DROP_X), pc, _mesh(shape)) > 0


def test_ep_offsets_are_one_int32_k3_launch(moe, monkeypatch):
    """Co-resident ranks' (R, E) expert counts go through K3's exclusive
    scan in one launch a block."""
    _, pp = moe
    _, pc = _moe_cfgs(8.0)
    seen = _k3_rows(monkeypatch)
    x = _rand(np.random.default_rng(3), 4, 16, 64)
    _under((2, 4), lambda: PMOE.moe_block(pp, _t(x), pc))
    assert seen == [((8, 8), torch.int32)]


def test_moe_check_prints_all_ok(tmp_path):
    """The check module on the CPU: EP against the dense path in all four
    token layouts and a capacity-0.25 run that drops picks, co-resident and
    in an 8-process gloo group (bitwise)."""
    out = run_module("repro_torch.testing.moe_check", "--device", "cpu",
                     "--gloo", str(tmp_path))
    assert "gloo bitwise == co-resident: OK" in out


# ---------------------------------------------------------------------------
# every family's forward under a mesh
# ---------------------------------------------------------------------------


def _forward(arch, shape, explicit_tp):
    _, pc, _, module = _pair(arch)
    pc = dataclasses.replace(pc, capacity_factor=8.0)
    _, pb = _batch(pc, 4, 32, seed=5)
    api = pbuild(pc)
    if shape is None:
        return _first(api.forward(module, pb))
    saved = perf_flags.FLAGS
    try:
        perf_flags.set_flags(explicit_tp=explicit_tp)
        return _under(shape, lambda: _first(api.forward(module, pb)))
    finally:
        perf_flags.FLAGS = saved


@pytest.mark.parametrize("explicit_tp", [False, True], ids=["gspmd", "explicit_tp"])
@pytest.mark.parametrize("shape", LM_MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_under_a_mesh_matches_no_mesh(arch, shape, explicit_tp,
                                              untied_router):
    want = _forward(arch, None, False)
    got = _forward(arch, shape, explicit_tp)
    _close(got, want.numpy(), what=f"{arch} {shape}")
