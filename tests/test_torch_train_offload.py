"""The offloaded training path of the port: the engine-dispatched
data-parallel step against the raw ``compat`` step
(``tests/test_train_offload.py`` mirrored), and the sequence-parallel Mamba
mixer's gradient.

Pairs: ``repro_torch.testing.train_offload_check`` vs
``repro.testing.train_offload_check`` (its three scenarios; bitwise engine
== raw, co-resident in-process and in a 4-process gloo group through a
``file://`` store, each spawn killed after 120 s);
``repro_torch.launch.steps.build_dp_train_step`` vs
``repro.launch.steps.build_dp_train_step``'s build-time contracts, and
against the port's one-device step on the whole batch (the mean of equal
per-rank means: loss within 1e-6 relative, ``grad_norm`` within 1e-5,
every parameter within Adam's sign-flip bound and 99.9% of them within
1e-6); the SP mixer's gradient (``mamba_sp_check``'s fourth check)
against the reference's unsharded mixer under ``jax.grad``, within 2e-3 of
each leaf's largest magnitude (the reference's own SP gradient is its
failing gate, ``ROADMAP.md`` §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_model_helpers import _one_thread  # noqa: F401

from repro_torch import compat
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.steps import build_dp_train_step, build_train_step
from repro_torch.models import build_model as pbuild
from repro_torch.sharding import Topology, make_topology
from repro_torch.testing import train_offload_check as TOC

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _keep_the_active_tuning():
    """A re-mesh re-tunes and activates a table process-wide: put back the
    one the test found, so later tests in this process select as before."""
    from repro_torch.core.selector import get_active_tuning, set_active_tuning

    before = get_active_tuning()
    yield
    set_active_tuning(before)


def test_bitwise_scenario_co_resident():
    rep = TOC.bitwise_scenario(compat.Mesh((2, 2), ("pod", "data"),
                                           device="cpu"), CPU, steps=2)
    assert rep.ok, rep.checks
    assert len(rep.checks) == 4 and len(rep.values["loss"]) == 2


def test_recovery_scenarios():
    for rep in (TOC.recovery_scenario(CPU), TOC.plan_not_halving_scenario(CPU)):
        assert rep.ok, rep.checks


def test_bitwise_scenario_in_a_gloo_group(tmp_path):
    got = TOC.run_gloo(tmp_path, (2, 2), 2, timeout=120.0)
    assert got["names"] == ["step1 dispatches compile (miss)",
                            "loss/grads/params bitwise == raw",
                            "step2+ dispatch is a plan-cache hit",
                            "examples_seen == global batch"]
    assert bool(got["ok"].all())
    # each process took its own rows, one thread each: the same losses as
    # the co-resident run within float32 reassociation
    co = TOC.bitwise_scenario(compat.Mesh((2, 2), ("pod", "data"),
                                          device="cpu"), CPU, steps=2)
    assert np.allclose(got["loss"].numpy(), co.values["loss"], rtol=1e-5)


def test_check_module_cli():
    from repro_torch.testing import train_offload_check

    assert train_offload_check.main(["--device", "cpu", "--steps", "2",
                                     "--bench-iters", "1"]) == 0


def test_dp_step_is_the_whole_batch_step():
    """Equal per-rank counts: the mean of the ranks' mean gradients is the
    whole batch's; so are the loss and the update."""
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.launch.steps import trainable
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    cfg = pget("mamba2_130m").reduced()
    api = pbuild(cfg)
    shape = ShapeConfig("t", 32, 8, "train")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    mesh = compat.Mesh((2, 2), ("pod", "data"), device="cpu")
    dp_fn, _, _ = build_dp_train_step(api, make_topology(mesh), shape, opt)
    one_fn, _, _ = build_train_step(api, Topology(mesh=None), shape, opt)
    batch = next(batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=8, seed=2)))
    out = []
    for fn in (dp_fn, one_fn):
        model = trainable(api.init(torch.Generator().manual_seed(0),
                                   device="cpu"))
        model, _, m = fn(model, init_opt_state(model), batch)
        out.append((model, m))
    (pd, md), (po, mo) = out
    assert float(md["loss"]) == pytest.approx(float(mo["loss"]), rel=1e-6)
    assert float(md["grad_norm"]) == pytest.approx(float(mo["grad_norm"]),
                                                   rel=1e-5)
    assert float(md["examples_seen"]) == 8.0
    # Adam's first step moves an element by +-lr_1 whatever its gradient's
    # size, so a gradient near zero that differs in sign moves it by up to
    # 2 lr_1 (5e-4 here); nearly every element agrees to 1e-6
    lr1 = float(mo["lr"])
    diffs = torch.cat([(a - b).detach().abs().flatten() for (_, a), (_, b)
                       in zip(pd.named_parameters(), po.named_parameters())])
    assert float(diffs.max()) <= 2 * lr1 + 1e-7
    assert float((diffs > 1e-6).float().mean()) < 1e-3


# tests/test_train_offload.py's build-time contracts


def _api_shape():
    cfg = pget("smollm_360m").reduced()
    return pbuild(cfg), ShapeConfig("tiny", 16, 4, "train")


def test_build_train_step_flag_requires_engine():
    api, shape = _api_shape()
    topo = make_topology(compat.Mesh((1, 1), ("pod", "data"), device="cpu"))
    with pytest.raises(ValueError, match="OffloadEngine"):
        build_train_step(api, topo, shape, use_offload_engine=True)


def test_build_train_step_flag_noop_without_mesh():
    api, shape = _api_shape()
    step, shapes, specs = build_train_step(api, Topology(mesh=None), shape,
                                           use_offload_engine=True)
    assert step is not None  # the one-device path


def test_dp_step_rejects_tensor_parallel_mesh():
    api, shape = _api_shape()

    class _FakeTopo:
        mesh = object()
        model_size = 2

    with pytest.raises(ValueError, match="data-parallel only"):
        build_dp_train_step(api, _FakeTopo(), shape)


def test_make_topology_pure_dp_pod_mesh():
    topo = make_topology(compat.Mesh((1, 1), ("pod", "data"), device="cpu"))
    assert topo.batch_axes == ("pod", "data")
    assert topo.model_axis is None
    assert topo.model_size == 1
    assert topo.dp_size == 1


def test_dp_descriptors_take_the_default_lowering():
    """The step's four descriptors name no backend: no K1 launch, as in the
    reference."""
    from repro_torch.launch.offload_runtime import build_offload_engine

    api, _ = _api_shape()
    shape = ShapeConfig("tiny", 16, 8, "train")
    eng = build_offload_engine(retune_on_remesh=False, device="cpu")
    made = []
    make = eng.make_descriptor

    def recording(*a, **kw):
        made.append(kw)
        return make(*a, **kw)

    eng.make_descriptor = recording
    mesh = compat.Mesh((2, 2), ("pod", "data"), device="cpu")
    step, _, _ = build_dp_train_step(api, make_topology(mesh), shape,
                                     engine=eng)
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.launch.steps import trainable
    from repro_torch.optim.adamw import init_opt_state

    model = trainable(api.init(torch.Generator().manual_seed(0), device="cpu"))
    step(model, init_opt_state(model), next(batches(DataConfig(
        vocab_size=api.cfg.vocab_size, seq_len=16, global_batch=8))))
    assert [m.get("comm_id", 0) for m in made] == [0, 1, 2, 3]
    assert all("backend" not in m for m in made)
    assert all(m["axes"] == (2, 2) for m in made)


# ---------------------------------------------------------------------------
# the sequence-parallel mixer's gradient (mamba_sp_check's fourth check)
# ---------------------------------------------------------------------------


def test_sp_mixer_gradient_matches_the_unsharded_reference():
    from repro.models import mamba as RM

    from repro_torch.interop import payload_to_numpy
    from repro_torch.models import mamba as PM
    from repro_torch.testing import mamba_sp_check as MSP

    cfg = MSP._reduced_cfg()
    p, x = MSP.make_inputs(cfg, "cpu")
    mesh = compat.Mesh(*MSP.MESH, device="cpu")
    g_sp = MSP.mixer_grads(torch, p, lambda: MSP.sp_mixer(p, x, cfg, mesh))
    g_port = MSP.mixer_grads(torch, p, lambda: PM.mamba_mixer(p, x, cfg))
    checks = MSP.compare_grads(torch, g_sp, g_port)
    assert all(ok for _, ok, _ in checks), checks

    from repro.configs import get_config as rget

    rc = rget("mamba2_130m").reduced()
    rp = {k: jnp.asarray(v) for k, v in payload_to_numpy(
        {k: v.detach() for k, v in p.named_parameters()}).items()}
    xj = jnp.asarray(x.numpy())

    def loss(pp):
        y, _ = RM.mamba_mixer(pp, xj, rc, seq_parallel=False)
        return jnp.sum(y * y)

    want = jax.jit(jax.grad(loss))(rp)
    for k, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(g_sp[k].numpy() - w).max())
        assert err <= MSP.GRAD_TOL * float(np.abs(w).max()), k


def test_row_specs_may_leave_out_an_axis_of_one_rank():
    """After a remesh to (2, 1) the DP span names only ``pod``: a row spec
    may leave out a mesh axis of size 1, never one of more ranks."""
    mesh = compat.Mesh((2, 1), ("pod", "data"), device="cpu")
    x = torch.arange(4.0).reshape(2, 2)
    out = compat.shard_map(lambda a: compat.psum(a, "pod"), mesh,
                           in_specs=("pod",), out_specs="pod")(x)
    assert torch.equal(out, x.sum(0).expand(2, 2))
    wide = compat.Mesh((2, 2), ("pod", "data"), device="cpu")
    with pytest.raises(ValueError, match="every mesh axis"):
        compat.shard_map(lambda a: a, wide, in_specs=("pod",),
                         out_specs="pod")(torch.zeros(4, 1))


def test_a_mesh_serves_under_inference_mode_then_trains():
    """Index tensors a co-resident mesh caches during a serving call under
    ``torch.inference_mode()`` serve a gradient afterwards."""
    from repro_torch.testing import mamba_sp_check as MSP

    cfg = MSP._reduced_cfg()
    p, x = MSP.make_inputs(cfg, "cpu")
    mesh = compat.Mesh(*MSP.MESH, device="cpu")
    with torch.inference_mode():
        MSP.sp_mixer(p, x, cfg, mesh)
    grads = MSP.mixer_grads(torch, p, lambda: MSP.sp_mixer(p, x, cfg, mesh))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
