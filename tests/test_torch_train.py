"""The training path of the port against the reference: K3's backward, the
models' gradients, the train step, the fault-tolerant Trainer and the
launcher.

Pairs and tolerances:

* ``repro_torch.kernels.ops.prefix_scan``'s gradient (the ``PrefixScan``
  Function: K3 run back to front; its plain version here) vs ``jax.grad``
  of ``repro.kernels.ops.prefix_scan``: within 1e-6 of the largest
  magnitude, float32, inclusive and exclusive;
* ``lm_loss`` value and gradients of the reduced Mamba2-130m and
  SmolLM-360M (weights carried across) vs ``jax.value_and_grad(api.loss)``:
  the loss within 1e-6 relative, each gradient leaf within 2e-4 of its
  largest magnitude (float32 reassociation through remat and the SSD
  chunk scan; 2.7e-5 measured);
* three steps of ``launch.steps.build_train_step`` vs the reference's
  from one state (``interop.model_params_from_numpy`` /
  ``opt_state_from_numpy``): each loss within 1e-6 relative, each
  ``grad_norm`` within 2e-4 relative, every parameter within 1e-4
  absolute (lr 1e-3: Adam's normalised step of a gradient near zero may
  differ in sign between the two; 5.3e-5 measured);
* ``tests/test_fault_tolerance.py`` (8 tests) and ``tests/test_system.py``
  (2) on the port's Trainer, pipeline and ServeEngine.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_model_helpers import _batch, _one_thread, _pair  # noqa: F401

from repro.kernels import ops as ROPS

from repro_torch import perf_flags
from repro_torch.configs import get_config as pget
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.interop import (
    _port_names,
    model_params_from_numpy,
    opt_state_from_numpy,
)
from repro_torch.kernels.ops import prefix_scan
from repro_torch.launch.steps import build_train_step, loss_and_grads
from repro_torch.models import build_model as pbuild
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault import FailureInjector
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.sharding import Topology

K3 = importlib.import_module("repro_torch.kernels.prefix_scan")


# ---------------------------------------------------------------------------
# K3's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 37), (3, 4, 256), (96, 1000)])
@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_scan_grad_matches_jax_grad(shape, exclusive):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(
        ROPS.prefix_scan(a, exclusive=exclusive) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(prefix_scan(xt, exclusive=exclusive), xt,
                                 torch.from_numpy(g))
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-6 * scale


def test_prefix_scan_grad_runs_the_scan_back_to_front(monkeypatch):
    """One forward call and one reverse call of the wrapper, inclusive or
    exclusive as the forward."""
    calls = []
    scan_rows = K3.scan_rows

    def recording(x, **kw):
        calls.append(kw)
        return scan_rows(x, **kw)

    monkeypatch.setattr(K3, "scan_rows", recording)
    x = torch.randn(4, 9, requires_grad=True)
    prefix_scan(x, exclusive=True).sum().backward()
    assert calls == [{"op": "add", "exclusive": True},
                     {"op": "add", "exclusive": True, "reverse": True}]
    with torch.no_grad():
        prefix_scan(x)
    assert len(calls) == 3  # no Function without grad


@pytest.mark.parametrize("exclusive", [False, True])
def test_reverse_scan_rows_is_the_flipped_scan(exclusive):
    x = torch.randn(3, 17, generator=torch.Generator().manual_seed(2))
    got = K3.scan_rows(x, exclusive=exclusive, reverse=True)
    want = K3.scan_rows(x.flip(-1), exclusive=exclusive).flip(-1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["max", "mul"])
def test_reverse_scan_rows_takes_the_add_scan_only(op):
    with pytest.raises(ValueError, match=op):
        K3.scan_rows(torch.zeros(2, 5), op=op, reverse=True)


@pytest.mark.parametrize("op", ["max", "mul"])
def test_max_and_mul_gradients_raise(op):
    x = torch.randn(2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match=op):
        prefix_scan(x, op=op)
    with torch.no_grad():
        assert prefix_scan(x, op=op).shape == (2, 8)
    assert prefix_scan(x.detach(), op=op).shape == (2, 8)


def test_ssd_scan_gradient_raises():
    from repro_torch.kernels import ops
    a = torch.rand(2, 6, 4)
    b = torch.randn(2, 6, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ssd_scan"):
        ops.ssd_scan(a, b)
    with torch.no_grad():
        h, last = ops.ssd_scan(a, b)
    assert h.shape == (2, 6, 4) and last.shape == (2, 4)


def test_flash_attention_gradient_raises():
    from repro_torch.kernels import ops
    q = torch.randn(2, 8, 16, requires_grad=True)
    k, v = torch.randn(2, 8, 16), torch.randn(2, 8, 16)
    with pytest.raises(NotImplementedError, match="flash_attention"):
        ops.flash_attention(q, k, v)
    assert ops.flash_attention(q.detach(), k, v).shape == (2, 8, 16)


# ---------------------------------------------------------------------------
# the models' gradients
# ---------------------------------------------------------------------------

GRAD_ARCHS = ["mamba2_130m", "smollm_360m"]


def _trainable(arch):
    """(port cfg, a fresh trainable module holding the reference's reduced
    weights): the shared ``_pair`` module stays untouched (serving tests
    in the same worker take it without grad)."""
    _, pc, params, _ = _pair(arch)
    return pc, model_params_from_numpy(jax.tree.map(np.asarray, params), pc,
                                       "cpu", trainable=True)


def _grads_pair(arch, seed=1):
    rc, pc, params, _ = _pair(arch)
    module = model_params_from_numpy(jax.tree.map(np.asarray, params), pc,
                                      "cpu", trainable=True)
    jb, tb = _batch(rc, 2, 32, seed=seed)
    lab = np.random.default_rng(seed + 1).integers(
        0, rc.vocab_size, (2, 32)).astype(np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(lab), torch.from_numpy(lab)
    from repro.models import build_model as rbuild

    (rl, _), rg = jax.jit(jax.value_and_grad(rbuild(rc).loss, has_aux=True))(
        params, jb)
    pl, _, pg = loss_and_grads(pbuild(pc), module, tb)
    return float(rl), float(pl), jax.tree.map(np.asarray, rg), pg


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    rl, pl, rg, pg = _grads_pair(arch)
    assert abs(pl - rl) <= 1e-6 * abs(rl)
    seen = set()
    for name, key, want in _port_names(rg):
        got = pg[key].numpy()
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(got - want).max())
        assert err <= 2e-4 * scale, f"{name} ({key}): {err:.3g} of {scale:.3g}"
        seen.add(key)
    assert seen == set(pg)


@pytest.mark.parametrize("arch", ["whisper_large_v3", "olmoe_1b_7b",
                                  "jamba_v01_52b"])
def test_remat_does_not_change_the_gradient(arch, monkeypatch):
    """Every remat site checkpoints while grad is enabled; the gradient is
    the one taken without checkpoints (the encoder-decoder's two stacks,
    the MoE block, the hybrid family's periods)."""
    from repro_torch.models import layers

    pc, module = _trainable(arch)
    _, tb = _batch(pc, 2, 32, seed=6)
    tb["labels"] = tb["tokens"]
    lw, _, want = loss_and_grads(pbuild(pc), module, tb)
    checkpointed = []
    remat = layers.remat

    def counting(fn, *args):
        checkpointed.append(fn)
        return remat(fn, *args)

    monkeypatch.setattr(layers, "remat", counting)
    lg, _, got = loss_and_grads(pbuild(pc), module, tb)
    assert checkpointed
    assert torch.equal(lg, lw)
    for k in want:
        assert torch.allclose(got[k], want[k], rtol=1e-6, atol=1e-8), k
    monkeypatch.setattr(layers, "remat", lambda fn, *args: fn(*args))
    _, _, plain = loss_and_grads(pbuild(pc), module, tb)
    for k in want:
        assert torch.allclose(plain[k], want[k], rtol=1e-5, atol=1e-7), k


def _k3_calls(monkeypatch):
    calls = []
    scan_rows = K3.scan_rows

    def recording(x, **kw):
        calls.append(kw.get("reverse", False))
        return scan_rows(x, **kw)

    monkeypatch.setattr(K3, "scan_rows", recording)
    return calls


def test_remat_reruns_each_mamba_layer_once(monkeypatch):
    """The reference rematerialises every layer: K3 runs 2 x layers forward
    (the layer, then its recomputation) and once back to front a layer
    under grad; once a layer without it."""
    pc, module = _trainable("mamba2_130m")
    _, tb = _batch(pc, 2, 32)
    tb["labels"] = tb["tokens"]
    calls = _k3_calls(monkeypatch)
    loss_and_grads(pbuild(pc), module, tb)
    assert (calls.count(False), calls.count(True)) == (2 * pc.num_layers,
                                                       pc.num_layers)
    calls.clear()
    with torch.inference_mode():
        pbuild(pc).loss(module, tb)
    assert calls == [False] * pc.num_layers


@pytest.mark.parametrize("arch", ["mamba2_130m", "smollm_360m"])
def test_save_block_outputs_policy_takes_the_same_gradient(arch):
    pc, module = _trainable(arch)
    _, tb = _batch(pc, 2, 32, seed=4)
    tb["labels"] = tb["tokens"]
    _, _, want = loss_and_grads(pbuild(pc), module, tb)
    before = perf_flags.FLAGS
    perf_flags.set_flags(remat_policy="save_block_outputs")
    try:
        _, _, got = loss_and_grads(pbuild(pc), module, tb)
    finally:
        perf_flags.FLAGS = before
    for k in want:
        assert torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-7), k


def test_init_mamba_state_runs_on_the_card_unless_asked():
    from repro_torch.models.mamba import init_mamba_state

    cfg = pget("mamba2_130m").reduced()
    st = init_mamba_state(cfg, 2, device="cpu")
    assert st["ssm"].device.type == "cpu" and st["ssm"].shape[0] == 2
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_mamba_state(cfg, 2)


def test_trainable_flag_and_opt_state_from_numpy():
    from repro.optim.adamw import init_opt_state as rinit

    rc, pc, params, _ = _pair("smollm_360m")
    np_params = jax.tree.map(np.asarray, params)
    frozen = model_params_from_numpy(np_params, pc, "cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    module = model_params_from_numpy(np_params, pc, "cpu", trainable=True)
    assert all(p.requires_grad for p in module.parameters())
    opt = opt_state_from_numpy(jax.tree.map(np.asarray, rinit(params)), module)
    for name, p in module.named_parameters():
        assert torch.equal(opt["master"][name], p.detach().float())
        assert opt["m"][name].dtype == torch.float32
    assert opt["count"].dtype == torch.int32 and int(opt["count"]) == 0
    bad = jax.tree.map(np.asarray, rinit(params))
    del bad["m"]["embed"]
    with pytest.raises(ValueError, match="embed"):
        opt_state_from_numpy(bad, module)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2_130m", "smollm_360m"])
def test_three_train_steps_match_the_references(arch):
    from repro.configs.base import ShapeConfig as RShape
    from repro.data.pipeline import DataConfig as RData
    from repro.data.pipeline import batches as rbatches
    from repro.launch.steps import build_train_step as rstep
    from repro.models import build_model as rbuild
    from repro.optim.adamw import AdamWConfig as RAdam
    from repro.optim.adamw import init_opt_state as rinit
    from repro.sharding.specs import Topology as RTopo

    rc, pc, params, _ = _pair(arch)
    ropt = rinit(params)
    model = model_params_from_numpy(jax.tree.map(np.asarray, params), pc,
                                    "cpu", trainable=True)
    popt = opt_state_from_numpy(jax.tree.map(np.asarray, ropt), model)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    rfn, _, _ = rstep(rbuild(rc), RTopo(mesh=None), RShape("t", 32, 4, "train"),
                      RAdam(**kw))
    pfn, _, (pspec, ospec, bspec) = build_train_step(
        pbuild(pc), Topology(mesh=None), ShapeConfig("t", 32, 4, "train"),
        AdamWConfig(**kw))
    assert set(pspec) == {n for n, _ in model.named_parameters()}
    assert set(bspec) == {"tokens", "labels"}
    rdata = rbatches(RData(vocab_size=rc.vocab_size, seq_len=32,
                           global_batch=4, seed=1))
    pdata = batches(DataConfig(vocab_size=pc.vocab_size, seq_len=32,
                               global_batch=4, seed=1))
    # the reference's step donates its params: keep the shared ones
    rp = jax.tree.map(lambda a: jnp.array(a, copy=True), params)
    for _ in range(3):
        rb, pb = next(rdata), next(pdata)
        rp, ropt, rm = rfn(rp, ropt, {k: jnp.asarray(v) for k, v in rb.items()})
        model, popt, pm = pfn(model, popt, pb)
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= \
            1e-6 * abs(float(rm["loss"]))
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= \
            2e-4 * float(rm["grad_norm"])
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    pn = dict(model.named_parameters())
    for name, key, want in _port_names(jax.tree.map(np.asarray, rp)):
        err = float(np.abs(pn[key].detach().numpy() - want).max())
        assert err <= 1e-4, f"{name}: {err:.3g}"
    assert int(popt["count"]) == 3


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py on the port
# ---------------------------------------------------------------------------


def _make_trainer(tmp_path, fail_at=(), steps_shape=(4, 32), exc_factory=None):
    cfg = pget("smollm_360m").reduced()
    api = pbuild(cfg)
    B, S = steps_shape
    shape = ShapeConfig("tiny", S, B, "train")
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                              global_batch=B, seed=1))
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5, keep_ckpts=2,
                         async_ckpt=False, max_retries=3)
    injector = FailureInjector(fail_at=tuple(fail_at), exc_factory=exc_factory)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    return Trainer(api, Topology(mesh=None), shape, data, tcfg, opt, injector,
                   device="cpu")


def test_loss_decreases(tmp_path):
    tr = _make_trainer(tmp_path)
    params, opt = tr.init_state()
    params, opt, hist = tr.run(params, opt, num_steps=25)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


def test_recovery_from_injected_failure(tmp_path):
    tr = _make_trainer(tmp_path, fail_at=(12,))
    params, opt = tr.init_state()
    params, opt, hist = tr.run(params, opt, num_steps=20)
    steps = [h["step"] for h in hist]
    # failure at 12 -> restored from ckpt at 10 -> steps 10,11 re-run
    assert steps.count(11) >= 2 or steps.count(10) >= 2
    assert max(steps) == 19
    assert len(tr.remesh_events) == 1
    assert np.mean([h["loss"] for h in hist[-3:]]) < np.mean(
        [h["loss"] for h in hist[:3]])


def test_resume_from_checkpoint(tmp_path):
    tr = _make_trainer(tmp_path)
    params, opt = tr.init_state()
    params, opt, _ = tr.run(params, opt, num_steps=10)
    # new trainer instance = process restart; resumes at step 10
    tr2 = _make_trainer(tmp_path)
    p2, o2 = tr2.init_state(seed=99)  # different init; must be overwritten
    start, p2, o2 = tr2.maybe_restore(p2, o2)
    assert start == 10
    for (n, a), (_, b) in zip(p2.named_parameters(), params.named_parameters()):
        assert torch.allclose(a, b, atol=1e-6), n
    assert int(o2["count"]) == 10


def test_multiple_failures_exhaust_retries(tmp_path):
    tr = _make_trainer(tmp_path, fail_at=(3, 4, 5, 6, 7, 8, 9))
    params, opt = tr.init_state()
    with pytest.raises(Exception):
        tr.run(params, opt, num_steps=20)


def test_recovery_from_a_distributed_runtime_error(tmp_path):
    """Not just SimulatedFailure — an error of the collective runtime-error
    family (the reference's JaxRuntimeError; a ``torch.distributed``
    error here) triggers the same recovery."""
    tr = _make_trainer(
        tmp_path, fail_at=(7,),
        exc_factory=lambda step: torch.distributed.DistError(
            f"DEADLINE_EXCEEDED: all-reduce hung at step {step}"))
    params, opt = tr.init_state()
    params, opt, hist = tr.run(params, opt, num_steps=12)
    assert max(h["step"] for h in hist) == 11
    assert len(tr.remesh_events) == 1
    assert "DEADLINE_EXCEEDED" in tr.remesh_events[0]["err"]


def test_non_failure_runtime_errors_propagate(tmp_path):
    tr = _make_trainer(
        tmp_path, fail_at=(2,),
        exc_factory=lambda step: torch.distributed.DistError(
            f"RESOURCE_EXHAUSTED: out of memory at step {step}"))
    params, opt = tr.init_state()
    with pytest.raises(torch.distributed.DistError, match="RESOURCE_EXHAUSTED"):
        tr.run(params, opt, num_steps=5)
    assert tr.remesh_events == []


def test_unrelated_errors_still_propagate(tmp_path):
    tr = _make_trainer(
        tmp_path, fail_at=(2,),
        exc_factory=lambda step: ValueError(f"bad batch at step {step}"))
    params, opt = tr.init_state()
    with pytest.raises(ValueError, match="bad batch"):
        tr.run(params, opt, num_steps=5)
    assert tr.remesh_events == []


def test_injector_stamps_lost_hosts():
    from repro_torch.runtime.fault import SimulatedFailure

    inj = FailureInjector(fail_at=(0,), lost_hosts=3)
    with pytest.raises(SimulatedFailure) as ei:
        inj.check(0)
    assert ei.value.lost_hosts == 3


# ---------------------------------------------------------------------------
# tests/test_system.py on the port, and the launcher
# ---------------------------------------------------------------------------


def test_train_then_serve(tmp_path):
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = pget("smollm_360m").reduced()
    api = pbuild(cfg)
    B, S = 4, 32
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                              global_batch=B, seed=3))
    topo = Topology(mesh=None)
    tr = Trainer(api, topo, ShapeConfig("tiny", S, B, "train"), data,
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10,
                               async_ckpt=False),
                 AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=60),
                 device="cpu")
    params, opt = tr.init_state()
    params, opt, hist = tr.run(params, opt, num_steps=30)
    losses = [h["loss"] for h in hist]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert all(np.isfinite(l) for l in losses)

    # serve the trained module with continuous batching
    eng = ServeEngine(api, params, topo, batch_size=2, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=8)
                    .astype(np.int32), max_new_tokens=6) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=200)
    for r in reqs:
        assert r.done and 1 <= len(r.generated) <= 6
        assert all(0 <= t < cfg.padded_vocab for t in r.generated)
    eng2 = ServeEngine(api, params, topo, batch_size=2, max_len=64,
                       device="cpu")
    r2 = Request(rid=9, prompt=reqs[0].prompt, max_new_tokens=6)
    eng2.submit(r2)
    eng2.run_until_drained(max_steps=200)
    assert r2.generated == reqs[0].generated


def test_mamba_system_train():
    """The SSM family end to end: K3 (its plain version here) forward and
    backward in every step's loss."""
    from repro_torch.launch.steps import trainable
    from repro_torch.optim.adamw import adamw_update, init_opt_state

    cfg = pget("mamba2_130m").reduced()
    api = pbuild(cfg)
    model = trainable(api.init(torch.Generator().manual_seed(0), device="cpu"))
    opt = init_opt_state(model)
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=4, seed=5))
    losses = []
    for _ in range(20):
        b = {k: torch.from_numpy(v) for k, v in next(data).items()}
        loss, _, grads = loss_and_grads(api, model, b)
        model, opt, _ = adamw_update(grads, opt, model, ocfg)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(l) for l in losses)


def test_launcher_trains_fails_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train

    args = ["--arch", "mamba2-130m", "--steps", "6", "--batch", "4", "--seq",
            "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    out = train.main(args + ["--fail-at", "3"])
    assert [h["step"] for h in out["history"]][-1] == 5
    assert len(out["remesh_events"]) == 1 and out["start"] == 0
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    again = train.main(args)  # a restart resumes from the last checkpoint
    assert again["start"] == 6 and again["history"] == []
    assert "resumed from checkpoint at step 6" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        train.main(args + ["--mesh", "production"])
