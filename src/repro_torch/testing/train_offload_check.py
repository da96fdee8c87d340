"""End-to-end validation of the offloaded training path on a data-parallel
mesh (counterpart of ``repro.testing.train_offload_check``).

    python -m repro_torch.testing.train_offload_check [pod data] [--steps N]
        [--bench-iters N] [--device cpu|cuda] [--gloo WORKDIR]

Three scenarios, as the reference's, on co-resident meshes on the device
(the card unless ``--device cpu``):

  1. **Bitwise step equivalence** — ``--steps`` steps (at least 2) of
     ``build_dp_train_step`` on a ``(pod, data)`` mesh with the gradient
     allreduce / metric sums / example EXSCAN dispatched through
     ``OffloadEngine`` planned descriptors, against the identically
     structured raw ``compat.psum`` step: loss, grad_norm and every updated
     parameter equal bit for bit, the step-2 dispatch of every descriptor a
     plan-cache hit, and ``examples_seen`` the global batch. With ``--gloo``
     the same scenario also runs in ``pod * data`` processes joined in one
     gloo group on the CPU (each process takes its own batch rows), engine
     against raw bitwise there too.
  2. **Planner-first recovery** — a Trainer on the same mesh with an
     injected failure: the adopted mesh equals ``plan_remesh``'s output,
     the notify-remesh hook clears the engine's plan cache, and the cache
     repopulates from the trainer's own descriptors on the next step.
  3. **Plan-not-halving** — a (data=4, model=1) mesh losing 3 hosts: the
     adopted data axis is the planner's floor-pow2 answer (1), not the
     halving (2).

The model is the reduced SmolLM-360M at (8, 32), as the reference's;
:func:`bitwise_scenario` also takes another architecture at full width
(``chip_smoke.py`` runs Mamba2-130m). Prints ``trainer_offload`` and
``trainer_step`` CSV rows and ALL-OK; exits nonzero on a mismatch.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

AXES = (2, 2)


@dataclasses.dataclass
class Report:
    """Check results, ``(name, ok)``, and CSV rows, in order."""

    checks: List[Tuple[str, bool]] = dataclasses.field(default_factory=list)
    rows: List[str] = dataclasses.field(default_factory=list)
    values: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def check(self, name: str, ok: bool) -> None:
        self.checks.append((name, bool(ok)))

    @property
    def ok(self) -> bool:
        return all(ok for _, ok in self.checks)


def setup(mesh, *, arch: str = "smollm_360m", full: bool = False,
          dtype: Optional[str] = None, batch: int = 8, seq: int = 32,
          seed: int = 0):
    """(api, topology, shape, data iterator) for a run on ``mesh``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.models import build_model
    from repro_torch.sharding import make_topology

    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    api = build_model(cfg)
    shape = ShapeConfig("tiny", seq, batch, "train")
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch, seed=seed))
    return api, make_topology(mesh), shape, data


def _tree_equal(torch, a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic kernels (an embedding's gradient sums without
    atomics) for the span of a bitwise comparison on the card."""
    before = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn)


def bitwise_scenario(mesh, device, *, steps: int = 2, bench_iters: int = 0,
                     **setup_kw) -> Report:
    """Engine-dispatched DP step against the raw ``compat`` step, bit for
    bit, on ``mesh`` (co-resident, or a process group's)."""
    import torch

    from repro_torch.launch.offload_runtime import build_offload_engine
    from repro_torch.launch.steps import build_dp_train_step, trainable
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    rep = Report()
    api, topo, shape, data = setup(mesh, **setup_kw)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    eng = build_offload_engine(retune_on_remesh=False, device=device)
    raw_fn, _, _ = build_dp_train_step(api, topo, shape, opt, engine=None)
    off_fn, _, _ = build_dp_train_step(api, topo, shape, opt, engine=eng)

    # fresh, identical state per path: a step updates its module in place
    def fresh_state():
        model = trainable(api.init(torch.Generator().manual_seed(0),
                                   device=device))
        return model, init_opt_state(model)

    p_raw, o_raw = fresh_state()
    p_off, o_off = fresh_state()
    bitwise = True
    step2_hit = True
    with deterministic(torch):
        for s in range(max(2, steps)):
            batch = next(data)
            misses0, hits0 = eng.telemetry.misses, eng.telemetry.hits
            p_off, o_off, m_off = off_fn(p_off, o_off, batch)
            p_raw, o_raw, m_raw = raw_fn(p_raw, o_raw, batch)
            d_miss = eng.telemetry.misses - misses0
            d_hit = eng.telemetry.hits - hits0
            same = (
                _tree_equal(torch, dict(p_off.named_parameters()),
                            dict(p_raw.named_parameters()))
                and torch.equal(m_off["loss"], m_raw["loss"])
                and torch.equal(m_off["grad_norm"], m_raw["grad_norm"])
            )
            bitwise &= same
            if s == 0:
                # step 1 compiles; descriptors whose plans converge may
                # share one schedule within the step
                rep.check("step1 dispatches compile (miss)", d_miss > 0)
            else:
                step2_hit &= d_miss == 0 and d_hit > 0
            rep.values.setdefault("loss", []).append(float(m_off["loss"]))
            rep.rows.append(
                f"trainer_offload,step,{s + 1},misses,{d_miss},hits,{d_hit},"
                f"bitwise,{int(same)},loss,{float(m_off['loss']):.6f},"
                f"examples_seen,{float(m_off['examples_seen']):.0f}")
    rep.check("loss/grads/params bitwise == raw", bitwise)
    rep.check("step2+ dispatch is a plan-cache hit", step2_hit)
    rep.check("examples_seen == global batch",
              float(m_off["examples_seen"]) == shape.global_batch)
    rep.values["params"] = {k: v.detach().cpu()
                            for k, v in p_off.named_parameters()}

    if bench_iters > 0:
        for label, fn in (("raw_lax", raw_fn), ("offload_engine", off_fn)):
            p, o = fresh_state()
            batch = next(data)
            p, o, _ = fn(p, o, batch)  # warm the caches
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(bench_iters):
                p, o, m = fn(p, o, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = (time.perf_counter() - t0) / bench_iters
            rep.values[f"{label}_ms"] = dt * 1e3
            rep.rows.append(f"trainer_step,{label},{dt * 1e3:.1f}")
            del p, o
    snap = eng.telemetry.snapshot()
    rep.rows.append(
        f"trainer_offload_summary,bitwise_equal,{int(bitwise)},"
        f"step2_cache_hit,{int(step2_hit)},cache_size,{snap['cache_size']},"
        f"hit_rate,{snap['hit_rate']:.2f}")
    return rep


def _trainer(api, topo, shape, data, device, ckpt_dir, eng, lost_hosts):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    return Trainer(
        api, topo, shape, data,
        TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=1, async_ckpt=False,
                      use_offload_engine=True),
        AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
        injector=FailureInjector(fail_at=(1,), lost_hosts=lost_hosts),
        engine=eng, device=device,
    )


def recovery_scenario(device, axes: Tuple[int, int] = AXES) -> Report:
    """Injected failure under the offload trainer: planner-first remesh."""
    from repro_torch import compat
    from repro_torch.launch.offload_runtime import (
        build_offload_engine,
        detach_remesh_hook,
    )
    from repro_torch.runtime.fault import plan_remesh

    rep = Report()
    api, topo, shape, data = setup(
        compat.Mesh(axes, ("pod", "data"), device=device))
    eng = build_offload_engine(retune_on_remesh=True,
                               remesh_tune_budget_s=0.2, device=device)
    try:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            tr = _trainer(api, topo, shape, data, device, ckpt_dir, eng, 1)
            params, opt_state = tr.init_state()
            tr.run(params, opt_state, num_steps=3)
        ev = tr.remesh_events[-1]
        want_plan = plan_remesh(axes[1], axes[0], lost_hosts=1)
        adopted = dict(zip(tr.topo.mesh.axis_names, tr.topo.mesh.shape))
        rep.check("remesh event records the plan", ev.get("plan") == want_plan)
        rep.check("adopted mesh == plan_remesh output",
                  adopted["data"] == want_plan[0]
                  and ev.get("adopted") == (axes[0], want_plan[0]))
        # notify cleared the cache *after* rebuild; the next step's own
        # descriptors repopulated it on the surviving topology
        rep.check("plan cache repopulated after remesh", eng.cache_size() > 0)
        rep.check("post-remesh steps keep dispatching",
                  eng.telemetry.dispatches > 0 and eng.telemetry.errors == 0)
    finally:
        detach_remesh_hook(eng)
    return rep


def plan_not_halving_scenario(device) -> Report:
    """data=4, lost_hosts=3: the planner says 1; naive halving said 2."""
    from repro_torch import compat
    from repro_torch.launch.offload_runtime import (
        build_offload_engine,
        detach_remesh_hook,
    )
    from repro_torch.runtime.fault import plan_remesh

    rep = Report()
    api, topo, shape, data = setup(
        compat.Mesh((4, 1), ("data", "model"), device=device))
    eng = build_offload_engine(retune_on_remesh=True,
                               remesh_tune_budget_s=0.2, device=device)
    try:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            tr = _trainer(api, topo, shape, data, device, ckpt_dir, eng, 3)
            params, opt_state = tr.init_state()
            tr.run(params, opt_state, num_steps=3)
        want = plan_remesh(4, 1, lost_hosts=3)  # (1, 1) — not 4 // 2
        got = dict(zip(tr.topo.mesh.axis_names, tr.topo.mesh.shape))
        rep.check("adopted plan beats naive halving",
                  want == (1, 1) and got["data"] == 1 and got["data"] != 4 // 2)
        rep.check("remesh event carries lost_hosts",
                  tr.remesh_events[-1].get("lost_hosts") == 3)
    finally:
        detach_remesh_hook(eng)
    return rep


# ---------------------------------------------------------------------------
# the gloo run
# ---------------------------------------------------------------------------


def _gloo_body(axes, steps) -> Callable:
    def body(make_mesh) -> Dict[str, Any]:
        import torch

        rep = bitwise_scenario(make_mesh(axes, ("pod", "data")),
                               torch.device("cpu"), steps=steps)
        return {"ok": torch.tensor([ok for _, ok in rep.checks]),
                "names": [n for n, _ in rep.checks],
                "loss": torch.tensor(rep.values["loss"], dtype=torch.float64),
                **{f"param.{k}": v for k, v in rep.values["params"].items()}}

    return body


def run_gloo(workdir, axes: Tuple[int, int] = AXES, steps: int = 2, *,
             timeout: float = 120.0) -> Dict[str, Any]:
    """The bitwise scenario in ``pod * data`` processes joined in one gloo
    group: rank 0's checks, losses and final parameters."""
    from repro_torch.testing.spmd_check import spawn_gloo

    return spawn_gloo(
        "repro_torch.testing.train_offload_check",
        ["--worker", str(axes[0]), str(axes[1]), str(steps)],
        int(np.prod(axes)), workdir, timeout=timeout)


def main(argv: List[str]) -> int:
    if argv[:1] == ["--worker"]:
        from repro_torch.testing.spmd_check import gloo_worker

        axes, steps = (int(argv[1]), int(argv[2])), int(argv[3])
        p, workdir, rank = int(argv[4]), Path(argv[5]), int(argv[6])
        gloo_worker(p, rank, workdir, _gloo_body(axes, steps))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("axes", nargs="*", type=int, default=list(AXES))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--bench-iters", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--gloo", default=None, metavar="WORKDIR",
                    help="also run the bitwise scenario in a gloo group")
    args = ap.parse_args(argv)
    axes = tuple(args.axes)

    from repro_torch import compat
    from repro_torch.models.model import model_device

    device = model_device(args.device)
    reports = [
        bitwise_scenario(compat.Mesh(axes, ("pod", "data"), device=device),
                         device, steps=args.steps,
                         bench_iters=args.bench_iters),
        recovery_scenario(device, axes),
        plan_not_halving_scenario(device),
    ]
    checks = [c for r in reports for c in r.checks]
    if args.gloo:
        got = run_gloo(args.gloo, axes, args.steps)
        checks += [(f"gloo: {name}", bool(ok))
                   for name, ok in zip(got["names"], got["ok"].tolist())]
    for r in reports:
        for row in r.rows:
            print(row)
    for name, ok in checks:
        print(f"train_offload {name:38s} {'OK' if ok else 'FAIL'}")
    if not all(ok for _, ok in checks):
        print(f"FAILURES: {sum(not ok for _, ok in checks)}")
        return 1
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
