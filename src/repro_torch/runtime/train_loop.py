"""Fault-tolerant training driver (port of ``repro.runtime.train_loop``).

Checkpoint/restart + failure handling + elastic re-mesh + straggler watch,
composed over the step builders in :mod:`repro_torch.launch.steps`. The
loop's contract, as the reference's:

  1. every ``ckpt_every`` steps: atomic async checkpoint (params+opt+step);
  2. a step raising SimulatedFailure — or any error of the collective
     runtime-error family (``fault.RECOVERABLE_ERRORS``: a
     ``torch.distributed`` error) — triggers the planner-first recovery
     sequence: fail -> ``plan_remesh`` (lost_hosts derived from the
     failure) -> **adopt the planned sizes** -> rebuild the step on the
     smaller co-resident mesh -> ``notify_remesh`` (offload listeners clear
     plan caches and re-tune against the adopted mesh) -> restore the
     latest checkpoint -> continue (bounded retries). The offload engine's
     cleared cache then repopulates from the trainer's own descriptors on
     the next step;
  3. StragglerDetector watches step wall-times.

The model is the family's ``nn.Module`` on the trainer's device (the card
unless the caller names another; a mesh's device under a mesh), updated in
place by each step; a restore copies the checkpoint into it. A re-mesh
adopts a smaller co-resident mesh; a mesh over a process group would need
a new group of the survivors, which the port does not build (it raises).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.steps import build_train_step, trainable
from repro_torch.models import ModelApi
from repro_torch.models.model import model_device
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime import fault as fault_mod
from repro_torch.runtime.fault import (
    RECOVERABLE_ERRORS,
    FailureInjector,
    is_recoverable,
    plan_remesh,
)
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.sharding.specs import Topology, make_topology, use_topology


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_ckpts: int = 3
    max_retries: int = 3
    log_every: int = 10
    async_ckpt: bool = True
    #: route the step's gradient/metric collectives through the offload
    #: engine as planned descriptors (requires a pure-DP mesh; a no-op
    #: without a mesh)
    use_offload_engine: bool = False


class Trainer:
    def __init__(
        self,
        api: ModelApi,
        topo: Topology,
        shape: ShapeConfig,
        data_iter: Iterator[Dict[str, np.ndarray]],
        tcfg: TrainerConfig,
        opt_cfg: Optional[AdamWConfig] = None,
        injector: Optional[FailureInjector] = None,
        engine: Any = None,
        device: "torch.device | str | None" = None,
    ):
        self.api = api
        self.topo = topo
        self.shape = shape
        self.data_iter = data_iter
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.injector = injector
        self.engine = engine
        self.device = (topo.mesh.device if topo.mesh is not None and device is None
                       else model_device(device))
        self.ckpt = CheckpointManager(
            tcfg.ckpt_dir, keep=tcfg.keep_ckpts, async_write=tcfg.async_ckpt
        )
        self.straggler = StragglerDetector()
        self.remesh_events: list = []
        self._build()

    def _build(self):
        use_engine = (
            self.tcfg.use_offload_engine and self.topo.mesh is not None
        )
        if use_engine and self.engine is None:
            from repro_torch.launch.offload_runtime import build_offload_engine

            self.engine = build_offload_engine(device=self.device)
        self.step_fn, _, self.specs = build_train_step(
            self.api, self.topo, self.shape, self.opt_cfg,
            use_offload_engine=use_engine,
            engine=self.engine if use_engine else None,
        )

    def init_state(self, seed: int = 0):
        """A trainable module from ``torch.Generator().manual_seed(seed)``
        on the trainer's device, and its optimizer state."""
        model = trainable(self.api.init(torch.Generator().manual_seed(seed),
                                        device=self.device))
        return model, init_opt_state(model)

    @staticmethod
    def _tree(model, opt_state) -> Dict[str, Any]:
        return {"params": dict(model.named_parameters()), "opt": opt_state}

    def _load(self, model, opt_state, step: int):
        _, blob = self.ckpt.restore(self._tree(model, opt_state), step=step)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(blob["params"][name])
        return model, blob["opt"]

    def maybe_restore(self, params, opt_state):
        """(start step, model, opt state): the latest checkpoint copied into
        ``params`` (the module), or step 0 and the state as given."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, params, opt_state
        params, opt_state = self._load(params, opt_state, latest)
        return latest, params, opt_state

    # ------------------------------------------------------------------ run
    def run(self, params, opt_state, num_steps: int, start_step: int = 0):
        """Returns (final_params, final_opt, history). Fault-tolerant."""
        history = []
        step = start_step
        retries = 0
        while step < num_steps:
            batch = next(self.data_iter)
            t0 = time.perf_counter()
            try:
                if self.injector is not None:
                    self.injector.check(step)
                with use_topology(self.topo):
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch
                    )
                    metrics = {k: float(v) for k, v in metrics.items()}
            except RECOVERABLE_ERRORS as e:
                if not is_recoverable(e):
                    raise  # OOM / shape bugs: remeshing would mask them
                retries += 1
                if retries > self.tcfg.max_retries:
                    raise
                self._recover(e)
                step, params, opt_state = self._restore_after_failure(
                    params, opt_state
                )
                continue
            dt = time.perf_counter() - t0
            verdict = self.straggler.observe(step, dt)
            metrics["step_time_s"] = dt
            metrics["straggler_flagged"] = verdict["flagged"]
            history.append({"step": step, **metrics})
            step += 1
            if step % self.tcfg.ckpt_every == 0 or step == num_steps:
                self.ckpt.save(
                    step, self._tree(params, opt_state),
                    block=(step == num_steps),
                )
        self.ckpt.wait()
        return params, opt_state, history

    # ------------------------------------------------------------- recovery
    def _recover(self, err: Exception) -> None:
        """Planner-first elastic re-mesh: adopt what ``plan_remesh`` returns.

        Sequence: derive ``lost_hosts`` from the failure -> ``plan_remesh``
        -> adopt the planned data-axis size (every other axis is
        load-bearing and kept) -> rebuild the step on the adopted topology
        -> ``notify_remesh`` so offload listeners invalidate plan caches and
        re-tune against the mesh that was *actually* adopted.
        """
        from repro_torch.obs import events as obs_events

        obs_events.record("recovery", error=str(err)[:200])
        obs_events.auto_dump("recovery")
        mesh = self.topo.mesh
        if mesh is None:
            self.remesh_events.append({"err": str(err), "action": "none"})
            return
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        old_data = int(sizes.get("data", 1))
        rest = int(np.prod([s for a, s in sizes.items() if a != "data"]))
        lost = max(1, int(getattr(err, "lost_hosts", 1)))
        plan = plan_remesh(old_data, rest, lost_hosts=lost)
        if plan is None:
            # the data axis cannot absorb the loss: keep the topology and
            # retry from the checkpoint — run()'s max_retries bounds this
            self.remesh_events.append(
                {"err": str(err), "action": "infeasible", "lost_hosts": lost}
            )
            return
        if not mesh.coresident:
            raise NotImplementedError(
                "re-meshing a process group needs a new group of the "
                "surviving ranks; the trainer re-meshes co-resident meshes")
        new_data = int(plan[0])
        old_axes = tuple(int(s) for s in mesh.shape)
        new_sizes = {**sizes, "data": new_data}
        new_shape = tuple(int(new_sizes[a]) for a in mesh.axis_names)
        new_mesh = compat.Mesh(new_shape, mesh.axis_names, device=mesh.device)
        self.topo = make_topology(new_mesh)
        self._build()
        # adopt + rebuild first, *then* tell the offload layer: plan caches
        # and the tuning grid are invalidated against the adopted topology
        fault_mod.notify_remesh(old_axes, new_shape)
        self.remesh_events.append(
            {"err": str(err), "old_data": old_data, "new_data": new_data,
             "plan": plan, "adopted": new_shape, "lost_hosts": lost}
        )

    def _restore_after_failure(self, params, opt_state):
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            params, opt_state = self.init_state(0)
            return 0, params, opt_state
        params, opt_state = self._load(params, opt_state, latest)
        return latest, params, opt_state
