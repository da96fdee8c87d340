"""Step builders: train_step / prefill / decode with their specs (port of
``repro.launch.steps``).

Shared by the launchers (``train.py``, ``serve.py``). A step takes the
model's ``nn.Module`` where the reference takes its params pytree, and a
batch of numpy arrays (the pipeline's) or tensors, moved to the model's
device. Specs come from :mod:`repro_torch.sharding.rules`; on one card they
are metadata and placement is the identity.

Two gradient-collective paths exist for training, as in the reference:

  * :func:`build_train_step` without a mesh: the gradient is the loss's own
    (``torch.autograd.grad``), the whole batch on one device; under a mesh
    topology the model runs its mesh paths, whose collectives carry the
    gradient;
  * :func:`build_dp_train_step` — the *offloaded* path: every collective the
    application issues (gradient allreduce, metric sums, the scan-shaped
    per-rank example offset, the examples seen) is an explicit
    :class:`~repro_torch.core.packet.CollectiveDescriptor` dispatched
    through :class:`~repro_torch.offload.OffloadEngine` in driver mode.
    Built with ``engine=None`` the same step runs its collectives as raw
    ``compat.psum`` / ``pmax`` chains in the identical logical order, a
    bitwise reference for the engine path.

A training step runs in the span ``step.train``, its forward, backward and
AdamW in ``step.forward``, ``step.backward`` and ``step.optimizer``; a
prefill in ``step.prefill`` (:mod:`repro_torch.obs.tracing`).

A step turns ``requires_grad`` on for the module's parameters (serving
leaves them off and runs under ``torch.inference_mode()``) and returns the
module, updated in place by :func:`repro_torch.optim.adamw.adamw_update`.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.packet import CollType
from repro_torch.core.trees import tree_map
from repro_torch.models import ModelApi, input_specs
from repro_torch.obs import tracing as obs_tracing
from repro_torch.offload import planner
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.sharding.rules import batch_specs, cache_specs, param_specs, zero1_specs
from repro_torch.sharding.specs import Topology, plan_spec, use_topology


def module_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def batch_to(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))).to(device) for k, v in batch.items()}


def trainable(model: torch.nn.Module) -> torch.nn.Module:
    """Turn ``requires_grad`` on for every parameter of ``model``."""
    for p in model.parameters():
        if not p.requires_grad:
            p.requires_grad_(True)
    return model


def loss_and_grads(api: ModelApi, model: torch.nn.Module,
                   batch: Dict[str, torch.Tensor]):
    """``jax.value_and_grad(api.loss, has_aux=True)``: (loss, metrics,
    ``{name: grad}``), every value detached; a parameter the loss does not
    reach gets a zero gradient, as in JAX."""
    trainable(model)
    names, params = zip(*model.named_parameters())
    with torch.enable_grad():
        with obs_tracing.span("step.forward", "step"):
            loss, metrics = api.loss(model, batch)
        with obs_tracing.span("step.backward", "step"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, params, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def opt_shapes(pshapes: Dict[str, torch.Size]) -> Dict[str, Any]:
    """The optimizer state's shapes (``init_opt_state``'s, as sizes)."""
    return {"m": dict(pshapes), "v": dict(pshapes), "master": dict(pshapes),
            "count": torch.Size(())}


def build_train_step(
    api: ModelApi,
    topo: Topology,
    shape: ShapeConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    *,
    use_offload_engine: bool = False,
    engine: Any = None,
):
    """Returns (step_fn, arg_shapes, specs) for one optimizer step:
    ``step_fn(model, opt_state, batch) -> (model, new_opt_state, metrics)``.

    With ``use_offload_engine=True`` (and a mesh), the step is built by
    :func:`build_dp_train_step`: gradient/metric collectives dispatch
    through the given :class:`~repro_torch.offload.OffloadEngine` as
    planned descriptors. Without a mesh the flag is a no-op (there is
    nothing to reduce over).
    """
    opt_cfg = opt_cfg or AdamWConfig()
    if use_offload_engine and topo.mesh is not None:
        if engine is None:
            raise ValueError(
                "use_offload_engine=True requires an OffloadEngine "
                "(see repro_torch.launch.offload_runtime.build_offload_engine)"
            )
        return build_dp_train_step(api, topo, shape, opt_cfg, engine=engine)
    cfg = api.cfg

    def train_step(model, opt_state, batch):
        with obs_tracing.span("step.train", "step"):
            batch = batch_to(batch, module_device(model))
            with use_topology(topo):
                loss, metrics, grads = loss_and_grads(api, model, batch)
            with obs_tracing.span("step.optimizer", "step"):
                model, new_opt, stats = adamw_update(
                    grads, opt_state, model, opt_cfg)
            return model, new_opt, {"loss": loss, **metrics, **stats}

    pshapes = api.param_shapes()
    oshapes = opt_shapes(pshapes)
    bshapes = input_specs(cfg, shape)
    pspec = param_specs(pshapes, cfg, topo)
    zspec = zero1_specs(pspec, pshapes, topo)
    ospec = {"m": zspec, "v": dict(zspec), "master": dict(zspec),
             "count": compat.P()}
    bspec = batch_specs(bshapes, topo)
    return train_step, (pshapes, oshapes, bshapes), (pspec, ospec, bspec)


def _null_topo() -> Topology:
    # the per-rank forward runs the model's local paths
    return Topology(mesh=None, batch_axes=("data",), model_axis=None)


def build_dp_train_step(
    api: ModelApi,
    topo: Topology,
    shape: ShapeConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    *,
    engine: Any = None,
):
    """Data-parallel train step with application-issued collectives.

    Params and optimizer state are replicated; the batch is split over the
    topology's DP axes in the *plan's logical rank order* (``plan_spec``):
    logical rank ``r`` takes batch rows ``[r*b, (r+1)*b)``. Per step it
    issues four collectives:

      1. ALLREDUCE(sum) of the gradients over the DP axes,
      2. ALLREDUCE(sum) of the loss/metric stack,
      3. EXSCAN(sum) of the per-rank example count — each rank's global
         example offset, the paper's primitive on the training path,
      4. ALLREDUCE(max) of offset+count — total examples seen this step.

    The step is three programs, the paper's host/NIC split:

      * ``local`` — each rank's forward and backward on its own batch rows
        (the model's local paths), stacked ``(p, ...)`` in logical rank
        order. A co-resident mesh runs every rank, one after another (a
        model forward is not written over a rank axis); a process of a
        group runs its own and stands its value in every row (a stride-0
        ``expand``: driver mode reads a process's own row only);
      * ``collectives`` — with ``engine`` set, each collective is a
        descriptor dispatched per step through ``OffloadEngine.offload`` in
        driver mode (planned multi-axis descriptors split by
        ``planner.plan_axis_order`` when the DP span is 2-3 mesh axes): step
        1 compiles and caches the schedules, every later step is a
        plan-cache hit, and a remesh-cleared cache repopulates from these
        same descriptors. The descriptors name no ``backend``: the default
        lowering, no K1, as in the reference. With ``engine=None`` one
        ``compat.shard_map`` program runs raw ``compat.psum`` / ``pmax``
        chains, innermost logical level first — the planned ALLREDUCE phase
        order — so the two paths are bitwise comparable;
      * ``update`` — AdamW on the mean gradients (``gsum[0] / dp``).

    Requires a pure-DP mesh (``model_size == 1``).
    """
    opt_cfg = opt_cfg or AdamWConfig()
    mesh = topo.mesh
    if mesh is None:
        raise ValueError("build_dp_train_step requires a mesh topology")
    if topo.model_size > 1:
        raise ValueError(
            "the offload-engine train step is data-parallel only; "
            f"model axis has size {topo.model_size} (use the GSPMD path)"
        )
    cfg = api.cfg
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    # size-1 axes carry no collective traffic; drop them from the DP span
    dp_names = tuple(a for a in topo.batch_axes if int(sizes[a]) > 1)
    dp_sizes = tuple(int(sizes[a]) for a in dp_names)
    dp = int(np.prod(dp_sizes)) if dp_sizes else 1
    k = len(dp_names)

    pshapes = api.param_shapes()
    oshapes = opt_shapes(pshapes)
    bshapes = input_specs(cfg, shape)
    meta = api.init(torch.Generator().manual_seed(0), device="meta")
    grad_bytes = sum(p.numel() * p.element_size() for p in meta.parameters())
    del meta

    # the gradient allreduce dominates the payload, so its tuned split
    # decides the step's logical axis order — and thereby the data layout
    # every other collective (and the batch split) follows
    order = (
        planner.plan_axis_order(CollType.ALLREDUCE, dp_sizes, grad_bytes)
        if k > 1
        else tuple(range(k))
    )
    layout = planner.PlanLayout(sizes=dp_sizes, order=order) if k else None
    names_l = layout.spec_axes(dp_names) if k else ()
    sizes_l = layout.logical_sizes if k else ()
    stacked = (names_l[0] if k == 1 else names_l) if k else None

    def bspec_one(leaf):
        nd = len(leaf.shape)
        if k and nd >= 1 and leaf.shape[0] % dp == 0 and leaf.shape[0] > 1:
            return plan_spec(layout, dp_names, ndim=nd)
        return compat.P(*([None] * nd))

    bspec = {name: bspec_one(leaf) for name, leaf in bshapes.items()}
    rep = lambda tree: tree_map(lambda _: compat.P(), tree)  # noqa: E731
    pspec, ospec = rep(dict(pshapes)), rep(oshapes)
    rows = compat.own_rows(mesh, stacked) if k else [0]

    # --- program 1: per-rank fwd/bwd, stacked contributions out ----------
    def local(model, batch):
        B = next(iter(batch.values())).shape[0]
        b = B // dp
        per_rank = []
        for r in rows:
            mine = {key: (v[r * b:(r + 1) * b] if v.ndim and v.shape[0] == B
                          and B % dp == 0 and B > 1 else v)
                    for key, v in batch.items()}
            with use_topology(_null_topo()):
                loss, metrics, grads = loss_and_grads(api, model, mine)
            count = torch.tensor(float(mine["tokens"].shape[0]),
                                 device=loss.device)
            per_rank.append({"grads": grads,
                             "metrics": {"loss": loss, **metrics},
                             "count": count})
        if len(per_rank) == dp:
            return tree_map(lambda *a: torch.stack(a), *per_rank)
        (own,) = per_rank
        return tree_map(lambda a: a.unsqueeze(0).expand((dp,) + a.shape), own)

    # --- program 2: the collectives the application issues ---------------
    descs: Dict[str, Any] = {}
    if engine is not None and k > 0:
        if k > 1:
            mk = partial(engine.make_descriptor, axes=dp_sizes, split=order)
        else:
            mk = partial(engine.make_descriptor, p=dp)
        axis_arg = dp_names if k > 1 else dp_names[0]

        def collectives(stack):
            if not descs:
                # the metric stack's size is the loss's: known at step 1
                metric_bytes = 4 * len(stack["metrics"])
                descs.update(
                    grad=mk("ALLREDUCE", payload_bytes=grad_bytes, op="sum"),
                    metric=mk("ALLREDUCE", payload_bytes=metric_bytes,
                              op="sum", comm_id=1),
                    offset=mk("EXSCAN", payload_bytes=4, op="sum", comm_id=2),
                    seen=mk("ALLREDUCE", payload_bytes=4, op="max",
                            comm_id=3),
                )
            off = partial(engine.offload, axis_name=axis_arg, mesh=mesh)
            gsum = off(descs["grad"], stack["grads"])
            msum = off(descs["metric"], stack["metrics"])
            offset = off(descs["offset"], stack["count"])
            seen = off(descs["seen"], offset + stack["count"])
            return gsum, msum, seen

    elif k > 0:

        def _chain(tree, reduce_fn):
            # innermost logical level first — the planned ALLREDUCE phase
            # order, so raw and engine paths associate identically
            for name in reversed(names_l):
                tree = reduce_fn(tree, name)
            return tree

        def raw_body(stack):
            gsum = _chain(stack["grads"], compat.psum)
            msum = _chain(stack["metrics"], compat.psum)
            rank = None
            for name, size in zip(names_l, sizes_l):
                idx = compat.axis_index(name)
                rank = idx if rank is None else rank * size + idx
            count = stack["count"]
            offset = count * rank.to(count.dtype)  # equal per-rank counts
            seen = _chain(offset + count, compat.pmax)
            return gsum, msum, seen

        raw_fn = compat.shard_map(raw_body, mesh, in_specs=(stacked,),
                                  out_specs=stacked)

        def collectives(stack):
            return raw_fn(stack)

    else:

        def collectives(stack):
            return stack["grads"], stack["metrics"], stack["count"]

    # --- program 3: optimizer update on the reduced gradients ------------
    def update(model, opt_state, gsum, msum, seen):
        grads = {n: (a[0] / dp).to(a.dtype) for n, a in gsum.items()}
        mstack = {n: a[0] / dp for n, a in msum.items()}
        with obs_tracing.span("step.optimizer", "step"):
            model, new_opt, stats = adamw_update(
                grads, opt_state, model, opt_cfg)
        return model, new_opt, {**mstack, **stats, "examples_seen": seen[0]}

    def step_fn(model, opt_state, batch):
        with obs_tracing.span("step.train", "step"):
            batch = batch_to(batch, mesh.device)
            stack = local(model, batch)
            gsum, msum, seen = collectives(stack)
            return update(model, opt_state, gsum, msum, seen)

    return step_fn, (pshapes, oshapes, bshapes), (pspec, ospec, bspec)


def build_prefill_step(api: ModelApi, topo: Topology, shape: ShapeConfig):
    """``prefill(model, batch) -> (last logits, caches)`` under the
    topology, without grad."""
    cfg = api.cfg
    bshapes = input_specs(cfg, shape)
    pshapes = api.param_shapes()
    pspec = param_specs(pshapes, cfg, topo)
    bspec = batch_specs(bshapes, topo)

    def prefill(model, batch):
        with obs_tracing.span("step.prefill", "step"), \
                torch.inference_mode(), use_topology(topo):
            return api.prefill(model, batch_to(batch, module_device(model)))

    return prefill, (pshapes, bshapes), (pspec, bspec)


def build_decode_step(api: ModelApi, topo: Topology, shape: ShapeConfig):
    """``decode(model, token, cache, cache_len) -> (next token, cache)``
    under the topology, without grad."""
    cfg = api.cfg
    bshapes = input_specs(cfg, shape)  # {token, cache, cache_len}
    pshapes = api.param_shapes()
    pspec = param_specs(pshapes, cfg, topo)
    cspec = cache_specs(bshapes["cache"], cfg, topo)

    def decode(model, token, cache, cache_len):
        with torch.inference_mode(), use_topology(topo):
            return api.decode_step(model, token, cache, cache_len)

    return decode, (pshapes, bshapes), (pspec, cspec)
