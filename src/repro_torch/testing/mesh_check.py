"""Cases of the rank-group collectives and :func:`block_shard_map` under
either kind of rank group (``repro_torch.compat``'s ``psum``, ``pmax``,
``pmean``, ``all_to_all`` and the block-spec ``shard_map``).

Every :class:`Case` is one region over a ``(2, 2)`` mesh ``("data",
"model")``: a seeded global input split by ``in_spec``, one collective over
one axis or a tuple of axes, joined by ``out_spec``. :func:`run_cases`
runs them all on a :class:`~repro_torch.compat.Mesh` of either kind;
``tests/test_torch_mesh_collectives.py`` holds the two kinds bitwise equal
and both against ``lax``'s collectives under the reference's
``shard_map``.

    python -m repro_torch.testing.mesh_check WORKDIR

runs every case, and the model code's regions (:func:`run_regions`), in 4
processes joined in one gloo group (a ``file://`` store under ``WORKDIR``)
and co-resident on the CPU, and prints ALL-OK when the two agree bitwise.
"""

from __future__ import annotations

import dataclasses
import sys
import zlib
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

MESH = ((2, 2), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    op: str                   # psum | pmax | pmean | all_to_all | identity
    axes: Any                 # an axis name or a tuple of them
    shape: Tuple[int, ...]    # the global input's shape
    in_spec: Tuple[Any, ...]
    out_spec: Tuple[Any, ...]
    dtype: str = "float32"
    split: int = 0            # all_to_all's dims of the per-rank block
    concat: int = 0


def _cases() -> List[Case]:
    blocks = ("data", "model", None)
    out = []
    for op in ("psum", "pmax", "pmean"):
        for dtype in ("float32", "int32") if op != "pmean" else ("float32",):
            for axes, spec in (("model", ("data", None, None)),
                               ("data", (None, "model", None)),
                               (("data", "model"), ()),
                               (("model", "data"), ())):
                name = f"{op}:{','.join(np.atleast_1d(axes))}:{dtype}"
                out.append(Case(name, op, axes, (4, 6, 3), blocks, spec,
                                dtype))
    flat = (("data", "model"),)
    for axes in ("model", "data", ("data", "model"), ("model", "data")):
        for split, concat in ((0, 1), (1, 0), (0, 0), (1, 2)):
            name = f"all_to_all:{','.join(np.atleast_1d(axes))}:{split}:{concat}"
            out.append(Case(name, "all_to_all", axes, (16, 4, 3), flat, flat,
                            split=split, concat=concat))
    for in_spec, out_spec in (((), ("model",)),
                              ((("model", "data"), None),
                               (("model", "data"), None)),
                              ((None, "data"), ("model", "data")),
                              (("data",), ())):
        name = f"identity:{in_spec}->{out_spec}"
        out.append(Case(name, "identity", (), (4, 8), in_spec, out_spec))
    return out


CASES = _cases()


def case_input(case: Case) -> np.ndarray:
    """The case's seeded global input: integers, plus a fraction in
    float32 (so a sum's rounding depends on its order)."""
    rng = np.random.default_rng(zlib.crc32(case.name.encode()))
    x = rng.integers(-50, 50, size=case.shape)
    if case.dtype == "float32":
        x = x + rng.random(size=case.shape)
    return x.astype(case.dtype)


def run_case(case: Case, mesh):
    """The case's global result on ``mesh`` (either kind of rank group), on
    the CPU."""
    import torch

    from repro_torch import compat
    from repro_torch.compat import P

    def region(x):
        if case.op == "all_to_all":
            # the region's leaves carry their rank rows first
            return compat.all_to_all(x, case.axes, case.split + 1,
                                     case.concat + 1)
        if case.op == "identity":
            return x
        return getattr(compat, case.op)(x, case.axes)

    x = torch.from_numpy(case_input(case)).to(mesh.device)
    run = compat.block_shard_map(region, mesh, (P(*case.in_spec),),
                                 P(*case.out_spec))
    return run(x).cpu()


def run_cases(mesh) -> Dict[str, Any]:
    return {case.name: run_case(case, mesh) for case in CASES}


#: the model regions run by :func:`run_regions`
REGIONS = ("decode_seq", "explicit_tp_attention", "explicit_tp_mlp")


def run_regions(mesh) -> Dict[str, Any]:
    """The model code's regions on ``mesh`` (float32, weights from a torch
    seed, inputs from a numpy seed): sequence-sharded decode attention
    (``cached_attention(kv_mode="seq")``, a cache of 16 positions, the new
    token at 5) and, under the ``explicit_tp`` flag, ``attention_block``
    (reduced Qwen2.5-14B: one kv head, replicated) and ``mlp_block``. Each
    name of :data:`REGIONS` -> its outputs, on the CPU."""
    import torch

    from repro_torch import perf_flags
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.sharding import make_topology, use_topology

    cfg = get_config("qwen25_14b").reduced()
    gen = torch.Generator().manual_seed(0)
    attn = L.Attention(gen, cfg, torch.float32, mesh.device)
    mlp = L.MLP(gen, cfg.d_model, cfg.d_ff, torch.float32, mesh.device)
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            mesh.device)

    hd = cfg.resolved_head_dim
    x1, x = draw(2, 1, cfg.d_model), draw(2, 8, cfg.d_model)
    kc, vc = draw(2, 16, cfg.num_kv_heads, hd), draw(2, 16, cfg.num_kv_heads, hd)
    positions = torch.arange(8, device=mesh.device).expand(2, 8)
    out: Dict[str, Any] = {}
    saved = perf_flags.FLAGS
    try:
        with use_topology(make_topology(mesh)):
            out["decode_seq"] = L.cached_attention(attn, x1, kc, vc, 5, cfg,
                                                   kv_mode="seq")
            perf_flags.set_flags(explicit_tp=True)
            out["explicit_tp_attention"] = (
                L.attention_block(attn, x, positions, cfg),)
            out["explicit_tp_mlp"] = (L.mlp_block(mlp, x, cfg.act),)
    finally:
        perf_flags.FLAGS = saved
    return {k: tuple(a.cpu() for a in v) for k, v in out.items()}


def run_gloo(workdir, *, timeout: float = 120.0) -> Dict[str, Any]:
    """Every case and region in 4 processes joined in one gloo group: rank
    0's global results."""
    from repro_torch.testing.spmd_check import spawn_gloo

    return spawn_gloo("repro_torch.testing.mesh_check", ["--worker"],
                      int(np.prod(MESH[0])), workdir, timeout=timeout)


def main(argv: List[str]) -> int:
    if argv[:1] == ["--worker"]:
        from repro_torch.testing.spmd_check import gloo_worker

        def body(make_mesh):
            mesh = make_mesh(*MESH)
            return {**run_cases(mesh), **run_regions(mesh)}

        gloo_worker(int(argv[1]), int(argv[3]), Path(argv[2]), body)
        return 0
    import torch

    from repro_torch import compat

    got = run_gloo(argv[0])
    mesh = compat.Mesh(*MESH, device="cpu")
    want = run_cases(mesh)
    regions = run_regions(mesh)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    bad += [k for k in regions
            if not all(map(torch.equal, got[k], regions[k]))]
    for name in bad:
        print(f"mesh_check,{name},gloo != co-resident")
    print(f"mesh_check,cases,{len(want)},regions,{len(regions)}")
    if bad:
        return 1
    print("ALL-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
