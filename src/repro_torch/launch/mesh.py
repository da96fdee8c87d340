"""Production and smoke meshes (port of ``repro.launch.mesh``).

The reference's production mesh is a v5e pod, 16x16 = 256 chips, or two
pods stacked on a ``pod`` axis (512), one rank a chip. The port's is a
:class:`repro_torch.compat.Mesh` over a ``torch.distributed`` group of that
many processes; on fewer it raises, naming the ranks it is short of. The
smoke mesh puts co-resident ranks on one device, all on ``data``. Both are
functions, so importing this module touches no device.
"""

from __future__ import annotations

import math

from repro_torch.compat import Mesh
from repro_torch.core.trees import checked_device
from repro_torch.sharding.specs import Topology, make_topology


def production_shape(*, multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """One rank a process over the default process group, which must hold
    exactly 256 (512 with ``multi_pod``) ranks; raises otherwise."""
    import torch.distributed as dist

    shape, names = production_shape(multi_pod=multi_pod)
    need = math.prod(shape)
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)
    if have != need:
        short = f"{need - have} short" if have < need else f"{have - need} over"
        raise RuntimeError(
            f"the production mesh {shape} {names} needs {need} ranks, one a "
            f"process; this run has {have} ({short})")
    return Mesh(shape, names, device=device, group=dist.group.WORLD)


def make_smoke_mesh(ranks: int = 1, device=None) -> Mesh:
    """``ranks`` co-resident ranks on ``device`` (the card unless the caller
    names another), all on the data axis: shape ``(ranks, 1)`` over
    ``("data", "model")``."""
    device = checked_device("cuda" if device is None else device,
                            "make_smoke_mesh(device='cuda')")
    return Mesh((int(ranks), 1), ("data", "model"), device=device)


def production_topology(*, multi_pod: bool = False, device=None) -> Topology:
    return make_topology(make_production_mesh(multi_pod=multi_pod,
                                              device=device))
