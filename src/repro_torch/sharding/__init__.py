"""Topology context of the model code and the partition-spec rules (port of
``repro.sharding``)."""

from repro_torch.sharding.specs import (
    Topology,
    current_topology,
    make_topology,
    shard,
    use_topology,
)

__all__ = ["Topology", "current_topology", "make_topology", "shard",
           "use_topology"]
