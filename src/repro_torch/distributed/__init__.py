"""Distribution: the sharded plane's mesh (one ``model`` shard a device)
and its collectives, the backbone's logical-axis rules and their device
placements, and the straggler monitor (host-side control plane)."""
from .sharding import (Mesh, Placement, all_gather, batch_sharding,
                       default_mesh, gather, logical_to_spec, make_mesh,
                       make_rules, model_shards, place, pmax, psum,
                       to_named_sharding)
from .straggler import StepTimer, StragglerMonitor

__all__ = ["Mesh", "Placement", "StepTimer", "StragglerMonitor",
           "all_gather", "batch_sharding", "default_mesh", "gather",
           "logical_to_spec", "make_mesh", "make_rules", "model_shards",
           "place", "pmax", "psum", "to_named_sharding"]
