"""Distribution: the logical mesh of the sharded plane and its
collectives, the backbone's logical-axis rules, and the straggler
monitor (host-side control plane)."""
from .sharding import (Mesh, all_gather, default_mesh, logical_to_spec,
                       make_mesh, make_rules, pmax, psum)
from .straggler import StepTimer, StragglerMonitor

__all__ = ["Mesh", "StepTimer", "StragglerMonitor", "all_gather",
           "default_mesh", "logical_to_spec", "make_mesh", "make_rules",
           "pmax", "psum"]
