"""Distribution: the logical mesh of the sharded plane and its
collectives, and the straggler monitor (host-side control plane)."""
from .sharding import (Mesh, all_gather, default_mesh, make_mesh, pmax,
                       psum)
from .straggler import StepTimer, StragglerMonitor

__all__ = ["Mesh", "StepTimer", "StragglerMonitor", "all_gather",
           "default_mesh", "make_mesh", "pmax", "psum"]
