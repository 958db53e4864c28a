"""Multi-host coordinator plane: coordinator/worker split over a
serializable command protocol with pluggable transports.

See ``cluster/coordinator.py`` for the control plane,
``cluster/worker.py`` for the data plane, ``cluster/protocol.py`` for
the wire format, and ``cluster/backend.py`` for the transports.

The names load lazily (as ``repro_torch.api``'s do): ``python -m
repro_torch.cluster.worker`` imports this package first, and its worker
must claim the frame stream before the driver and its planners load.
``cluster.worker`` is not re-exported (runpy's double-import warning);
import ``WorkerRuntime`` from ``repro_torch.cluster.worker`` directly.
"""
_NAMES = {
    "ClusterBackend": "backend", "LocalBackend": "backend",
    "MultiProcessBackend": "backend", "WorkerError": "backend",
    "WorkerLost": "backend",
    "ClusterCoordinator": "coordinator", "ClusterSnapshot": "coordinator",
    "plan_insert_split": "coordinator",
    "SCHEMA_VERSION": "protocol", "ProtocolError": "protocol",
    "combine_digests": "protocol", "decode_message": "protocol",
    "encode_message": "protocol", "live_multiset_digest": "protocol",
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        import importlib
        return getattr(importlib.import_module(f".{_NAMES[name]}", __name__),
                       name)
    raise AttributeError(
        f"module 'repro_torch.cluster' has no attribute {name!r}")
