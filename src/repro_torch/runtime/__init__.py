# Copied from src/repro/runtime/__init__.py; only the imports may differ.
from .fault_tolerance import (HeartbeatMonitor, SimulatedFailure,
                              StragglerDetector, TrainSupervisor)
from .elastic import (Autoscaler, AutoscalePolicy, propose_mesh_shape,
                      reshard_plan)

__all__ = ["HeartbeatMonitor", "StragglerDetector", "TrainSupervisor",
           "SimulatedFailure", "Autoscaler", "AutoscalePolicy",
           "propose_mesh_shape", "reshard_plan"]
