# Copied from src/repro/cluster/__init__.py; only the imports may differ.
"""Cluster subsystem: the paper's per-task strategies lifted to replicas.

task ↔ request, place ↔ replica, steal-half-the-work ↔ backlog migration.
The same :class:`ClusterRouter` policy object drives live ``ServingEngine``
replicas (``EngineReplica``) and the discrete-event scale simulator
(``cluster.sim``), so steal/placement strategies are evaluated at thousands
of replicas before they ever touch hardware.  ``cluster.chaos`` adds
fault-injection schedules and non-stationary arrival patterns; paired with
``runtime.elastic.Autoscaler`` the simulated fleet crashes, straggles and
resizes itself under load.
"""
from .chaos import (ArrivalPattern, ChaosSchedule, CrashEvent, FlashCrowd,
                    SlowdownEvent)
from .replica import EngineReplica, Replica
from .router import ClusterRouter, StealPolicy
from .sim import (ClassSpec, ServiceModel, SimClock, SimReplica, Simulation,
                  default_workload, offered_rate, run_cluster_sim,
                  synthetic_requests)
from .telemetry import ClusterTelemetry, LatencyHistogram

__all__ = [
    "Replica", "EngineReplica",
    "ClusterRouter", "StealPolicy",
    "SimClock", "ServiceModel", "SimReplica", "Simulation",
    "ClassSpec", "default_workload", "synthetic_requests", "offered_rate",
    "run_cluster_sim",
    "ClusterTelemetry", "LatencyHistogram",
    "ChaosSchedule", "CrashEvent", "SlowdownEvent",
    "ArrivalPattern", "FlashCrowd",
]
