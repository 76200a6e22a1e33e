# Copied from src/repro/core/__init__.py; only the imports may differ.
# The paper's primary contribution: a work-stealing scheduler with
# configurable, composable, per-task scheduling strategies, plus the
# device-level (JAX/TPU) adaptations of the same decision procedures.
from .machine import MachineModel, flat_machine, pod_machine
from .metrics import SchedulerMetrics, WorkerMetrics
from .scheduler import (
    SchedulerConfig,
    StrategyScheduler,
    WorkStealingScheduler,
    finish,
    spawn,
    spawn_many,
    spawn_s,
)
from .strategy import (
    BaseStrategy,
    DepthFirstStrategy,
    FifoStrategy,
    LifoFifoStrategy,
    MergePolicy,
    MergingStrategy,
    PriorityStrategy,
    RandomStealStrategy,
    get_place,
    local_before,
    lowest_common_ancestor,
    steal_before,
)
from .task import FinishRegion, Task, TaskState
from .task_storage import DequeTaskStorage, StrategyTaskStorage

__all__ = [
    "MachineModel", "flat_machine", "pod_machine",
    "SchedulerMetrics", "WorkerMetrics",
    "SchedulerConfig", "StrategyScheduler", "WorkStealingScheduler",
    "finish", "spawn", "spawn_many", "spawn_s",
    "BaseStrategy", "DepthFirstStrategy", "FifoStrategy", "LifoFifoStrategy",
    "MergePolicy", "MergingStrategy",
    "PriorityStrategy", "RandomStealStrategy", "get_place",
    "local_before", "lowest_common_ancestor", "steal_before",
    "FinishRegion", "Task", "TaskState",
    "DequeTaskStorage", "StrategyTaskStorage",
]
