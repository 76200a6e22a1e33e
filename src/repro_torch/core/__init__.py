"""The strategy scheduler's task layer (copies of ``repro/core``'s JAX-free
modules)."""
from .strategy import (BaseStrategy, DepthFirstStrategy, FifoStrategy,
                       LifoFifoStrategy, MergePolicy, MergingStrategy,
                       PriorityStrategy, RandomStealStrategy, get_place,
                       local_before, lowest_common_ancestor, steal_before)
from .task import FinishRegion, Task, TaskState
from .task_storage import DequeTaskStorage, StrategyTaskStorage

__all__ = [
    "BaseStrategy", "DepthFirstStrategy", "FifoStrategy", "LifoFifoStrategy",
    "MergePolicy", "MergingStrategy",
    "PriorityStrategy", "RandomStealStrategy", "get_place",
    "local_before", "lowest_common_ancestor", "steal_before",
    "FinishRegion", "Task", "TaskState",
    "DequeTaskStorage", "StrategyTaskStorage",
]
