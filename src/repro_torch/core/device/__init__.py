"""Device-level adaptations of the paper's strategy decisions: request
scheduling for the serving engine (continuous batching under per-request
strategies), priority-ordered MoE dispatch with dead-task dropping and
second-choice restealing, and weighted steal-half-work balancing."""
from .moe_balance import (combine_expert_outputs, gather_expert_inputs,
                          priority_dispatch, route_topk)
from .request_scheduler import (BatchPlan, ContinuousBatcher, Request,
                                RequestState, RequestStrategy,
                                rebalance_replicas)
from .weighted_partition import (greedy_weighted_partition, partition_cost,
                                 steal_half_transfers)

__all__ = ["route_topk", "priority_dispatch", "gather_expert_inputs",
           "combine_expert_outputs",
           "greedy_weighted_partition", "steal_half_transfers",
           "partition_cost",
           "ContinuousBatcher", "Request", "RequestStrategy", "RequestState",
           "BatchPlan", "rebalance_replicas"]
