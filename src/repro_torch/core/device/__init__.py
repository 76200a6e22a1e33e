"""Device-level adaptations of the paper's strategy decisions: request
scheduling for the serving engine (continuous batching under per-request
strategies) and priority-ordered MoE dispatch with dead-task dropping and
second-choice restealing."""
from .moe_balance import (combine_expert_outputs, gather_expert_inputs,
                          priority_dispatch, route_topk)
from .request_scheduler import (BatchPlan, ContinuousBatcher, Request,
                                RequestState, RequestStrategy,
                                rebalance_replicas)

__all__ = ["route_topk", "priority_dispatch", "gather_expert_inputs",
           "combine_expert_outputs",
           "ContinuousBatcher", "Request", "RequestStrategy", "RequestState",
           "BatchPlan", "rebalance_replicas"]
