"""Request scheduling for the serving engine (continuous batching under
per-request strategies)."""
from .request_scheduler import (BatchPlan, ContinuousBatcher, Request,
                                RequestState, RequestStrategy,
                                rebalance_replicas)

__all__ = ["ContinuousBatcher", "Request", "RequestStrategy", "RequestState",
           "BatchPlan", "rebalance_replicas"]
