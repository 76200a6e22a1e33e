# Copied from src/repro/runtime/elastic.py; only the imports may differ.
"""Elastic scaling: mesh re-shaping for training, replica autoscaling for
serving.

Training side: with checkpoint-mediated restarts (our recovery path)
resharding is simply "restore onto the new mesh's shardings" —
`reshard_plan` reports what moves so operators can reason about restart
cost.

Serving side: :class:`Autoscaler` turns the cluster's telemetry signal —
queue depth weighted by cache-hit-adjusted remaining work, i.e. the
``CacheAwareStrategy`` pricing reused at fleet scope — into scale-up/down
decisions with hysteresis.  The policy is deliberately dumb-and-stable:
proportional sizing against a per-replica backlog target, gated by
consecutive-tick counts in each direction plus a cooldown, so a single
flash-crowd spike cannot thrash the fleet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["propose_mesh_shape", "reshard_plan",
           "AutoscalePolicy", "Autoscaler"]


@dataclass(frozen=True)
class AutoscalePolicy:
    """Hysteresis-gated proportional autoscaling.

    ``target_backlog`` is the cache-adjusted backlog (tokens of uncached
    work, waiting + running) one replica should carry; the desired fleet
    size is ``ceil(total_backlog / target_backlog)`` clamped to
    ``[min_replicas, max_replicas]``.  Scaling up needs ``up_ticks``
    consecutive over-target observations, scaling down ``down_ticks``
    under-target ones (down is slower by default: adding a replica is
    cheap, draining one is not), and any action starts a ``cooldown_s``
    window during which no further action fires.  At most
    ``max_step_up`` replicas are added per decision; scale-down retires
    one replica at a time."""

    min_replicas: int = 1
    max_replicas: int = 64
    target_backlog: float = 512.0
    up_ticks: int = 2
    down_ticks: int = 8
    cooldown_s: float = 1.0
    max_step_up: int = 4

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.target_backlog <= 0:
            raise ValueError("target_backlog must be positive")
        if self.up_ticks < 1 or self.down_ticks < 1:
            raise ValueError("tick thresholds must be >= 1")


class Autoscaler:
    """Consumes periodic ``(now, alive, backlog)`` observations, emits
    replica-count deltas.  Stateful: consecutive-tick counters and the
    cooldown clock live here, so one instance drives one fleet."""

    def __init__(self, policy: Optional[AutoscalePolicy] = None):
        self.policy = policy or AutoscalePolicy()
        self._hot = 0
        self._cold = 0
        self._last_action_t: Optional[float] = None

    def desired(self, backlog_weight: float) -> int:
        p = self.policy
        want = int(math.ceil(backlog_weight / p.target_backlog))
        return min(max(want, p.min_replicas), p.max_replicas)

    def observe(self, now: float, alive: int,
                backlog_weight: float) -> int:
        """One autoscale tick.  Returns the replica delta to apply now:
        positive = add that many, -1 = retire one, 0 = hold."""
        p = self.policy
        want = self.desired(backlog_weight)
        if want > alive:
            self._hot += 1
            self._cold = 0
        elif want < alive:
            self._cold += 1
            self._hot = 0
        else:
            self._hot = 0
            self._cold = 0
        if self._last_action_t is not None \
                and now - self._last_action_t < p.cooldown_s:
            return 0
        if self._hot >= p.up_ticks and alive < p.max_replicas:
            self._last_action_t = now
            self._hot = 0
            return min(want - alive, p.max_step_up, p.max_replicas - alive)
        if self._cold >= p.down_ticks and alive > p.min_replicas:
            self._last_action_t = now
            self._cold = 0
            return -1
        return 0


def propose_mesh_shape(num_chips: int, *, model_parallel: int = 16,
                       chips_per_pod: int = 256) -> Tuple[Tuple[int, ...],
                                                          Tuple[str, ...]]:
    """Pick (pod, data, model) for an arbitrary healthy-chip count.

    Keeps the model axis fixed (parameter layout stability), fills pods of
    ``chips_per_pod``, and gives the remainder to the data axis — dropping
    chips that do not fit a whole data-parallel replica group.
    """
    if num_chips < model_parallel:
        raise ValueError("fewer chips than the model-parallel degree")
    # nearest pod count (a pod that lost hosts shrinks its data axis
    # rather than being dropped whole)
    pods = max(1, round(num_chips / chips_per_pod))
    per_pod = min(num_chips // pods, chips_per_pod)
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError("pod too small for the model-parallel degree")
    if pods > 1:
        return (pods, data, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def reshard_plan(old_shape: Dict[str, int],
                 new_shape: Dict[str, int]) -> Dict[str, str]:
    """Human-readable description of what a restore-reshard will do."""
    plan = {}
    old_dp = old_shape.get("pod", 1) * old_shape.get("data", 1)
    new_dp = new_shape.get("pod", 1) * new_shape.get("data", 1)
    if old_shape.get("model") != new_shape.get("model"):
        plan["params"] = (f"model axis {old_shape.get('model')} → "
                          f"{new_shape.get('model')}: every TP shard "
                          "re-split on restore")
    else:
        plan["params"] = "model axis unchanged: shards restore in place"
    if old_dp != new_dp:
        plan["optimizer"] = (f"ZeRO data shards {old_dp} → {new_dp}: "
                             "moment tree re-split on restore")
        plan["data"] = (f"global batch re-sharded {old_dp} → {new_dp} "
                        "hosts; pipeline state replays deterministically")
    else:
        plan["optimizer"] = "data axis unchanged"
        plan["data"] = "data sharding unchanged"
    return plan
