"""Elastic topology: autoscaling with burst workers and graceful drain-in.

The subsystem splits the autoscaling loop into three seams:

* :mod:`signals` — the :class:`LoadMonitor` samples admission-queue depth,
  per-tenant ledger byte rates, and realized coflow completion times into a
  bounded window; everything a policy reads comes from here.
* :mod:`policy` — pluggable :class:`ScalePolicy` deciding *whether* to scale:
  :class:`BacklogPolicy` (queue-depth / backlog-seconds thresholds with
  hysteresis and cooldown) for production, :class:`ManualPolicy` for tests
  and operators.
* :mod:`scaler` — the :class:`ElasticCoordinator` executing decisions: grows
  the :class:`~repro_torch.core.topology.NetworkTopology` with burst workers,
  bumps the plan-cache epoch so stale plans invalidate in O(1), rebalances
  queued coflows onto the widened worker set, and drains scale-in victims
  gracefully (flush staged store blocks, journal the handoff) instead of
  killing them.

The service wires the loop into ``run_pending()`` under the
``elastic="off"|"auto"|"manual"`` knob; see docs/elasticity.md.
"""
from .policy import (BacklogPolicy, HOLD, ManualPolicy, SCALE_DENIED_COOLDOWN,
                     SCALE_IN_IDLE, SCALE_IN_TTL, SCALE_OUT_BACKLOG,
                     SCALE_REASON_MANUAL, ScaleDecision, ScalePolicy)
from .scaler import ElasticCoordinator
from .signals import LoadMonitor, LoadSample

__all__ = [
    "BacklogPolicy", "ElasticCoordinator", "HOLD", "LoadMonitor",
    "LoadSample", "ManualPolicy", "SCALE_DENIED_COOLDOWN", "SCALE_IN_IDLE",
    "SCALE_IN_TTL", "SCALE_OUT_BACKLOG", "SCALE_REASON_MANUAL",
    "ScaleDecision", "ScalePolicy",
]
