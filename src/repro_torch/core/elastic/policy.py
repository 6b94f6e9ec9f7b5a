"""Scale policies: when to grow, when to drain, when to hold.

A policy turns :class:`~repro_torch.core.elastic.signals.LoadMonitor` readings into
:class:`ScaleDecision` values; the :class:`ElasticCoordinator` executes them.
Decisions carry machine-checkable reason codes (the same strings ``explain()``
and the scale journal surface), so every scale event is attributable to the
signal that caused it.

:class:`BacklogPolicy` is the production shape — threshold triggers with the
two classic anti-flap guards:

* **cooldown** — after any scale event, further scaling is *denied* (with
  reason :data:`SCALE_DENIED_COOLDOWN`) until ``cooldown_s`` modelled seconds
  pass, so one burst cannot thrash the topology; and
* **hysteresis** — scale-in requires ``hysteresis`` *consecutive* idle polls,
  so a gap between two back-to-back batches never drains the workers the
  second batch is about to use.

:class:`ManualPolicy` queues operator-requested decisions and replays them at
coflow boundaries — the deterministic driver for tests and benchmarks.
"""
from __future__ import annotations

import dataclasses

from .signals import LoadMonitor

# Reason codes (stable strings: journal records, explain() reports, and the
# doctor timeline all carry them verbatim).
SCALE_OUT_BACKLOG = "scale_out_backlog"
SCALE_IN_IDLE = "scale_in_idle"
SCALE_IN_TTL = "scale_in_ttl"
SCALE_DENIED_COOLDOWN = "scale_denied_cooldown"
SCALE_REASON_MANUAL = "manual"


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """What the policy wants done, and why.

    ``action`` is one of ``"grow"`` (add ``groups`` burst groups),
    ``"shrink"`` (drain ``workers``, or the newest burst workers when empty),
    ``"hold"`` (nothing to do), or ``"deny"`` (a scale *would* have fired but
    a guard suppressed it — recorded so operators can see the suppression).
    """

    action: str
    reason: str = ""
    groups: int = 0
    workers: tuple = ()


HOLD = ScaleDecision(action="hold")


class ScalePolicy:
    """Base policy: always hold.  Subclasses override the two hooks.

    ``evaluate`` runs at every coflow boundary inside a ``run_pending`` pass
    (including index 0, before the first coflow); ``idle`` runs when a pass
    finds the queue empty and at the end of every pass — the only points
    where scale-in is safe without preempting running work.
    """

    def evaluate(self, monitor: LoadMonitor, *, pending_coflows: int,
                 executed_coflows: int, at_capacity: bool, has_burst: bool,
                 now: float) -> ScaleDecision:
        return HOLD

    def idle(self, monitor: LoadMonitor, *, has_burst: bool,
             now: float) -> ScaleDecision:
        return HOLD

    def note_scaled(self, now: float) -> None:
        """Coordinator callback after a decision was executed (cooldown
        anchor)."""


class BacklogPolicy(ScalePolicy):
    """Threshold policy: grow on backlog, drain after sustained idleness.

    Grows (one decision per boundary, ``groups`` groups at a time) when the
    number of pending coflows reaches ``backlog_coflows``, or — once realized
    CCTs exist — when the monitor's estimated backlog reaches
    ``backlog_seconds``.  Shrinks the burst workers after ``hysteresis``
    consecutive idle polls.  Both directions share one ``cooldown_s`` window
    keyed to modelled time.
    """

    def __init__(self, *, backlog_coflows: int = 4,
                 backlog_seconds: float | None = None, groups: int = 1,
                 cooldown_s: float = 0.0, hysteresis: int = 2):
        if backlog_coflows < 1:
            raise ValueError(f"backlog_coflows must be >= 1: {backlog_coflows}")
        if groups < 1:
            raise ValueError(f"groups must be >= 1: {groups}")
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1: {hysteresis}")
        self.backlog_coflows = backlog_coflows
        self.backlog_seconds = backlog_seconds
        self.groups = groups
        self.cooldown_s = cooldown_s
        self.hysteresis = hysteresis
        self._last_scale: float | None = None
        self._idle_streak = 0

    def _cooling(self, now: float) -> bool:
        return (self._last_scale is not None
                and now - self._last_scale < self.cooldown_s)

    def evaluate(self, monitor: LoadMonitor, *, pending_coflows: int,
                 executed_coflows: int, at_capacity: bool, has_burst: bool,
                 now: float) -> ScaleDecision:
        self._idle_streak = 0
        backlogged = pending_coflows >= self.backlog_coflows
        if not backlogged and self.backlog_seconds is not None:
            backlogged = monitor.backlog_seconds() >= self.backlog_seconds
        if not backlogged or at_capacity:
            return HOLD
        if self._cooling(now):
            return ScaleDecision(action="deny", reason=SCALE_DENIED_COOLDOWN)
        return ScaleDecision(action="grow", reason=SCALE_OUT_BACKLOG,
                             groups=self.groups)

    def idle(self, monitor: LoadMonitor, *, has_burst: bool,
             now: float) -> ScaleDecision:
        if not has_burst:
            self._idle_streak = 0
            return HOLD
        self._idle_streak += 1
        if self._idle_streak < self.hysteresis:
            return HOLD
        if self._cooling(now):
            return ScaleDecision(action="deny", reason=SCALE_DENIED_COOLDOWN)
        return ScaleDecision(action="shrink", reason=SCALE_IN_IDLE)

    def note_scaled(self, now: float) -> None:
        self._last_scale = now
        self._idle_streak = 0


class ManualPolicy(ScalePolicy):
    """Operator-queued decisions, replayed at coflow boundaries.

    ``request(decision, after_coflows=k)`` arms a decision that fires at the
    first boundary where at least ``k`` coflows of the current pass have
    executed — ``after_coflows=1`` means "between the first and second
    coflow", the mid-batch scale-out tests are built on it.  ``idle`` pops
    any armed decision regardless of its threshold (the pass is over; there
    is no later boundary to wait for).
    """

    def __init__(self):
        self._requests: list[tuple[int, ScaleDecision]] = []

    def request(self, decision: ScaleDecision, after_coflows: int = 0) -> None:
        if decision.action not in ("grow", "shrink"):
            raise ValueError(f"unknown manual action: {decision.action!r}")
        self._requests.append((int(after_coflows), decision))

    def evaluate(self, monitor: LoadMonitor, *, pending_coflows: int,
                 executed_coflows: int, at_capacity: bool, has_burst: bool,
                 now: float) -> ScaleDecision:
        for i, (after, d) in enumerate(self._requests):
            if executed_coflows >= after:
                del self._requests[i]
                return d
        return HOLD

    def idle(self, monitor: LoadMonitor, *, has_burst: bool,
             now: float) -> ScaleDecision:
        if self._requests:
            _, d = self._requests.pop(0)
            return d
        return HOLD
