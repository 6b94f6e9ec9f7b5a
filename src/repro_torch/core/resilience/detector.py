"""Failure detection and classification (paper §5.2/§6, FuxiShuffle-style).

The simulated substrate exposes the same raw signals a production shuffle
service has: which worker processes are gone (``LocalCluster.failed_workers``
— populated both by operator injection and by mid-shuffle deaths), which are
crawling (``LocalCluster.worker_delays``), and what the manager's journal says
about progress (``ShuffleManager.stragglers`` / ``progress``).  The detector
fuses them into one :class:`FailureReport` that classifies every suspect
participant as **dead** (process unreachable — needs restart + replay) or
**slow** (alive but lagging — a speculation candidate), so the recovery
coordinator and the speculation policy act on one consistent diagnosis
instead of each re-reading raw cluster state.
"""
from __future__ import annotations

import dataclasses

from ..manager import ShuffleManager
from ..primitives import LocalCluster

DEAD = "dead"
SLOW = "slow"
HEALTHY = "healthy"


@dataclasses.dataclass(frozen=True)
class FailureReport:
    """One shuffle attempt's diagnosis; attached to ``ShuffleAborted.report``."""

    shuffle_id: int
    dead: tuple[int, ...] = ()                  # unreachable: restart + replay
    slow: tuple[tuple[int, float], ...] = ()    # (wid, known delay s): speculate
    stragglers: tuple[int, ...] = ()            # journal-observed laggards
    pending: tuple[int, ...] = ()               # started but never finished

    @property
    def slow_workers(self) -> tuple[int, ...]:
        return tuple(w for w, _ in self.slow)

    @property
    def kind(self) -> str:
        if self.dead and self.slow:
            return "mixed"
        if self.dead:
            return DEAD
        if self.slow or self.stragglers:
            return SLOW
        return "none"

    def to_info(self) -> dict:
        """JSON-serializable form for the manager journal."""
        return {
            "kind": self.kind,
            "dead": list(self.dead),
            "slow": [[w, d] for w, d in self.slow],
            "stragglers": list(self.stragglers),
            "pending": list(self.pending),
        }


class FailureDetector:
    """Classifies a shuffle's participants as dead / slow / healthy."""

    def __init__(self, cluster: LocalCluster, manager: ShuffleManager, *,
                 straggler_factor: float = 3.0):
        self.cluster = cluster
        self.manager = manager
        self.straggler_factor = straggler_factor

    def probe(self, wid: int) -> str:
        """Point query — the heartbeat a real detector would send."""
        if wid in self.cluster.failed_workers:
            return DEAD
        if self.cluster.worker_delays.get(wid, 0.0) > 0.0:
            return SLOW
        return HEALTHY

    def healthy(self, candidates) -> list[int]:
        return [w for w in candidates if self.probe(w) == HEALTHY]

    def classify(self, shuffle_id: int, participants=()) -> FailureReport:
        """Diagnose one (usually just-aborted) shuffle attempt.

        ``dead`` wins over ``slow``: a worker that died while also delayed
        needs a restart, not a backup copy.  Journal stragglers are advisory
        (they include workers that merely *finished* slowly) and never force
        recovery by themselves.
        """
        parts = set(participants)
        scoped = (lambda ws: sorted(set(ws) & parts)) if parts else sorted
        dead = scoped(self.cluster.failed_workers)
        slow = tuple((w, float(d)) for w, d in sorted(
            self.cluster.worker_delays.items())
            if d > 0.0 and w not in dead and (not parts or w in parts))
        stragglers = tuple(
            w for w in self.manager.stragglers(shuffle_id,
                                               factor=self.straggler_factor)
            if w not in dead)
        pending = tuple(self.manager.progress(shuffle_id)["pending"])
        return FailureReport(shuffle_id=shuffle_id, dead=tuple(dead), slow=slow,
                             stragglers=stragglers, pending=pending)
