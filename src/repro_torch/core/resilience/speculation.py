"""Straggler speculation: duplicate slow workers' tasks onto healthy peers.

Exoshuffle/MapReduce-style backup tasks: when the detector classifies a worker
as *slow* (alive, but its stage completion is gated on an injected or observed
delay), the policy launches a speculative copy of its shuffle task on a
healthy peer.  Both race; the first finisher's output is used, the loser is
cancelled.  In the simulated cluster this resolves deterministically — the
backup runs without the straggler's delay, so the backup always wins, and the
executors model it by simply not serving the delay for speculated workers
(the winner's transfers are charged once, exactly like a real first-past-wins
race; the duplicated bytes are reported, not charged, since the loser is
cancelled at stage granularity).

The policy is deliberately conservative (FuxiShuffle §5: backup tasks are
cheap but not free): it only speculates when the known delay exceeds
``min_delay_s`` and a healthy backup exists, and it spreads backups
round-robin so one peer never absorbs every straggler.
"""
from __future__ import annotations

import dataclasses
import itertools

from ..primitives import LocalCluster


@dataclasses.dataclass(frozen=True)
class SpeculativeTask:
    wid: int            # the straggler whose work is duplicated
    backup: int         # healthy peer running the copy
    delay_s: float      # the delay the backup dodges (expected gain)

    def to_info(self) -> list:
        return [self.wid, self.backup, self.delay_s]


class SpeculationPolicy:
    """Decides which stragglers get backup copies, and where."""

    def __init__(self, *, min_delay_s: float = 0.05):
        self.min_delay_s = min_delay_s

    def plan(self, cluster: LocalCluster,
             participants) -> tuple[SpeculativeTask, ...]:
        participants = list(participants)
        delayed = {w: d for w, d in cluster.worker_delays.items()
                   if w in participants and d >= self.min_delay_s
                   and w not in cluster.failed_workers}
        if not delayed:
            return ()
        healthy = [w for w in participants
                   if w not in cluster.failed_workers
                   and cluster.worker_delays.get(w, 0.0) < self.min_delay_s]
        if not healthy:
            return ()                       # nowhere to run backups
        backups = itertools.cycle(healthy)
        return tuple(
            SpeculativeTask(wid=w, backup=next(backups), delay_s=d)
            for w, d in sorted(delayed.items(), key=lambda kv: -kv[1]))
