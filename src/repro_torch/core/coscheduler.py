"""Co-scheduling shuffles (paper §6, "future directions" — implemented).

When several systems (or several instances of one system) invoke TeShu in the
same cluster, the manager can schedule their shuffle invocations *jointly*:

* **coflow identification** — shuffles sharing a (tenant, stage) tag form a
  coflow [Chowdhury & Stoica, HotNets'12]: the application only advances when
  the *last* flow of the coflow finishes, so scheduling decisions should act
  on coflow completion time (CCT), not per-flow completion.
* **policies** —
  - ``fifo``: arrival order (the baseline every system gets by default);
  - ``sebf``: smallest-effective-bottleneck-first (Varys-style) — schedule the
    coflow whose slowest worker finishes soonest, minimizing mean CCT;
  - ``fair``: weighted max-min fair sharing of each boundary's bandwidth
    across tenants (no starvation, predictable per-tenant throughput);
  - ``wfair``: weighted fair queuing's serial approximation — coflows are
    served in increasing *virtual finish time* ``bottleneck_time / weight``,
    so a tenant's priority (and the admission layer's load-deficit boost,
    derived from the ledger's sampled per-tenant byte lanes) directly buys
    schedule position.  With equal weights this degenerates to SEBF; it is
    the multi-tenant service's default admission policy.

The scheduler runs against the same topology cost model the adaptive templates
use: each coflow's demand is its per-worker, per-boundary byte matrix — either
exact, or estimated from a deterministic row sample (``demand_rate``, the
admission layer's cheap path) — and serving order/shares translate into
modelled completion times.  This is a *planning* layer: it decides execution
order and bandwidth shares; execution itself still goes through the service
(``TeShuCluster.run_pending`` drains its admission queue through a plan from
this scheduler).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

from .messages import Combiner, Msgs, PartFn, partition
from .topology import NetworkTopology


@dataclasses.dataclass
class CoflowRequest:
    """One shuffle invocation, tagged with its tenant + stage (coflow id)."""

    tenant: str
    stage: str
    bufs: dict[int, Msgs]
    part_fn: PartFn
    arrival: float = 0.0
    weight: float = 1.0

    @property
    def coflow_id(self) -> tuple[str, str]:
        return (self.tenant, self.stage)


def _boundary_bytes(req: CoflowRequest, topo: NetworkTopology,
                    rate: float | None = None) -> np.ndarray:
    """bytes[level] this shuffle pushes across each topology boundary.

    ``rate`` switches to the sampled estimator: every ``round(1/rate)``-th row
    of each buffer is partitioned (deterministic stride — no RNG, so repeated
    admission passes agree) and the per-boundary bytes are scaled back up.
    The admission layer plans on these estimates; scheduling needs demand
    *ratios*, not exact bytes, so a few percent of the rows suffice.
    """
    nw = topo.num_workers
    out = np.zeros(len(topo.levels))
    stride = 1 if rate is None else max(1, int(round(1.0 / max(rate, 1e-9))))
    for src, msgs in req.bufs.items():
        if msgs.n == 0:
            continue
        if stride > 1:
            sample = msgs.take(np.arange(0, msgs.n, stride))
            scale = msgs.n / sample.n
        else:
            sample, scale = msgs, 1.0
        parts = partition(sample, list(range(nw)), req.part_fn)
        for dst, m in parts.items():
            lv = topo.crossing_level(src, dst)
            if lv >= 0:
                out[lv] += m.nbytes * scale
    return out


def _bottleneck_time(demand: np.ndarray, topo: NetworkTopology,
                     share: float = 1.0) -> float:
    """Completion time of a coflow given a bandwidth share on each boundary."""
    t = 0.0
    for i, lv in enumerate(topo.levels):
        if demand[i] > 0:
            t = max(t, demand[i] / (lv.bw_bytes_per_s * topo.num_workers
                                    * max(share, 1e-9)))
    return t


@dataclasses.dataclass
class ScheduleEntry:
    coflow_id: tuple[str, str]
    start: float
    finish: float
    share: float


POLICIES = ("fifo", "sebf", "fair", "wfair")


class CoflowScheduler:
    """Plan an execution order / bandwidth shares for pending shuffles."""

    def __init__(self, topology: NetworkTopology, policy: str = "sebf",
                 demand_rate: float | None = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}")
        self.topology = topology
        self.policy = policy
        self.demand_rate = demand_rate      # None = exact demand matrices

    # -- demand aggregation ----------------------------------------------------
    def coflows(self, requests: Sequence[CoflowRequest]
                ) -> dict[tuple[str, str], dict]:
        out: dict[tuple[str, str], dict] = {}
        for r in requests:
            c = out.setdefault(r.coflow_id, {
                "demand": np.zeros(len(self.topology.levels)),
                "arrival": r.arrival, "weight": r.weight, "n": 0})
            c["demand"] += _boundary_bytes(r, self.topology,
                                           rate=self.demand_rate)
            c["arrival"] = min(c["arrival"], r.arrival)
            c["n"] += 1
        return out

    # -- policies ---------------------------------------------------------------
    def plan(self, requests: Sequence[CoflowRequest]) -> list[ScheduleEntry]:
        cf = self.coflows(requests)
        if self.policy == "fair":
            return self._plan_fair(cf)
        order = list(cf.items())
        if self.policy == "fifo":
            order.sort(key=lambda kv: kv[1]["arrival"])
        elif self.policy == "wfair":
            # weighted fair queuing, serial service: increasing virtual finish
            # time demand/weight — priority (and the admission layer's load
            # deficit boost) buys schedule position; equal weights => SEBF
            order.sort(key=lambda kv: _bottleneck_time(kv[1]["demand"],
                                                       self.topology)
                       / max(kv[1]["weight"], 1e-9))
        else:                                   # sebf: shortest bottleneck first
            order.sort(key=lambda kv: _bottleneck_time(kv[1]["demand"],
                                                       self.topology))
        t = 0.0
        plan = []
        for cid, c in order:
            dur = _bottleneck_time(c["demand"], self.topology)
            plan.append(ScheduleEntry(cid, t, t + dur, share=1.0))
            t += dur
        return plan

    def _plan_fair(self, cf: dict) -> list[ScheduleEntry]:
        """Weighted fair shares, recomputed at each coflow completion event."""
        remaining = {cid: c["demand"].copy() for cid, c in cf.items()}
        weights = {cid: c["weight"] for cid, c in cf.items()}
        start = {cid: 0.0 for cid in cf}
        plan = []
        t = 0.0
        while remaining:
            wsum = sum(weights[c] for c in remaining)
            shares = {c: weights[c] / wsum for c in remaining}
            # next completion under current shares
            finish = {c: _bottleneck_time(remaining[c], self.topology,
                                          shares[c]) for c in remaining}
            nxt = min(finish, key=finish.get)
            dt = finish[nxt]
            for c in list(remaining):
                frac = dt / finish[c] if finish[c] > 0 else 1.0
                remaining[c] *= (1.0 - min(frac, 1.0))
            plan.append(ScheduleEntry(nxt, start[nxt], t + dt,
                                      share=shares[nxt]))
            t += dt
            del remaining[nxt]
        return plan

    # -- metrics -----------------------------------------------------------------
    @staticmethod
    def mean_cct(plan: list[ScheduleEntry]) -> float:
        return float(np.mean([e.finish for e in plan])) if plan else 0.0

    @staticmethod
    def makespan(plan: list[ScheduleEntry]) -> float:
        return max((e.finish for e in plan), default=0.0)
