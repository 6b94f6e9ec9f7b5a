"""Multi-tenant service plumbing: tenant registry + the admission queue.

The paper frames TeShu as "an extensible unified service layer common to all
data analytics" — one shuffle service per cluster that *many* applications
program against (Exoshuffle's shuffle-as-a-library boundary, FuxiShuffle's
production multi-tenant service).  This module holds the tenant-facing state
that is not execution:

* :class:`TenantSpec` — identity + isolation/fairness knobs of one tenant:
  the plan-cache entry ``quota`` (its private LRU budget) and the scheduling
  ``priority`` (its weight in cross-tenant coflow scheduling).  Execution
  knobs (``execution``, ``executor``, ``resilience``, ...) are per-tenant
  too, but live on the :class:`~repro_torch.core.service.TenantClient` handle —
  e.g. ``cluster.tenant("ml", executor="vectorized")`` pins an application
  to the numpy replay data plane without touching the fleet default.
* :class:`TenantRegistry` — the cluster's tenant table.  Tenants are created
  on first ``cluster.tenant(...)`` call and re-fetched idempotently; every
  journal record, ledger lane, and plan-cache namespace is keyed by the
  ``tenant_id`` registered here.
* :class:`AdmissionQueue` — pending shuffle submissions awaiting a scheduling
  pass.  ``TenantClient.submit()`` enqueues; ``TeShuCluster.run_pending()``
  drains it through the :class:`~repro_torch.core.coscheduler.CoflowScheduler`,
  with per-tenant effective weights derived from the registry's priorities
  and the ledger's sampled per-tenant load statistics (tenants that have
  consumed less than their fair share get a deficit boost).

``DEFAULT_TENANT`` is the implicit tenant of the single-application facade
(:class:`~repro_torch.core.service.TeShuService`): seed-era journals, plan caches,
and ledgers all describe that tenant, which is what keeps them replayable.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Sequence

DEFAULT_TENANT = "default"


@dataclasses.dataclass
class TenantSpec:
    """Identity and isolation/fairness knobs of one registered tenant."""

    tenant_id: str
    quota: int | None = None  # plan-cache namespace budget (entries);
    #                           None = inherit the cache's default capacity
    priority: float = 1.0     # scheduling weight (cross-tenant coflow fairness)
    storage_quota: int | None = None  # shuffle-store namespace budget (bytes);
    #                                   None = unbounded

    def __post_init__(self):
        if not self.tenant_id:
            raise ValueError("tenant_id must be non-empty")
        if self.quota is not None and self.quota < 1:
            raise ValueError(f"quota must be >= 1: {self.quota}")
        if self.priority <= 0:
            raise ValueError(f"priority must be > 0: {self.priority}")
        if self.storage_quota is not None and self.storage_quota < 1:
            raise ValueError(
                f"storage_quota must be >= 1: {self.storage_quota}")


class TenantRegistry:
    """Thread-safe tenant table; one per :class:`TeShuCluster`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, TenantSpec] = {}
        # tenant -> cumulative burst worker-seconds (modelled): the elastic
        # coordinator charges each scale-in victim's lifetime to the tenants
        # whose backlog sponsored the scale-out
        self._burst_seconds: dict[str, float] = {}

    def charge_burst(self, tenant_id: str, seconds: float) -> None:
        """Attribute ``seconds`` of burst-worker lifetime to ``tenant_id``."""
        if seconds < 0:
            raise ValueError(f"burst seconds must be >= 0: {seconds}")
        with self._lock:
            self._burst_seconds[tenant_id] = \
                self._burst_seconds.get(tenant_id, 0.0) + float(seconds)

    def burst_usage(self, tenant_id: str | None = None):
        """Cumulative burst worker-seconds: one tenant's total, or the whole
        table when ``tenant_id`` is None."""
        with self._lock:
            if tenant_id is not None:
                return self._burst_seconds.get(tenant_id, 0.0)
            return dict(self._burst_seconds)

    def register(self, tenant_id: str, *, quota: int | None = None,
                 priority: float | None = None,
                 storage_quota: int | None = None) -> TenantSpec:
        """Create-or-fetch a tenant.  Re-registering with explicit knobs
        updates them; omitted knobs keep their current values."""
        with self._lock:
            spec = self._tenants.get(tenant_id)
            if spec is None:
                spec = TenantSpec(
                    tenant_id, quota=quota,
                    priority=1.0 if priority is None else priority,
                    storage_quota=storage_quota)
                self._tenants[tenant_id] = spec
            else:
                # validate ALL before assigning ANY (same rules as
                # TenantSpec.__post_init__; the spec object is mutated in
                # place so existing TenantClient handles observe the update)
                if quota is not None and quota < 1:
                    raise ValueError(f"quota must be >= 1: {quota}")
                if priority is not None and priority <= 0:
                    raise ValueError(f"priority must be > 0: {priority}")
                if storage_quota is not None and storage_quota < 1:
                    raise ValueError(
                        f"storage_quota must be >= 1: {storage_quota}")
                if quota is not None:
                    spec.quota = quota
                if priority is not None:
                    spec.priority = priority
                if storage_quota is not None:
                    spec.storage_quota = storage_quota
            return spec

    def get(self, tenant_id: str) -> TenantSpec:
        with self._lock:
            spec = self._tenants.get(tenant_id)
        if spec is None:
            raise KeyError(f"tenant {tenant_id!r} is not registered")
        return spec

    def __contains__(self, tenant_id: str) -> bool:
        with self._lock:
            return tenant_id in self._tenants

    def ids(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def effective_weights(self, tenant_bytes: dict[str, int]) -> dict[str, float]:
        """Scheduling weights from priorities x observed load statistics.

        A tenant's weight starts at its configured ``priority`` and is scaled
        by a *deficit boost*: tenants that have so far consumed less than the
        priority-proportional share of the ledger's per-tenant byte lanes get
        up to 2x, tenants over their share decay toward 1/2 — weighted fair
        queuing's usage feedback, on the sampled load statistics the service
        already keeps.  With no recorded load everyone's weight is just its
        priority.
        """
        with self._lock:
            specs = dict(self._tenants)
        total = sum(tenant_bytes.get(t, 0) for t in specs)
        psum = sum(s.priority for s in specs.values()) or 1.0
        out: dict[str, float] = {}
        for t, spec in specs.items():
            if total <= 0:
                out[t] = spec.priority
                continue
            fair = spec.priority / psum
            actual = tenant_bytes.get(t, 0) / total
            # boost in (1/2, 2): 2^(fair - actual normalized to [-1, 1])
            out[t] = spec.priority * 2.0 ** max(-1.0, min(1.0, fair - actual))
        return out


# Coflow tag given to stage-less submissions; user stages must not spell it.
_AUTO_STAGE_PREFIX = "#auto-"


@dataclasses.dataclass
class ShuffleSubmission:
    """One queued shuffle invocation awaiting an admission/scheduling pass."""

    ticket: int
    tenant: str
    stage: str                    # coflow tag: shuffles sharing it co-schedule
    template_id: str
    bufs: dict
    srcs: tuple[int, ...]
    dsts: tuple[int, ...]
    kwargs: dict
    arrival: int                  # FIFO position (submission order)
    ts: float = 0.0               # wall clock (monotonic) at submission —
    #                               the admission-wait metric's start point

    @property
    def coflow_id(self) -> tuple[str, str]:
        return (self.tenant, self.stage)


class AdmissionQueue:
    """Pending submissions, drained by ``TeShuCluster.run_pending()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: list[ShuffleSubmission] = []
        self._tickets = itertools.count(1)

    def submit(self, tenant: str, stage: str | None, template_id: str,
               bufs: dict, srcs: Sequence[int], dsts: Sequence[int],
               kwargs: dict) -> int:
        if stage is not None and stage.startswith(_AUTO_STAGE_PREFIX):
            # reserved for auto-generated tags: a user stage spelled like one
            # could silently merge with a stage-less submission's coflow
            raise ValueError(
                f"stage must not start with {_AUTO_STAGE_PREFIX!r}: {stage}")
        with self._lock:
            ticket = next(self._tickets)
            self._pending.append(ShuffleSubmission(
                ticket=ticket, tenant=tenant,
                stage=(stage if stage is not None
                       else f"{_AUTO_STAGE_PREFIX}{ticket}"),
                template_id=template_id, bufs=bufs,
                srcs=tuple(srcs), dsts=tuple(dsts), kwargs=dict(kwargs),
                arrival=ticket, ts=time.monotonic()))
            return ticket

    def drain(self) -> list[ShuffleSubmission]:
        with self._lock:
            pending, self._pending = self._pending, []
            return pending

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)
