"""The ElasticCoordinator: execute scale decisions against a live cluster.

Scale-out appends *burst workers* — dense ids past the current worker set,
one or more innermost groups at a time — by rebuilding the
:class:`~repro_torch.core.topology.NetworkTopology` (``with_workers``/``grow``) and
retargeting the :class:`~repro_torch.core.primitives.LocalCluster` and its ledger
onto it.  Every scale event bumps the coordinator's **epoch**, which is part
of every subsequent plan key (:func:`repro_torch.core.plancache.topology_tag`):
plans cached under the old topology stop being reachable instantly — O(1)
invalidation, no namespace scan — while plan repair re-keys or re-instantiates
them onto the widened worker set on the next miss.

Scale-in is **graceful drain, never kill**: victims are the newest burst
workers (worker ids are dense, so the removable set is always the contiguous
tail), their staged ShuffleStore blocks are flushed synchronously
(:meth:`~repro_torch.core.storage.ShuffleStore.drain_workers`), the handoff is
journaled (``drain_handoff``), each tenant that drove the scale-out is charged
the burst worker-seconds it consumed, and only then does the topology shrink.

Everything here runs under the service's run-pending lock at coflow
boundaries — scaling never preempts a coflow mid-flight, which is what keeps
outputs byte-identical across fixed and elastic runs.
"""
from __future__ import annotations

import threading

from ..tenancy import DEFAULT_TENANT
from ..topology import NetworkTopology
from .policy import ScaleDecision, ScalePolicy
from .signals import LoadMonitor


class ElasticCoordinator:
    """Owns the elastic state of one cluster: epoch, burst roster, events.

    ``service`` is duck-typed (anything exposing ``topology``, ``cluster``,
    ``store``, ``manager``, ``registry``, ``obs``, and the
    ``_m_scale_events`` counter — i.e. a
    :class:`~repro_torch.core.service.TeShuCluster`).  ``level`` names the topology
    level whose ``group_size`` is the scale-out granularity (default: the
    innermost level).  ``max_workers`` caps the grown worker set; ``ttl_s``
    bounds burst-worker lifetime in modelled seconds (enforced at idle
    polls — TTL expiry is a drain, and drains only happen at quiescent
    points).
    """

    def __init__(self, service, policy: ScalePolicy,
                 monitor: LoadMonitor | None = None, *,
                 level: str | None = None, max_workers: int | None = None,
                 ttl_s: float | None = None):
        self.svc = service
        self.policy = policy
        self.monitor = monitor if monitor is not None else LoadMonitor()
        self.level = level
        self.base_workers = service.topology.num_workers
        self.max_workers = max_workers
        self.ttl_s = ttl_s
        self.epoch = 0
        # burst wid -> {"born": modelled ts, "reason": str, "tenants": tuple}
        self.burst: dict[int, dict] = {}
        self.events: list[dict] = []
        # every full worker-set size this cluster has run at — the rebalance
        # predicate ("these dsts were 'all workers' at some point") reads it
        self._sizes: set[int] = {self.base_workers}
        self._lock = threading.RLock()

    # ---- clock / introspection ----------------------------------------------
    def now(self) -> float:
        return self.svc.cluster.ledger.modelled_time()

    @property
    def num_workers(self) -> int:
        return self.svc.topology.num_workers

    def at_capacity(self) -> bool:
        if self.max_workers is None:
            return False
        return self.num_workers + self._group_size() > self.max_workers

    def has_burst(self) -> bool:
        return bool(self.burst)

    def burst_workers(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self.burst))

    def _group_size(self) -> int:
        topo = self.svc.topology
        lv = topo.levels[0] if self.level is None else topo.level(self.level)
        return lv.group_size

    # ---- scale-out -----------------------------------------------------------
    def scale_out(self, groups: int = 1, *, reason: str,
                  tenants: tuple = ()) -> tuple[int, ...]:
        """Append ``groups`` burst groups; returns the new worker ids
        (possibly fewer groups than asked, empty at ``max_workers``)."""
        if groups < 1:
            raise ValueError(f"groups must be >= 1: {groups}")
        with self._lock:
            n = self.num_workers
            added_n = groups * self._group_size()
            if self.max_workers is not None:
                added_n = min(added_n, self.max_workers - n)
            if added_n <= 0:
                self.deny(reason="at_capacity")
                return ()
            new_topo = self.svc.topology.with_workers(n + added_n)
            added = tuple(range(n, n + added_n))
            ts = self.now()
            for w in added:
                self.burst[w] = {"born": ts, "reason": reason,
                                 "tenants": tuple(tenants)}
            self._apply(new_topo, kind="scale_out", reason=reason,
                        workers=added, tenants=tuple(tenants))
            self.policy.note_scaled(ts)
            return added

    # ---- scale-in ------------------------------------------------------------
    def removable(self, workers=None) -> tuple[int, ...]:
        """The LIFO-contiguous tail of burst workers that can drain now.

        Worker ids are dense 0..n-1, so only the tail is removable; asking
        for a specific set returns the tail portion of it (possibly empty).
        """
        with self._lock:
            victims = []
            w = self.num_workers - 1
            want = None if workers is None else set(workers)
            while w in self.burst and (want is None or w in want):
                victims.append(w)
                w -= 1
            return tuple(sorted(victims))

    def scale_in(self, workers=None, *, reason: str) -> tuple[int, ...]:
        """Gracefully drain and remove burst workers; returns the ids removed.

        ``workers=None`` drains every current burst worker.  Drain protocol:
        flush the victims' staged store blocks synchronously, journal the
        handoff, charge burst worker-seconds to the sponsoring tenants, then
        shrink the topology and bump the epoch.  Non-burst workers are never
        removed.
        """
        with self._lock:
            victims = self.removable(workers)
            if not victims:
                return ()
            drained = self._drain(victims, reason=reason)
            ts = self.now()
            for w in victims:
                info = self.burst.pop(w)
                sponsors = info["tenants"] or (DEFAULT_TENANT,)
                life = max(0.0, ts - info["born"])
                for t in sponsors:
                    self.svc.registry.charge_burst(t, life / len(sponsors))
            new_topo = self.svc.topology.with_workers(
                self.num_workers - len(victims))
            self._apply(new_topo, kind="scale_in", reason=reason,
                        workers=victims, drained=drained)
            self.policy.note_scaled(ts)
            return victims

    def _drain(self, victims: tuple, *, reason: str) -> dict:
        """Flush the victims' staged blocks and journal the handoff."""
        blocks, nbytes = self.svc.store.drain_workers(victims)
        drained = {"workers": list(victims), "blocks": blocks,
                   "bytes": nbytes, "reason": reason}
        self.svc.manager.record_drain_handoff(dict(drained, ts=self.now()))
        return drained

    # ---- shared apply --------------------------------------------------------
    def _apply(self, new_topology: NetworkTopology, *, kind: str, reason: str,
               workers: tuple, tenants: tuple = (),
               drained: dict | None = None) -> None:
        self.svc.topology = new_topology
        self.svc.cluster.set_topology(new_topology)
        self.epoch += 1
        self._sizes.add(new_topology.num_workers)
        if kind == "scale_in":
            # removed ids must not leave ghost fault state behind: a future
            # scale-out reuses them, and a fresh burst worker is healthy
            for w in workers:
                self.svc.cluster.failed_workers.discard(w)
                self.svc.cluster.worker_delays.pop(w, None)
                self.svc.cluster.fault_injections.pop(w, None)
        ts = self.now()
        event = {"kind": kind, "reason": reason, "workers": list(workers),
                 "size": new_topology.num_workers, "epoch": self.epoch,
                 "ts": ts}
        if tenants:
            event["tenants"] = list(tenants)
        if drained is not None:
            event["drained"] = drained
        self.events.append(event)
        info = dict(event)
        if kind == "scale_out":
            self.svc.manager.record_scale_out(info)
        else:
            self.svc.manager.record_scale_in(info)
        self.svc._m_scale_events.inc(kind=kind, reason=reason)
        tracer = self.svc.obs.tracer
        if tracer.enabled:
            tracer.point("scale_decision", kind=kind, reason=reason,
                         workers=list(workers), epoch=self.epoch,
                         size=new_topology.num_workers)

    def deny(self, reason: str) -> None:
        """Record a suppressed scale (cooldown, capacity) — event + metric
        only, no topology change, no epoch bump."""
        event = {"kind": "deny", "reason": reason, "workers": [],
                 "size": self.num_workers, "epoch": self.epoch,
                 "ts": self.now()}
        self.events.append(event)
        self.svc._m_scale_events.inc(kind="deny", reason=reason)
        tracer = self.svc.obs.tracer
        if tracer.enabled:
            tracer.point("scale_decision", kind="deny", reason=reason,
                         epoch=self.epoch, size=self.num_workers)

    # ---- TTL -----------------------------------------------------------------
    def expired(self) -> tuple[int, ...]:
        """Burst workers past their TTL (empty when no TTL is set)."""
        if self.ttl_s is None:
            return ()
        now = self.now()
        with self._lock:
            return tuple(sorted(w for w, info in self.burst.items()
                                if now - info["born"] >= self.ttl_s))

    # ---- coflow rebalance ----------------------------------------------------
    def rebalance(self, subs) -> int:
        """Re-target queued submissions onto the current worker set.

        A submission whose ``dsts`` is exactly "all workers of a size this
        cluster has run at" meant *everyone* — widen (or re-narrow) it to the
        current full set so later coflows land on burst workers.  Explicit
        partial destination sets are the caller's placement and are never
        touched.  Returns how many submissions were re-targeted.
        """
        n = self.num_workers
        full = tuple(range(n))
        with self._lock:
            sizes = set(self._sizes)
        moved = 0
        for s in subs:
            ds = tuple(s.dsts)
            if (len(ds) != n and len(ds) in sizes
                    and set(ds) == set(range(len(ds)))):
                s.dsts = full
                moved += 1
        return moved
