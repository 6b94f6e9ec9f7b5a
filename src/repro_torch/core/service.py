"""The TeShu service layer: a cluster-wide shuffle service, many tenants.

The paper frames TeShu as "an extensible unified service layer common to all
data analytics": an infrastructure provider deploys **one** shuffle service
per cluster, and *many* applications program against it.  The public API is
therefore two-level:

* :class:`TeShuCluster` — the cluster-scoped deployment: owns the topology,
  the worker pool (:class:`LocalCluster`), the Shuffle Manager + journal, the
  plan cache, the resilience machinery, the tenant registry, and the
  admission queue.  Operators construct this once.
* :class:`TenantClient` — a per-application handle obtained via
  ``cluster.tenant(tenant_id, quota=..., priority=...)``.  It carries the
  ``shuffle()`` / ``open_stream()`` call surface of Table 1, plus the knob
  stack (execution / resilience / balance / streaming), resolved per call →
  per tenant → cluster default.  Everything a tenant does is tagged with its
  id: journal records, ledger lanes, and a *private* plan-cache namespace
  with its own LRU budget (``quota``) — one tenant's churn can never evict,
  hit, or repair from another tenant's plans.

**Admission & cross-tenant scheduling.**  Concurrent shuffle requests can be
queued (``TenantClient.submit``) and drained through
``TeShuCluster.run_pending()``: submissions sharing a (tenant, stage) tag
form a coflow, the :class:`~repro_torch.core.coscheduler.CoflowScheduler` plans
them under the cluster's admission policy (default ``"wfair"`` — weighted
fair queuing whose weights combine each tenant's ``priority`` with a deficit
boost from the ledger's sampled per-tenant load statistics), and the cluster
executes them in scheduled order instead of FIFO interleaving.  The realized
per-coflow completion times (modelled time at each coflow's last shuffle)
are reported via ``last_schedule()``.

**The single-tenant facade.**  :class:`TeShuService` — the seed API — is
retained as a thin deprecated facade: it *is* a ``TeShuCluster`` that
registers the :data:`~repro_torch.core.tenancy.DEFAULT_TENANT` at construction and
forwards ``shuffle()`` / ``open_stream()`` to it.  Every existing caller
keeps working unchanged; new code should construct a ``TeShuCluster`` and
take explicit tenant handles.

On top of the paper's flow the service runs the plan-compilation cache
(:mod:`repro_torch.core.plancache`): every call computes the plan key (template x
topology x stats signature); a miss executes the template fresh — full neighbor
discovery, sampling, EFF/COST rendezvous — and compiles the instantiation into a
:class:`CompiledPlan`; a hit replays the plan, skipping that control-plane work
entirely, and (when valid) executes on the batched data plane
(:mod:`repro_torch.core.vectorized`).  Observed reduction ratios from cached runs feed
drift invalidation.

Execution modes (cluster default, overridable per tenant and per call):

* ``"auto"``    — cache + vectorized execution where valid (the fast path);
* ``"threaded"``— cache, but always the thread-per-worker reference executor;
* ``"fresh"``   — paper-faithful: re-instantiate every call, never consult the
  cache (plans are still compiled and stored, so switching back to ``auto`` hits).

The ``executor`` knob picks which data plane an ``"auto"`` cache hit replays
on — ``"torch"`` (the default: whole-tensor replay on the cluster's ``device``,
:mod:`repro_torch.core.torchplan`) or ``"vectorized"`` (batched numpy); plans
the torch replay declines fall back to vectorized, then threaded,
byte-identically.  The cluster's ``device`` is the card (``"cuda"``) unless
the caller asks for ``"cpu"``; a cluster asked for the card on a host without
one refuses to start rather than move to the CPU.

Streaming modes pick the execution model (:mod:`repro_torch.core.streaming`):

* ``"off"``     — barrier shuffles (the paper's model): one synchronized
  exchange, receivers combine once everything arrived;
* ``"auto"``    — streamable templates run as chunk-pipelined sub-epochs:
  senders stream fixed-budget chunks, receivers incrementally combine, an
  end-of-stream rendezvous replaces the barrier, and modelled time reflects
  the transfer/combine overlap.  Output stays byte-identical to ``"off"``.
  ``open_stream()`` additionally exposes the ``feed()``/``drain()``
  continuous-ingest API for open-ended sources, with *enforced* backpressure
  (``max_inflight`` bounds the transferred-but-unfolded chunk window).

Resilience modes gate the :mod:`repro_torch.core.resilience` pipeline:

* ``"off"``     — seed behavior: a failure surfaces as ``ShuffleAborted``
  (a ``TimeoutError``), nothing is diagnosed or retried;
* ``"detect"``  — failures are classified (dead vs slow) and journaled; the
  exception carries the :class:`FailureReport` as ``.report`` but still raises;
* ``"recover"`` — full pipeline: speculation for stragglers, plan repair for
  degraded topologies, and journal+checkpoint driven retries that restart only
  the affected participant subset (§6), on either executor.  Recovery is
  tenant-scoped: only the failed tenant's participants restart — a concurrent
  shuffle of another tenant (disjoint workers) is never touched.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from ..device import check_device as _check_device
from . import torchplan
from .coscheduler import POLICIES, CoflowRequest, CoflowScheduler
from .elastic import (BacklogPolicy, ElasticCoordinator, LoadMonitor,
                      ManualPolicy, SCALE_IN_TTL, SCALE_REASON_MANUAL,
                      ScaleDecision)
from .manager import ShuffleManager
from .messages import HASH_PART, Combiner, Msgs, PartFn
from .obs import ShuffleReport, build_report
from .plancache import PlanCache, compile_plan, plan_key, stats_signature
from .primitives import LocalCluster, ShuffleAborted, ShuffleArgs
from .resilience import (CheckpointStore, FailureDetector, RecoveryCoordinator,
                         SpeculationPolicy, try_repair)
from .skew import DEFAULT_SKEW_THRESHOLD, imbalance
from .storage import (STORAGE_MODES, STORE_DIRECT, LocalDirBackend,
                      MemoryBackend, ShuffleStore, StorageContext)
from .streaming import (DEFAULT_CHUNK_BYTES, DEFAULT_MAX_INFLIGHT, ChunkPlan,
                        StreamSession)
from .tenancy import DEFAULT_TENANT, AdmissionQueue, TenantRegistry, TenantSpec
from .templates import ShuffleResult, run_shuffle
from .topology import NetworkTopology
from .vectorized import run_shuffle_vectorized, vectorize_decline

EXECUTION_MODES = ("auto", "threaded", "fresh")
RESILIENCE_MODES = ("off", "detect", "recover")
# "off" = fixed topology (the pre-elastic behaviour, and the default);
# "auto" = BacklogPolicy drives scale-out/in from admission backlog;
# "manual" = scaling happens only on request_scale_out()/request_scale_in()
# (or the immediate scale_out()/scale_in() ops calls) — deterministic, for
# tests and operators.
ELASTIC_MODES = ("off", "auto", "manual")
BALANCE_MODES = ("off", "auto")
STREAMING_MODES = ("off", "auto")
# Which replay data plane "auto" execution prefers on a cache hit:
# "vectorized" = batched numpy; "torch" = the whole-tensor replay of
# :mod:`repro_torch.core.torchplan` on the cluster's device, falling back to
# vectorized for plans it declines (streaming, fault state, exotic part/comb
# fns, unfreezable skew scatters).  The fresh/instantiation path is always
# threaded.
EXECUTORS = ("vectorized", "torch")

# The per-call / per-tenant / cluster-default knob stack.  Every knob here may
# be set on the cluster (the fleet default), overridden at tenant registration
# (the application's default), and overridden again on an individual call.
_KNOBS = ("execution", "executor", "resilience", "balance", "skew_threshold",
          "streaming", "chunk_bytes", "max_inflight", "max_retries", "storage")

# next_shuffle_id tags at most this many recent ids with their owning tenant
# (shuffle_owner); older tags fall off — the journal keeps the full history.
_OWNER_TAG_CAPACITY = 4096


def dst_load_imbalance(stats: dict, dsts) -> float | None:
    """max/mean received bytes across ``dsts`` from a shuffle's stats delta;
    None when the run recorded no received bytes (e.g. a single destination)."""
    recv = stats.get("recv_bytes_per_worker", {})
    loads = [recv.get(d, 0) for d in dsts]
    if len(loads) < 2 or sum(loads) <= 0:
        return None
    return imbalance(loads)


def _check_mode(name: str, value: str, allowed: tuple) -> str:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}: {value}")
    return value


def _check_knobs(knobs: dict) -> dict:
    """Validate a tenant-knob dict (shared by registration and TenantClient),
    dropping None values.  Raises before any cluster state is touched, so a
    rejected registration leaves no phantom tenant behind."""
    out = {}
    for k, v in knobs.items():
        if k not in _KNOBS:
            raise TypeError(f"unknown tenant knob {k!r} (knobs: {_KNOBS})")
        if v is not None:
            out[k] = v
    for name, allowed in (("execution", EXECUTION_MODES),
                          ("executor", EXECUTORS),
                          ("resilience", RESILIENCE_MODES),
                          ("balance", BALANCE_MODES),
                          ("streaming", STREAMING_MODES),
                          ("storage", STORAGE_MODES)):
        if name in out:
            _check_mode(name, out[name], allowed)
    for name, floor in (("chunk_bytes", 1), ("max_inflight", 1),
                        ("max_retries", 0)):
        if name in out and out[name] < floor:
            raise ValueError(f"{name} must be >= {floor}: {out[name]}")
    return out


class TenantClient:
    """A tenant's handle onto a :class:`TeShuCluster`: the Table-1 call
    surface, scoped to (and tagged with) one tenant id.

    Obtained via :meth:`TeShuCluster.tenant`; do not construct directly.
    Knobs passed at registration become this tenant's defaults; anything left
    unset inherits the cluster default; every knob can still be overridden
    per call.
    """

    def __init__(self, cluster: "TeShuCluster", spec: TenantSpec,
                 knobs: dict | None = None):
        self._cluster = cluster
        self.spec = spec
        self._knobs = _check_knobs(knobs or {})

    @property
    def tenant_id(self) -> str:
        return self.spec.tenant_id

    def knob(self, name: str, call_value=None):
        """Resolve a knob: per-call value > tenant default > cluster default."""
        if call_value is not None:
            return call_value
        if name in self._knobs:
            return self._knobs[name]
        return getattr(self._cluster, name)

    # ---- Table-1 surface ------------------------------------------------------
    def shuffle(self, template_id: str, bufs: dict[int, Msgs],
                srcs: Sequence[int], dsts: Sequence[int], *,
                part_fn: PartFn = HASH_PART, comb_fn: Combiner | None = None,
                rate: float = 0.01, shuffle_id: int | None = None,
                seed: int = 0, execution: str | None = None,
                executor: str | None = None,
                resilience: str | None = None, balance: str | None = None,
                skew_threshold: float | None = None,
                streaming: str | None = None, chunk_bytes: int | None = None,
                max_inflight: int | None = None,
                max_retries: int | None = None,
                storage: str | None = None) -> ShuffleResult:
        return self._cluster._shuffle(
            self, template_id, bufs, srcs, dsts, part_fn=part_fn,
            comb_fn=comb_fn, rate=rate, shuffle_id=shuffle_id, seed=seed,
            execution=execution, executor=executor, resilience=resilience,
            balance=balance, skew_threshold=skew_threshold,
            streaming=streaming, chunk_bytes=chunk_bytes,
            max_inflight=max_inflight, max_retries=max_retries,
            storage=storage)

    def open_stream(self, template_id: str, srcs: Sequence[int],
                    dsts: Sequence[int], *, part_fn: PartFn = HASH_PART,
                    comb_fn: Combiner | None = None,
                    chunk_bytes: int | None = None,
                    max_inflight: int | None = None,
                    shuffle_id: int | None = None,
                    storage: str | None = None) -> StreamSession:
        """Open a continuous-ingest shuffle: ``feed()`` source buffers as they
        arrive, ``drain()`` the combined per-destination accumulators at end
        of source.  ``max_inflight`` is enforced backpressure — see
        :class:`repro_torch.core.streaming.StreamSession`.  With ``storage`` in
        ``("spill", "durable")`` a full window spills its oldest chunks to the
        shuffle store instead of folding early, so total inflight bytes may
        exceed ``max_inflight`` x ``chunk_bytes`` without changing the folds."""
        cl = self._cluster
        template = cl.manager.get_template(template_id, wid=None)
        if not template.streamable:
            raise ValueError(
                f"template {template_id!r} is not streamable (declares no "
                "chunk-pipelined programs)")
        chunk = ChunkPlan(
            chunk_bytes=self.knob("chunk_bytes", chunk_bytes),
            max_inflight=self.knob("max_inflight", max_inflight))
        mode = _check_mode("storage", self.knob("storage", storage),
                           STORAGE_MODES)
        sid = (cl.next_shuffle_id(self.tenant_id) if shuffle_id is None
               else shuffle_id)
        # streams never persist final partitions (they have none until drain);
        # spill and durable both enable window spill-to-store
        ctx = (StorageContext(cl.store, mode, self.tenant_id)
               if mode != "off" else None)
        return StreamSession(
            cl.cluster, cl.manager, template, sid,
            srcs, dsts, part_fn, comb_fn, chunk, tenant=self.tenant_id,
            storage=ctx)

    def submit(self, template_id: str, bufs: dict[int, Msgs],
               srcs: Sequence[int], dsts: Sequence[int], *,
               stage: str | None = None, **kwargs) -> int:
        """Queue a shuffle for the next admission/scheduling pass instead of
        executing it now; returns a ticket resolved by
        :meth:`TeShuCluster.run_pending`.  Submissions sharing a ``stage``
        tag form one coflow (they complete together as far as the scheduler
        is concerned); ``kwargs`` are the :meth:`shuffle` keywords."""
        return self._cluster._admission.submit(
            self.tenant_id, stage, template_id, bufs, srcs, dsts, kwargs)

    # ---- per-tenant introspection --------------------------------------------
    def stats(self) -> dict:
        """This tenant's ledger lane (bytes + serialized seconds charged)."""
        snap = self._cluster.cluster.ledger.snapshot()
        return {
            "tenant": self.tenant_id,
            "bytes": snap["bytes_per_tenant"].get(self.tenant_id, 0),
            "cost_s": snap["cost_per_tenant"].get(self.tenant_id, 0.0),
            "burst_worker_s": self._cluster.registry.burst_usage(
                self.tenant_id),
        }

    def cache_stats(self) -> dict:
        """This tenant's plan-cache namespace counters (private LRU)."""
        return self._cluster.plan_cache.stats(self.tenant_id)

    def records(self, shuffle_id: int | None = None, kind: str | None = None):
        """This tenant's journal records."""
        return self._cluster.manager.records(shuffle_id, kind,
                                             tenant=self.tenant_id)


class TeShuCluster:
    """The cluster-scoped TeShu deployment: one per (simulated) cluster.

    Owns every shared resource — topology, worker pool, manager + journal,
    plan cache, resilience machinery — plus the tenant registry and the
    admission queue.  Applications get :class:`TenantClient` handles via
    :meth:`tenant`; the constructor knobs are the *cluster defaults* each
    tenant (and each call) may override.

    ``device`` is where the torch executor replays (``"cuda"``, the
    default, or ``"cpu"`` when the caller asks for it); a CUDA device on a
    host without one raises at construction.

    ``admission`` picks the cross-tenant coflow policy ``run_pending()``
    schedules under (any of :data:`repro_torch.core.coscheduler.POLICIES`);
    ``admission_rate`` is the row-sampling rate its demand estimator uses.

    Note on pinned shuffle ids: ids allocated by the cluster are unique across
    all tenants; a caller pinning explicit ``shuffle_id`` values is
    responsible for keeping them unique across *concurrently running*
    shuffles (per-invocation control state is keyed by id).
    """

    def __init__(self, topology: NetworkTopology, *,
                 journal_path: str | None = None,
                 replicas: Sequence[str] = (),
                 plan_cache: PlanCache | None = None,
                 device: str | torch.device = "cuda",
                 execution: str = "auto", executor: str = "torch",
                 resilience: str = "off",
                 balance: str = "off",
                 skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
                 streaming: str = "off",
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 max_retries: int = 2,
                 storage: str = "off",
                 storage_dir: str | None = None,
                 admission: str = "wfair",
                 admission_rate: float = 0.05,
                 tracing: bool = False,
                 span_capacity: int = 8192,
                 elastic: str = "off",
                 elastic_level: str | None = None,
                 elastic_max_workers: int | None = None,
                 elastic_backlog: int = 4,
                 elastic_cooldown_s: float = 0.0,
                 elastic_hysteresis: int = 2,
                 elastic_ttl_s: float | None = None):
        _check_mode("execution", execution, EXECUTION_MODES)
        _check_mode("executor", executor, EXECUTORS)
        _check_mode("resilience", resilience, RESILIENCE_MODES)
        _check_mode("balance", balance, BALANCE_MODES)
        _check_mode("streaming", streaming, STREAMING_MODES)
        _check_mode("storage", storage, STORAGE_MODES)
        _check_mode("admission", admission, POLICIES)
        _check_mode("elastic", elastic, ELASTIC_MODES)
        self.device = _check_device(device)
        self.topology = topology
        self.cluster = LocalCluster(topology)
        self.manager = ShuffleManager(journal_path=journal_path,
                                      replicas=replicas, plan_cache=plan_cache)
        self.execution = execution
        self.executor = executor
        self.resilience = resilience
        self.balance = balance
        self.skew_threshold = skew_threshold
        self.streaming = streaming
        self.chunk_bytes = chunk_bytes
        self.max_inflight = max_inflight
        self.max_retries = max_retries
        # knob attr holds the *mode string* (resolved like every other knob);
        # the store object itself lives separately on ``self.store``
        self.storage = storage
        self.store = ShuffleStore(
            LocalDirBackend(storage_dir) if storage_dir is not None
            else MemoryBackend())
        self.store.bind(self.cluster)
        self.admission_policy = admission
        self.admission_rate = admission_rate
        self.checkpoints = CheckpointStore()
        self.detector = FailureDetector(self.cluster, self.manager)
        self.coordinator = RecoveryCoordinator(self.cluster, self.manager,
                                               self.checkpoints)
        self.speculation = SpeculationPolicy()
        self.registry = TenantRegistry()
        self._clients: dict[str, TenantClient] = {}
        self._clients_lock = threading.Lock()
        self._admission = AdmissionQueue()
        self._run_pending_lock = threading.Lock()
        self._ids = itertools.count(1)
        # shuffle id -> tenant tag, bounded (introspection only: the journal
        # is the durable record) so a long-lived service never grows with
        # shuffle count
        self._owner: "OrderedDict[int, str]" = OrderedDict()
        self._owner_lock = threading.Lock()
        self._last_schedule: dict | None = None
        # ---- telemetry plane -------------------------------------------------
        # Metrics are always on (counters are cheap); the span tracer starts
        # as the no-op singleton unless tracing=True (or enable_tracing()).
        self.obs = self.cluster.obs
        if tracing:
            self.obs.enable_tracing(span_capacity)
        self.plan_cache.bind_metrics(self.obs.metrics)
        self.obs.metrics.register_collector(self._collect_gauges)
        m = self.obs.metrics
        self._m_shuffles = m.counter(
            "teshu_shuffles_total", "Completed shuffles by tenant/template/engine")
        self._m_fallbacks = m.counter(
            "teshu_fallbacks_total", "Executor declines by tenant/engine/reason")
        self._m_cache_lookups = m.counter(
            "teshu_cache_lookups_total", "Plan-cache lookups by tenant/outcome")
        self._m_drift = m.counter(
            "teshu_drift_invalidations_total",
            "Plan invalidations from observed drift, by tenant/kind")
        self._m_recovery_attempts = m.counter(
            "teshu_recovery_attempts_total", "Recovery retry attempts by tenant")
        self._m_restart_workers = m.histogram(
            "teshu_recovery_restart_workers",
            "Restart-set size per recovery attempt",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        self._m_admission_wait = m.histogram(
            "teshu_admission_wait_seconds",
            "Queue wait from submit() to execution in a run_pending() pass")
        self._m_batched = m.counter(
            "teshu_batched_dispatches_total",
            "Multi-submission batched dispatches by template")
        self._m_scale_events = m.counter(
            "teshu_scale_events_total", "Elastic scale events by kind/reason")
        # per-shuffle decision log (the always-on substrate of explain()),
        # bounded like the owner-tag table
        self._reports: "OrderedDict[int, dict]" = OrderedDict()
        self._reports_lock = threading.Lock()
        # ---- elastic topology -----------------------------------------------
        self.elastic = elastic
        if elastic == "off":
            self._elastic = None
        else:
            policy = ManualPolicy() if elastic == "manual" else BacklogPolicy(
                backlog_coflows=elastic_backlog,
                cooldown_s=elastic_cooldown_s,
                hysteresis=elastic_hysteresis)
            self._elastic = ElasticCoordinator(
                self, policy, LoadMonitor(), level=elastic_level,
                max_workers=elastic_max_workers, ttl_s=elastic_ttl_s)

    # ---- tenants --------------------------------------------------------------
    def tenant(self, tenant_id: str = DEFAULT_TENANT, *,
               quota: int | None = None, priority: float | None = None,
               storage_quota: int | None = None,
               **knobs) -> TenantClient:
        """Create-or-fetch the :class:`TenantClient` for ``tenant_id``.

        ``quota`` bounds the tenant's private plan-cache namespace (entries;
        unset = the namespace inherits the cache's default capacity);
        ``priority`` is its scheduling weight; ``storage_quota`` bounds the
        tenant's shuffle-store namespace (bytes; unset = unbounded).
        Remaining keyword knobs (``execution``, ``executor``, ``resilience``,
        ``balance``, ``skew_threshold``, ``streaming``, ``chunk_bytes``,
        ``max_inflight``, ``max_retries``, ``storage``) become the tenant's
        defaults.  Re-fetching an existing tenant with
        explicit arguments updates them; omitted ones are kept.
        """
        # validate knobs BEFORE touching cluster state: a rejected call must
        # not leave a phantom tenant behind (register() itself validates
        # quota/priority before mutating anything)
        knobs = _check_knobs(knobs)
        spec = self.registry.register(tenant_id, quota=quota, priority=priority,
                                      storage_quota=storage_quota)
        if quota is not None:
            self.plan_cache.set_budget(tenant_id, quota)
        if storage_quota is not None:
            self.store.set_quota(tenant_id, storage_quota)
        with self._clients_lock:
            client = self._clients.get(tenant_id)
            if client is None:
                client = TenantClient(self, spec, knobs)
                self._clients[tenant_id] = client
            elif knobs:
                # update in place: handles returned from earlier tenant()
                # calls observe new knobs, exactly like quota/priority updates
                # (the registry mutates the shared spec the same way)
                client._knobs.update(knobs)
        return client

    def tenants(self) -> list[str]:
        return self.registry.ids()

    def next_shuffle_id(self, tenant: str = DEFAULT_TENANT) -> int:
        sid = next(self._ids)
        with self._owner_lock:
            self._owner[sid] = tenant
            while len(self._owner) > _OWNER_TAG_CAPACITY:
                self._owner.popitem(last=False)
        return sid

    def shuffle_owner(self, shuffle_id: int) -> str | None:
        """Which tenant a recent cluster-allocated shuffle id belongs to
        (None once the tag aged out; the journal keeps the full history)."""
        with self._owner_lock:
            return self._owner.get(shuffle_id)

    @property
    def plan_cache(self) -> PlanCache:
        return self.manager.plan_cache

    # ---- elastic topology ------------------------------------------------------
    @property
    def elastic_epoch(self) -> int:
        """The topology epoch: 0 forever on a fixed cluster, +1 per scale
        event on an elastic one (part of every plan key past epoch 0)."""
        return 0 if self._elastic is None else self._elastic.epoch

    def _epoch(self) -> int:
        return 0 if self._elastic is None else self._elastic.epoch

    def _require_elastic(self) -> ElasticCoordinator:
        if self._elastic is None:
            raise RuntimeError("cluster is not elastic (elastic='off')")
        return self._elastic

    def scale_out(self, groups: int = 1, *,
                  reason: str = SCALE_REASON_MANUAL,
                  tenants: tuple = ()) -> tuple[int, ...]:
        """Ops hook: grow the cluster NOW (between batches).  Returns the new
        burst worker ids.  For scaling *inside* a pending batch use
        :meth:`request_scale_out` (manual mode)."""
        return self._require_elastic().scale_out(groups, reason=reason,
                                                 tenants=tenants)

    def scale_in(self, workers=None, *,
                 reason: str = SCALE_REASON_MANUAL) -> tuple[int, ...]:
        """Ops hook: gracefully drain burst workers NOW (all of them when
        ``workers`` is None).  Returns the ids removed."""
        return self._require_elastic().scale_in(workers, reason=reason)

    def request_scale_out(self, groups: int = 1, *,
                          after_coflows: int = 0) -> None:
        """Manual mode: arm a scale-out that fires at the first coflow
        boundary of the next ``run_pending`` pass where ``after_coflows``
        coflows have already executed (0 = before the first coflow)."""
        el = self._require_elastic()
        if not isinstance(el.policy, ManualPolicy):
            raise RuntimeError("request_scale_out requires elastic='manual'")
        el.policy.request(ScaleDecision(action="grow",
                                        reason=SCALE_REASON_MANUAL,
                                        groups=groups), after_coflows)

    def request_scale_in(self, workers: tuple = (), *,
                         after_coflows: int = 0) -> None:
        """Manual mode: arm a graceful scale-in ((), the default, drains all
        burst workers) for a coflow boundary or the pass-end idle point."""
        el = self._require_elastic()
        if not isinstance(el.policy, ManualPolicy):
            raise RuntimeError("request_scale_in requires elastic='manual'")
        el.policy.request(ScaleDecision(action="shrink",
                                        reason=SCALE_REASON_MANUAL,
                                        workers=tuple(workers)), after_coflows)

    def scale_events(self) -> list[dict]:
        """Every scale event (and denial) since construction, oldest first."""
        return [] if self._elastic is None else list(self._elastic.events)

    # ---- telemetry -------------------------------------------------------------
    def _collect_gauges(self):
        """Registry collector: gauges read from their canonical sources at
        snapshot time (ledger lanes, tracer occupancy, jit trace count) —
        never dual-written, so they can't drift from the sources."""
        snap = self.cluster.ledger.snapshot()
        out = [("teshu_modelled_time_seconds", {}, float(snap["modelled_time_s"])),
               ("teshu_bytes_total", {}, float(snap["total_bytes"])),
               ("teshu_cluster_workers", {}, float(self.topology.num_workers))]
        el = self._elastic
        if el is not None:
            out.append(("teshu_burst_workers", {}, float(len(el.burst))))
            for t, s in self.registry.burst_usage().items():
                out.append(("teshu_burst_worker_seconds", {"tenant": t},
                            float(s)))
        for t, b in snap.get("bytes_per_tenant", {}).items():
            out.append(("teshu_bytes_per_tenant", {"tenant": t}, float(b)))
        for lvl, b in snap.get("bytes_per_level", {}).items():
            out.append(("teshu_bytes_per_level", {"level": str(lvl)}, float(b)))
        out.append(("teshu_spill_bytes_total", {},
                    float(snap.get("spill_bytes", 0))))
        out.append(("teshu_restore_bytes_total", {},
                    float(snap.get("restore_bytes", 0))))
        st = self.store.stats()
        out.append(("teshu_storage_puts_total", {}, float(st["puts"])))
        out.append(("teshu_storage_put_bytes_total", {}, float(st["put_bytes"])))
        out.append(("teshu_storage_gets_total", {}, float(st["gets"])))
        out.append(("teshu_storage_staged_blocks", {},
                    float(st["staged_blocks"])))
        out.append(("teshu_storage_flushed_blocks_total", {},
                    float(st["flushed_blocks"])))
        out.append(("teshu_storage_flushed_bytes_total", {},
                    float(st["flushed_bytes"])))
        out.append(("teshu_storage_restored_bytes_total", {},
                    float(st["restored_bytes"])))
        out.append(("teshu_storage_declines_total", {},
                    float(st["declines"])))
        for t, b in st.get("usage_per_tenant", {}).items():
            out.append(("teshu_storage_usage_bytes", {"tenant": t}, float(b)))
        tracer = self.obs.tracer
        if tracer.enabled:
            out.append(("teshu_spans_recorded_total", {},
                        float(tracer.recorded_total)))
            out.append(("teshu_spans_dropped_total", {}, float(tracer.dropped)))
        return out

    def _note(self, shuffle_id: int, **kv) -> None:
        """Merge facts into the shuffle's decision-log entry (bounded FIFO)."""
        with self._reports_lock:
            rep = self._reports.get(shuffle_id)
            if rep is None:
                rep = self._reports[shuffle_id] = {}
                while len(self._reports) > _OWNER_TAG_CAPACITY:
                    self._reports.popitem(last=False)
            rep.update(kv)

    def _report_for(self, shuffle_id: int) -> dict | None:
        with self._reports_lock:
            rep = self._reports.get(shuffle_id)
            return dict(rep) if rep is not None else None

    def metrics(self) -> dict:
        """One snapshot of every metric family (counters + collector gauges)."""
        return self.obs.metrics.snapshot()

    def metrics_text(self) -> str:
        """The same snapshot in Prometheus text exposition format."""
        return self.obs.metrics.to_prometheus()

    def explain(self, shuffle_id: int) -> ShuffleReport:
        """Why did this shuffle fall back / miss the cache / rebalance /
        get drift-invalidated — see :class:`repro_torch.core.obs.ShuffleReport`."""
        return build_report(self, shuffle_id)

    def spans(self, shuffle_id: int | None = None) -> list[dict]:
        return self.obs.tracer.spans(shuffle_id)

    def export_spans(self, path: str) -> int:
        """Dump the flight recorder to JSONL; returns the span count."""
        return self.obs.tracer.export_jsonl(path)

    def enable_tracing(self, capacity: int = 8192) -> None:
        self.obs.enable_tracing(capacity)

    def disable_tracing(self) -> None:
        self.obs.disable_tracing()

    # ---- admission / cross-tenant scheduling ----------------------------------
    def pending(self) -> int:
        return len(self._admission)

    def run_pending(self, policy: str | None = None
                    ) -> "dict[int, ShuffleResult | Exception]":
        """Drain the admission queue through the coflow scheduler and execute.

        Submissions are grouped into coflows by (tenant, stage); the
        :class:`CoflowScheduler` orders them under ``policy`` (default: the
        cluster's admission policy) with per-tenant effective weights =
        registry priority x deficit boost from the ledger's per-tenant byte
        lanes; execution then follows the scheduled order.  Returns a result
        per ticket: a :class:`ShuffleResult` on success, or — isolation
        across tenants — the *exception* a failing shuffle raised (one
        tenant's failure never discards or skips another tenant's queued
        work).  The realized schedule — including each coflow's completion
        time in modelled seconds since the pass started and any failures —
        is available from :meth:`last_schedule`.

        Passes are serialized (overlapping calls queue on an internal lock,
        each draining whatever is pending when it enters).  Completion times
        are read off the shared ledger clock, so a *direct* ``shuffle()``
        running concurrently with a pass inflates the reported CCTs by its
        own modelled time; schedule tenants through the queue (or keep
        direct traffic off the cluster) while a pass you intend to measure
        is running.
        """
        policy = self.admission_policy if policy is None else policy
        _check_mode("admission", policy, POLICIES)
        with self._run_pending_lock:
            return self._run_pending_locked(policy)

    def _run_pending_locked(self, policy: str
                            ) -> "dict[int, ShuffleResult | Exception]":
        subs = self._admission.drain()
        el = self._elastic
        n_events0 = len(el.events) if el is not None else 0
        if el is not None:
            el.monitor.record(
                ts=self.cluster.ledger.modelled_time(),
                queue_depth=len(subs),
                pending_coflows=len({s.coflow_id for s in subs}),
                tenant_bytes=self.cluster.ledger.tenant_bytes())
        if not subs:
            # quiescent poll: the only place TTL expiry and policy-driven
            # scale-in run when no work is queued
            self._elastic_idle()
            return {}
        if el is not None:
            # boundary 0 (before any coflow) + re-target queued "all workers"
            # coflows BEFORE the scheduler and the batch probe see their
            # destination sets
            self._elastic_boundary(0, len({s.coflow_id for s in subs}), subs)
            el.rebalance(subs)
        weights = self.registry.effective_weights(
            self.cluster.ledger.tenant_bytes())
        reqs = [CoflowRequest(
            tenant=s.tenant, stage=s.stage, bufs=s.bufs,
            part_fn=s.kwargs.get("part_fn", HASH_PART),
            arrival=float(s.arrival),
            weight=weights.get(s.tenant, 1.0)) for s in subs]
        sched = CoflowScheduler(self.topology, policy,
                                demand_rate=self.admission_rate)
        entries = sched.plan(reqs)
        by_coflow: dict[tuple[str, str], list] = {}
        for s in subs:
            by_coflow.setdefault(s.coflow_id, []).append(s)
        batch_handles, batches = self._prepare_batches(subs)
        t0 = self.cluster.ledger.modelled_time()
        results: dict[int, ShuffleResult] = {}
        failures: dict[int, str] = {}
        ccts: dict[tuple[str, str], float] = {}
        tracer = self.obs.tracer
        for i, e in enumerate(entries):
            if el is not None and i > 0:
                # mid-batch boundary: the policy may grow the cluster between
                # coflows; later coflows are re-targeted onto burst workers
                remaining = [s for e2 in entries[i:]
                             for s in by_coflow.get(e2.coflow_id, ())]
                self._elastic_boundary(i, len(entries) - i, remaining)
            for s in by_coflow.get(e.coflow_id, ()):
                client = self._clients[s.tenant]
                wait = max(0.0, time.monotonic() - s.ts) if s.ts else 0.0
                self._m_admission_wait.observe(wait, tenant=s.tenant)
                if tracer.enabled:
                    tracer.point("admission_pass", tenant=s.tenant,
                                 ticket=s.ticket, stage=s.stage, wait_s=wait)
                try:
                    results[s.ticket] = client.shuffle(
                        s.template_id, s.bufs, s.srcs, s.dsts, **s.kwargs)
                except Exception as exc:  # noqa: BLE001 — isolation: one
                    # tenant's failing shuffle must not destroy the rest of
                    # the drained batch; the caller gets the exception back
                    results[s.ticket] = exc
                    failures[s.ticket] = f"{type(exc).__name__}: {exc}"
            ccts[e.coflow_id] = self.cluster.ledger.modelled_time() - t0
        if batch_handles:
            # close out any batch slice whose member ended up declining
            # solo (re-planned / invalidated mid-pass) so the shared epoch
            # barrier still settles
            torchplan.finish_batches(batch_handles, self.cluster.ledger)
        if el is not None:
            # close the pass with a realized-CCT sample, then the pass-end
            # idle point (TTL expiry + policy scale-in hysteresis tick)
            el.monitor.record(
                ts=self.cluster.ledger.modelled_time(),
                queue_depth=len(self._admission), pending_coflows=0,
                tenant_bytes=self.cluster.ledger.tenant_bytes(),
                ccts=tuple(ccts.values()))
            self._elastic_idle()
        self._last_schedule = {
            "policy": policy,
            "weights": {t: float(w) for t, w in sorted(weights.items())},
            "planned": entries,
            "ccts": ccts,
            "failures": failures,
            "batches": batches,
            "mean_cct_s": float(np.mean(list(ccts.values()))) if ccts else 0.0,
            "makespan_s": max(ccts.values(), default=0.0),
        }
        if el is not None:
            self._last_schedule["scale_events"] = el.events[n_events0:]
        return results

    # ---- elastic hooks ---------------------------------------------------------
    def _elastic_boundary(self, executed: int, pending: int,
                          remaining) -> None:
        """One policy evaluation at a coflow boundary (run_pending only)."""
        el = self._elastic
        if el is None:
            return
        d = el.policy.evaluate(el.monitor, pending_coflows=pending,
                               executed_coflows=executed,
                               at_capacity=el.at_capacity(),
                               has_burst=el.has_burst(), now=el.now())
        self._apply_decision(d, remaining)

    def _elastic_idle(self) -> None:
        """Quiescent point: expire TTL'd burst workers, then let the policy
        drain idle ones (both are graceful drains, never kills)."""
        el = self._elastic
        if el is None:
            return
        expired = el.expired()
        if expired:
            el.scale_in(expired, reason=SCALE_IN_TTL)
        d = el.policy.idle(el.monitor, has_burst=el.has_burst(), now=el.now())
        self._apply_decision(d, ())

    def _apply_decision(self, d: ScaleDecision, remaining) -> None:
        el = self._elastic
        if d.action == "grow":
            tenants = tuple(sorted({s.tenant for s in remaining}))
            if el.scale_out(max(1, d.groups), reason=d.reason,
                            tenants=tenants):
                el.rebalance(remaining)
        elif d.action == "shrink":
            if el.scale_in(d.workers or None, reason=d.reason):
                el.rebalance(remaining)
        elif d.action == "deny":
            el.deny(d.reason)

    def _repair_relevant(self, key: tuple, tenant: str) -> bool:
        """Could a repair scan possibly find a candidate for this miss?

        ``try_repair`` used to scan the tenant's namespace on *every* miss of
        a resilience-enabled cluster — including the common cold miss on a
        healthy, never-scaled topology, where no candidate can exist by
        construction (every cached key carries this same topology tag).
        Cheap predicate instead: an elastic epoch is active, the cluster
        carries fault state (lost/slow workers leave full-worker-set
        relatives behind), or the namespace holds plans under a *different*
        (topology tag, srcs) pair — the shared-cache degraded-service and
        participant-subset cases."""
        if self._epoch() > 0:
            return True
        if (self.cluster.failed_workers or self.cluster.worker_delays
                or self.cluster.fault_injections):
            return True
        return self.plan_cache.has_repair_relatives(key, tenant)

    def _prepare_batches(self, subs) -> tuple[list, list[dict]]:
        """Group drained submissions that will replay on the torch executor
        with one program signature AND identical routing tables, and run each
        group of >= 2 as ONE batched run up front
        (:func:`repro_torch.core.torchplan.prepare_batch`).  Members then
        consume their output slice when the scheduled pass reaches them,
        charging their own tenant's ledger lanes exactly as a serial replay
        would; the probe itself is side-effect-free (``plan_cache.peek``, no
        counters), so per-member metrics/journal records are written only by
        the real execution path.  A submission that fails the probe simply
        runs solo and reports its own fallback reason."""
        candidates = []
        for s in subs:
            client = self._clients.get(s.tenant)
            if client is None or s.kwargs.get("shuffle_id") is not None:
                continue
            kw = s.kwargs
            if (client.knob("execution", kw.get("execution")) != "auto"
                    or client.knob("executor", kw.get("executor")) != "torch"
                    or client.knob("resilience", kw.get("resilience")) != "off"
                    or client.knob("storage", kw.get("storage")) != "off"):
                continue
            try:
                template = self.manager.get_template(s.template_id, wid=None)
            except Exception:
                continue                      # unknown template fails solo
            balance = client.knob("balance", kw.get("balance"))
            if balance == "auto" and not template.rebalanceable:
                balance = "off"
            streaming = client.knob("streaming", kw.get("streaming"))
            if streaming == "auto" and not template.streamable:
                streaming = "off"
            if streaming != "off" or balance not in BALANCE_MODES:
                continue
            part_fn = kw.get("part_fn", HASH_PART)
            comb_fn = kw.get("comb_fn")
            rate = kw.get("rate", 0.01)
            skew_threshold = client.knob("skew_threshold",
                                         kw.get("skew_threshold"))
            key = plan_key(s.template_id, self.topology,
                           tuple(s.srcs), tuple(s.dsts),
                           stats_signature(s.bufs, part_fn, comb_fn, rate,
                                           balance=balance,
                                           skew_threshold=skew_threshold,
                                           streaming="off", stream=None),
                           epoch=self._epoch())
            plan = self.plan_cache.peek(key, s.tenant)
            if plan is None or plan.stream is not None:
                continue
            probe = ShuffleArgs(
                template_id=s.template_id, shuffle_id=-1,
                srcs=tuple(s.srcs), dsts=tuple(s.dsts),
                part_fn=part_fn, comb_fn=comb_fn, rate=rate,
                seed=kw.get("seed", 0), tenant=s.tenant, balance=balance,
                skew_threshold=skew_threshold, plan=plan)
            candidates.append((probe, s))
        if len(candidates) < 2:
            return [], []
        groups: dict[tuple, list] = {}
        for probe, s in candidates:
            sig = torchplan.batch_signature(self.cluster, probe, s.bufs)
            if sig is not None:
                groups.setdefault(sig, []).append((probe, s))
        handles, batches = [], []
        for members in groups.values():
            if len(members) < 2:
                continue
            handle = torchplan.prepare_batch(
                self.cluster, [(p, s.bufs) for p, s in members],
                device=self.device)
            if handle is None:
                continue
            handles.append(handle)
            batches.append({
                "template": members[0][0].template_id,
                "size": len(members),
                "tickets": [s.ticket for _, s in members],
                "tenants": sorted({s.tenant for _, s in members}),
            })
            self._m_batched.inc(template=members[0][0].template_id)
        return handles, batches

    def last_schedule(self) -> dict | None:
        """The most recent ``run_pending`` pass: policy, effective weights,
        planned entries, and realized per-coflow completion times."""
        return self._last_schedule

    # ---- the shuffle path ------------------------------------------------------
    def _shuffle(self, client: TenantClient, template_id: str,
                 bufs: dict[int, Msgs], srcs: Sequence[int],
                 dsts: Sequence[int], *, part_fn: PartFn,
                 comb_fn: Combiner | None, rate: float,
                 shuffle_id: int | None, seed: int,
                 execution: str | None, resilience: str | None,
                 balance: str | None, skew_threshold: float | None,
                 streaming: str | None, chunk_bytes: int | None,
                 max_inflight: int | None,
                 max_retries: int | None = None,
                 executor: str | None = None,
                 storage: str | None = None) -> ShuffleResult:
        tenant = client.tenant_id
        execution = _check_mode("execution", client.knob("execution", execution),
                                EXECUTION_MODES)
        executor = _check_mode("executor", client.knob("executor", executor),
                               EXECUTORS)
        resilience = _check_mode("resilience",
                                 client.knob("resilience", resilience),
                                 RESILIENCE_MODES)
        balance = _check_mode("balance", client.knob("balance", balance),
                              BALANCE_MODES)
        streaming = _check_mode("streaming", client.knob("streaming", streaming),
                                STREAMING_MODES)
        storage_mode = _check_mode("storage", client.knob("storage", storage),
                                   STORAGE_MODES)
        template = self.manager.get_template(template_id, wid=None)
        if balance == "auto" and not template.rebalanceable:
            # a template that re-partitions en route never carries a skew
            # decision: resolve to "off" up front so keying skips the skew
            # bucket pass and its plans don't split across skew epochs
            balance = "off"
        if streaming == "auto" and not template.streamable:
            # same resolution for the execution model: a non-streamable
            # template always runs the barrier, so key it that way
            streaming = "off"
        chunk = ChunkPlan(
            chunk_bytes=client.knob("chunk_bytes", chunk_bytes),
            max_inflight=client.knob("max_inflight", max_inflight)) \
            if streaming == "auto" else None
        args = ShuffleArgs(
            template_id=template_id,
            shuffle_id=(self.next_shuffle_id(tenant) if shuffle_id is None
                        else shuffle_id),
            srcs=tuple(srcs), dsts=tuple(dsts),
            part_fn=part_fn, comb_fn=comb_fn, rate=rate, seed=seed,
            tenant=tenant, balance=balance,
            skew_threshold=client.knob("skew_threshold", skew_threshold))

        key = plan_key(template_id, self.topology, args.srcs, args.dsts,
                       stats_signature(bufs, part_fn, comb_fn, rate,
                                       balance=balance,
                                       skew_threshold=args.skew_threshold,
                                       streaming=streaming, stream=chunk),
                       epoch=self._epoch())
        tracer = self.obs.tracer
        # the root span: a no-op _NULL_SPAN when tracing is off, a real
        # context-managed span (children nest via the thread-local stack) when on
        with tracer.span("shuffle", shuffle_id=args.shuffle_id, tenant=tenant,
                         template=template_id, execution=execution,
                         executor=executor) as root:
            # ---- plan lookup (+ cache explainability) -----------------------
            lk = tracer.span("plan_lookup", shuffle_id=args.shuffle_id,
                             tenant=tenant) if tracer.enabled else None
            if execution == "fresh":
                plan = None
                cache_info = {"outcome": "bypass", "reason": "execution_fresh"}
            else:
                plan = self.plan_cache.get(key, tenant)
                cache_info = {"outcome": "hit"} if plan is not None else None
            repaired = False
            if (plan is None and execution != "fresh"
                    and (resilience != "off" or self._elastic is not None)
                    and self._repair_relevant(key, tenant)):
                # no plan for this exact scenario — maybe a healthy-topology
                # (or full-worker-set, or stale-epoch) relative exists that
                # repair can adapt (within this tenant's namespace only)
                plan = try_repair(self.plan_cache, key, self.topology,
                                  part_fn=part_fn, tenant=tenant,
                                  tracer=tracer)
                repaired = plan is not None
                if repaired:
                    cache_info = {"outcome": "repaired"}
            if cache_info is None:
                cache_info = dict(self.plan_cache.explain_miss(key, tenant),
                                  outcome="miss")
            self._m_cache_lookups.inc(tenant=tenant,
                                      outcome=cache_info["outcome"])
            if lk is not None:
                lk.end(outcome=cache_info["outcome"],
                       reason=cache_info.get("reason"))
            self._note(args.shuffle_id, tenant=tenant, template=template_id,
                       execution=execution, requested_executor=executor,
                       cache=cache_info)
            if self._epoch() > 0:
                self._note(args.shuffle_id, elastic={
                    "epoch": self._elastic.epoch,
                    "workers": self.topology.num_workers,
                    "burst": list(self._elastic.burst_workers())})
            args.plan = plan
            # a cached plan replays the chunking policy it froze; a fresh
            # streamed run uses the resolved knobs (frozen at compile time)
            args.stream = (plan.stream
                           if plan is not None and plan.stream is not None
                           else chunk)
            if storage_mode != "off":
                # persist = write final per-(src, dst) partitions behind the
                # publish boards — only store-direct templates produce them
                # (hierarchical folds have no per-sender final block to keep);
                # min_stages pins a network-aware sender's persist point to
                # its *global* PART, past every local fold
                args.storage = StorageContext(
                    self.store, storage_mode, tenant,
                    persist=(storage_mode == "durable"
                             and template_id in STORE_DIRECT),
                    min_stages=(len(self.topology.levels) - 1
                                if template_id == "network_aware" else 0),
                    decline=("template_not_persistable"
                             if storage_mode == "durable"
                             and template_id not in STORE_DIRECT else None))

            try:
                try:
                    if resilience == "off":
                        res = self._run_plain(args, bufs, key, execution,
                                              executor, repaired)
                    else:
                        res = self._run_resilient(
                            args, bufs, key, execution, resilience, repaired,
                            client.knob("max_retries", max_retries), executor)
                except Exception as exc:
                    self._note(args.shuffle_id, status="failed",
                               error=f"{type(exc).__name__}: {exc}")
                    raise
            finally:
                # every exit drains + releases the shuffle's store namespace
                # and folds its storage telemetry into the decision log
                self._storage_epilogue(args, storage_mode)
            # ---- success notes + metrics ------------------------------------
            skew_info = None
            for d in res.decisions:
                if (isinstance(d, tuple) and len(d) == 2
                        and d[0] == "rebalance" and d[1] is not None):
                    dec = d[1]
                    skew_info = {"triggered": dec.triggered,
                                 "splits": len(dec.splits),
                                 "est_imbalance": float(dec.est_imbalance),
                                 "threshold": float(dec.threshold)}
            self._note(args.shuffle_id, status="ok", engine=res.engine,
                       fallback_reason=res.fallback_reason,
                       attempts=res.attempts, streamed=res.streamed,
                       skew=skew_info)
            self._m_shuffles.inc(tenant=tenant, template=template_id,
                                 engine=res.engine)
            root.set(engine=res.engine, attempts=res.attempts,
                     cache=cache_info["outcome"])
            return res

    def _storage_epilogue(self, args: ShuffleArgs, mode: str) -> None:
        """Drain + release one shuffle's store namespace on every exit.

        The synchronous ``flush`` is the last write-behind barrier (executors
        already flush before their after-snapshot, so ledger deltas stay
        deterministic — this one only catches aborted runs); the per-shuffle
        stats are journaled as a ``spill`` record when anything was flushed
        and folded into the decision log for ``explain()``."""
        st = args.storage
        if st is None:
            return
        sid = args.shuffle_id
        self.store.flush(sid)
        stats = self.store.take_shuffle_stats(st.tenant, sid)
        if stats.get("flushed_blocks"):
            self.manager.record_spill(
                sid, {"blocks": stats["flushed_blocks"],
                      "bytes": stats["flushed_bytes"]},
                tenant=st.tenant)
        info = {"mode": mode, "persist": st.persist}
        if st.decline is not None:
            info["decline"] = st.decline
        info.update({k: v for k, v in stats.items() if v})
        self._note(sid, storage=info)
        self.store.drop(st.tenant, sid)

    # ---- execution paths ------------------------------------------------------
    def _execute(self, args: ShuffleArgs, bufs: dict[int, Msgs],
                 execution: str, executor: str = "vectorized") -> ShuffleResult:
        fallbacks: list[dict] = []
        res = None
        if args.plan is not None and execution == "auto":
            if executor == "torch":
                # the torch data plane declines plans it cannot replay
                # (returns None) — fall through to vectorized, then threaded:
                # the same ladder every replay path descends, but now each
                # rung's decline reason is kept for explain()/metrics
                res = torchplan.try_run_torch(self.cluster, args, bufs,
                                              manager=self.manager,
                                              device=self.device)
                if res is None:
                    fallbacks.append({
                        "engine": "torch",
                        "reason": torchplan.decline_reason(
                            self.cluster, args, bufs) or "declined"})
            if res is None:
                vreason = vectorize_decline(self.cluster, args)
                if vreason is None:
                    res = run_shuffle_vectorized(self.cluster, args, bufs,
                                                 manager=self.manager)
                else:
                    fallbacks.append({"engine": "vectorized",
                                      "reason": vreason})
        if res is None:
            res = run_shuffle(self.cluster, args, bufs, manager=self.manager)
        if fallbacks:
            # the *requested* engine's decline code; the full chain goes to
            # the decision log (cluster.explain shows every rung)
            res.fallback_reason = fallbacks[0]["reason"]
            for fb in fallbacks:
                self._m_fallbacks.inc(tenant=args.tenant, engine=fb["engine"],
                                      reason=fb["reason"])
            self._note(args.shuffle_id, fallbacks=fallbacks)
        return res

    def _compile(self, args: ShuffleArgs, key: tuple, res: ShuffleResult) -> None:
        self.plan_cache.put(key, compile_plan(
            key, args.template_id, self.topology, args.srcs, args.dsts,
            res.decisions, res.observed,
            baseline_imbalance=dst_load_imbalance(res.stats, args.dsts),
            stream=args.stream), tenant=args.tenant)

    def _observe(self, args: ShuffleArgs, key: tuple, res: ShuffleResult) -> None:
        """Feed drift signals from a cached run: per-level reduction ratios,
        and — for skew-instantiated plans — the measured destination load
        imbalance vs the baseline the plan froze."""
        if self.plan_cache.observe(key, res.observed, tenant=args.tenant):
            self._drift_noted(args, {"kind": "reduction",
                                     "observed": dict(res.observed)})
        obs = dst_load_imbalance(res.stats, args.dsts)
        if obs is not None and self.plan_cache.observe_loads(
                key, obs, tenant=args.tenant):
            self._drift_noted(args, {"kind": "load",
                                     "observed_imbalance": float(obs)})

    def _drift_noted(self, args: ShuffleArgs, drift: dict) -> None:
        self._note(args.shuffle_id, drift=drift)
        self._m_drift.inc(tenant=args.tenant, kind=drift["kind"])
        tracer = self.obs.tracer
        if tracer.enabled:
            tracer.point("drift_invalidation", shuffle_id=args.shuffle_id,
                         tenant=args.tenant, **drift)

    def _run_plain(self, args: ShuffleArgs, bufs: dict[int, Msgs], key: tuple,
                   execution: str, executor: str = "vectorized",
                   repaired: bool = False) -> ShuffleResult:
        if args.plan is None:
            res = run_shuffle(self.cluster, args, bufs, manager=self.manager)
            self._compile(args, key, res)
            return res
        res = self._execute(args, bufs, execution, executor)
        res.repaired = repaired
        # Drift check: measured reductions from this cached run vs the plan's
        # baseline; a drifted entry is dropped so the next call re-instantiates.
        self._observe(args, key, res)
        return res

    def _run_resilient(self, args: ShuffleArgs, bufs: dict[int, Msgs], key: tuple,
                       execution: str, resilience: str, repaired: bool,
                       max_retries: int, executor: str = "vectorized"
                       ) -> ShuffleResult:
        sid = args.shuffle_id
        tenant = args.tenant
        participants = sorted(set(args.srcs) | set(args.dsts))
        recover = resilience == "recover"
        attempts = (max(0, max_retries) + 1) if recover else 1
        recovery_info: dict = {}
        rc = self.coordinator.initial_context(
            sid, args.template_id,
            speculated=self._speculate(sid, participants, attempt=0,
                                       enabled=recover, tenant=tenant),
            tenant=tenant)
        try:
            for attempt in range(attempts):
                args.recovery = rc
                try:
                    res = self._execute(args, bufs, execution, executor)
                    missing = set(args.dsts) - set(res.bufs)
                    if missing:
                        # a dst died without blocking anyone (e.g. pure
                        # receiver): its output is simply absent — still a
                        # failure.  Cleanup stays scoped to this shuffle's
                        # participants: other tenants' in-flight queues live on.
                        self.cluster.end_shuffle(sid, aborted=True,
                                                 participants=participants)
                        raise ShuffleAborted(
                            f"dsts {sorted(missing)} produced no output",
                            shuffle_id=sid)
                except ShuffleAborted as e:
                    report = self.detector.classify(sid, participants)
                    e.report = report
                    self.manager.record_failure(sid, report.to_info(),
                                                attempt=attempt, tenant=tenant)
                    if not recover or attempt == attempts - 1:
                        raise
                    # store-serving gate: only persisting, non-streamed runs;
                    # a fresh balance="auto" retry re-sizes the skew
                    # rendezvous by live participants, which served senders
                    # would break
                    serving = (args.storage is not None and args.storage.persist
                               and args.stream is None
                               and not (args.plan is None
                                        and args.balance == "auto"))
                    rc = self.coordinator.prepare_retry(
                        sid, args.template_id, args.srcs, self.topology,
                        report, attempt + 1,
                        speculated=self._speculate(sid, participants,
                                                   attempt=attempt + 1,
                                                   enabled=True, tenant=tenant),
                        tenant=tenant,
                        storage=args.storage if serving else None,
                        dsts=args.dsts,
                        hierarchical=(args.template_id == "network_aware"))
                    recovery_info = {
                        "restarted": sorted(report.dead),
                        "resume_stages": dict(rc.resume_stages),
                    }
                    if rc.store_served:
                        recovery_info["store_served"] = sorted(rc.store_served)
                    restart_set = {w for w in participants
                                   if rc.resume_stages.get(w, -1) < 0} \
                        | set(report.dead)
                    self._m_recovery_attempts.inc(tenant=tenant)
                    self._m_restart_workers.observe(len(restart_set),
                                                    tenant=tenant)
                    tracer = self.obs.tracer
                    if tracer.enabled:
                        tracer.point("recovery", shuffle_id=sid, tenant=tenant,
                                     attempt=attempt + 1,
                                     restarted=sorted(report.dead),
                                     restart_set=len(restart_set))
                    continue
                # ---- success ----------------------------------------------------
                if args.plan is None:
                    if attempt == 0:
                        # a recovered fresh run has per-worker partial decision
                        # lists — don't freeze those; the next call
                        # re-instantiates
                        self._compile(args, key, res)
                else:
                    self._observe(args, key, res)
                res.attempts = attempt + 1
                res.repaired = repaired
                if rc.speculated:
                    recovery_info["speculated"] = sorted(rc.speculated)
                if recovery_info:
                    res.recovery = recovery_info
                return res
            raise AssertionError("unreachable: retry loop exits via return/raise")
        finally:
            # every exit — success, diagnosed abort, or an unexpected error
            # (rendezvous timeout, user part_fn/comb_fn raising) — drops the
            # shuffle's checkpoints, so a long-lived service never accretes them
            self.checkpoints.clear(sid)

    def _speculate(self, shuffle_id: int, participants, attempt: int,
                   enabled: bool, tenant: str = DEFAULT_TENANT) -> frozenset:
        """Backup-task planning; only ``"recover"`` may alter execution —
        ``"detect"`` must observe stragglers, not paper over them."""
        if not enabled or not self.cluster.worker_delays:
            return frozenset()
        tasks = self.speculation.plan(self.cluster, participants)
        if not tasks:
            return frozenset()
        self.manager.record_speculation(
            shuffle_id, {"tasks": [t.to_info() for t in tasks]},
            attempt=attempt, tenant=tenant)
        return frozenset(t.wid for t in tasks)

    # ---- ops hooks -----------------------------------------------------------
    def stats(self) -> dict:
        return self.cluster.ledger.snapshot()

    def cache_stats(self) -> dict:
        return self.plan_cache.stats()

    def reset_stats(self) -> None:
        self.cluster.reset_ledger()

    def fail_worker(self, wid: int) -> None:
        self.cluster.failed_workers.add(wid)

    def heal_worker(self, wid: int) -> None:
        self.cluster.failed_workers.discard(wid)

    def restart_worker(self, wid: int) -> None:
        self.cluster.restart_worker(wid)

    def delay_worker(self, wid: int, seconds: float) -> None:
        self.cluster.worker_delays[wid] = seconds

    def inject_fault(self, wid: int, after_stage: int = -1,
                     after_chunk: int | None = None) -> None:
        """Kill ``wid`` mid-shuffle once it completes ``after_stage`` stages —
        or, on streamed runs, ``after_chunk`` chunk units of the global stream
        (see :class:`repro_torch.core.primitives.FaultInjection`)."""
        self.cluster.inject_fault(wid, after_stage, after_chunk)

    def clear_fault(self, wid: int) -> None:
        self.cluster.clear_fault(wid)

    def checkpoint_stats(self) -> dict:
        return self.checkpoints.stats()


class TeShuService(TeShuCluster):
    """**Deprecated facade**: the seed-era single-application service.

    A ``TeShuService`` *is* a :class:`TeShuCluster` that registers the
    :data:`~repro_torch.core.tenancy.DEFAULT_TENANT` at construction and forwards
    ``shuffle()`` / ``open_stream()`` to its client — one implicit tenant,
    exactly the old semantics (journal lines, plan keys, and ledger stats are
    unchanged for this tenant).  Existing callers keep working; new code
    should construct a :class:`TeShuCluster` and take explicit
    ``cluster.tenant(...)`` handles, which is where quotas, priorities, and
    cross-tenant scheduling live.
    """

    def __init__(self, topology: NetworkTopology, *,
                 journal_path: str | None = None,
                 replicas: Sequence[str] = (),
                 plan_cache: PlanCache | None = None,
                 device: str | torch.device = "cuda",
                 execution: str = "auto", executor: str = "torch",
                 resilience: str = "off",
                 balance: str = "off",
                 skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
                 streaming: str = "off",
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 max_retries: int = 2,
                 storage: str = "off",
                 storage_dir: str | None = None,
                 tracing: bool = False,
                 span_capacity: int = 8192):
        super().__init__(topology, journal_path=journal_path, replicas=replicas,
                         plan_cache=plan_cache, device=device,
                         execution=execution,
                         executor=executor, resilience=resilience,
                         balance=balance,
                         skew_threshold=skew_threshold, streaming=streaming,
                         chunk_bytes=chunk_bytes, max_inflight=max_inflight,
                         max_retries=max_retries, storage=storage,
                         storage_dir=storage_dir, tracing=tracing,
                         span_capacity=span_capacity)
        self.tenant(DEFAULT_TENANT)

    def _default_client(self) -> TenantClient:
        # hot path: a plain dict read (clients are only ever replaced under
        # the lock, never deleted, so the current object is always visible);
        # re-resolving via tenant() would pay two lock round-trips per call
        client = self._clients.get(DEFAULT_TENANT)
        return client if client is not None else self.tenant(DEFAULT_TENANT)

    def shuffle(self, template_id: str, bufs: dict[int, Msgs],
                srcs: Sequence[int], dsts: Sequence[int], **kwargs
                ) -> ShuffleResult:
        return self._default_client().shuffle(template_id, bufs, srcs, dsts,
                                              **kwargs)

    def open_stream(self, template_id: str, srcs: Sequence[int],
                    dsts: Sequence[int], **kwargs) -> StreamSession:
        return self._default_client().open_stream(template_id, srcs, dsts,
                                                  **kwargs)
