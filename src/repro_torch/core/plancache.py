"""Plan compilation and caching: reuse instantiated shuffle plans across calls.

Instantiating a template is control-plane work — neighbor discovery
(``$FIND_NBRS_PER_*``), partition-aware sampling (``SAMP``), and the sampling-server
EFF/COST rendezvous (``$COMPUTE_EFF_COST``) — that the paper's templates repeat on
*every* shuffle.  For iterative workloads (PageRank supersteps, MoE dispatch every
layer, gradient buckets every step) the decision inputs barely change between calls,
so the instantiated plan can be compiled once and replayed.

A :class:`CompiledPlan` freezes everything instantiation produced:

* the neighbor list of every worker at every hierarchy level, and
* the EFF/COST verdict (with its estimated reduction ratio r̂) per level.

Plans are keyed by ``(template_id, topology fingerprint, stats signature)``.  The
*stats signature* (:func:`stats_signature`) is a coarse, cheap-to-compute sketch of
the workload — participant sets, partFunc/combFunc identity, sampling rate, and
log2-bucketed message counts — so shuffles whose statistics merely jitter still hit,
while a workload that changes shape (different key space, different skew bucket,
different worker set) misses and re-instantiates.

Invalidation is *observational*: every cached execution measures the actual data
reduction each beneficial stage achieved, and the cache compares it against the
plan's baseline ratio (:func:`repro_torch.core.adaptive.reduction_drift`).  A drifted
ratio means the sampled statistics no longer describe the data: the entry is
dropped and the next shuffle re-instantiates from fresh samples.  A ``refresh_every``
knob additionally forces periodic re-instantiation so a stage that was *rejected*
(and therefore produces no observations) can be reconsidered.

The cache itself lives on the Shuffle Manager (paper §3.3 — the manager "stores"
control-plane state); :class:`repro_torch.core.service.TeShuService` consults it on every
``shuffle()`` call.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np

from .adaptive import EffCost, reduction_drift
from .messages import Combiner, Msgs, PartFn, splitmix64
from .skew import SkewDecision
from .streaming import ChunkPlan
from .tenancy import DEFAULT_TENANT
from .topology import NetworkTopology

# Levels whose observed reduction drifts by more than this (absolute) from the
# plan's baseline invalidate the plan (see adaptive.reduction_drift).
DRIFT_TOLERANCE = 0.15
# A cached plan whose observed per-destination load imbalance (max/mean of
# received bytes) moves more than this from the imbalance measured on the
# plan's own fresh run is describing a workload that no longer exists.
SKEW_DRIFT_TOLERANCE = 0.5


# ---------------------------------------------------------------------------
# Stats signature
# ---------------------------------------------------------------------------

def _log2_bucket(n: int) -> int:
    """Quantize a count to its log2 bucket (0 for empty) — jitter-stable."""
    return int(n).bit_length()


# Hashed-share skew bucketing: 128 hash buckets keep collision inflation small
# (k keys land ~k/128 per bucket), and the floor clamps every share below the
# rebalance-relevant regime (~1/16, the mean destination load at ndst <= 16)
# into one bucket so merely-jittery uniform workloads keep aliasing.
_SKEW_HASH_BUCKETS = 128
_SKEW_BUCKET_FLOOR = -4
_SKEW_HASH_SEED = 0x5EAF


def skew_bucket(bufs: dict[int, Msgs]) -> int:
    """log2 bucket of the pooled top hashed-key-bucket share (skew sketch).

    The max share of any of ``_SKEW_HASH_BUCKETS`` hash buckets upper-bounds —
    and for a genuinely hot key, tracks — the top *key* share, in one O(n)
    pass without materializing per-key counts.  ``floor(log2(share))`` is then
    clamped at ``_SKEW_BUCKET_FLOOR``: 0 means one key is ~everything, -4 (the
    floor) covers every distribution too flat for rebalancing to care.  Skewed
    and uniform epochs therefore never alias, while uniform epochs of any
    flatness all do.
    """
    total = sum(m.n for m in bufs.values())
    if total == 0:
        return _SKEW_BUCKET_FLOOR
    acc = np.zeros(_SKEW_HASH_BUCKETS, dtype=np.int64)
    for m in bufs.values():
        if m.n:
            b = (splitmix64(m.keys, seed=_SKEW_HASH_SEED)
                 % np.uint64(_SKEW_HASH_BUCKETS)).astype(np.int64)
            acc += np.bincount(b, minlength=_SKEW_HASH_BUCKETS)
    share = float(acc.max()) / total
    return max(_SKEW_BUCKET_FLOOR, int(np.floor(np.log2(share))))


def stats_signature(
    bufs: dict[int, Msgs],
    part_fn: PartFn,
    comb_fn: Combiner | None,
    rate: float,
    balance: str = "off",
    skew_threshold: float | None = None,
    streaming: str = "off",
    stream: ChunkPlan | None = None,
) -> tuple:
    """Coarse sketch of a shuffle's decision inputs; equal sketch => reusable plan.

    Components (all O(total messages) numpy scans, no hashing of payloads):

    * partFunc / combFunc identity, the sampling rate, the balance mode and —
      under ``"auto"`` — the skew threshold: different functions partition or
      reduce differently, and a skew-rebalanced plan must never serve a
      ``balance="off"`` caller or one that asked for a different rebalance
      trigger point, so none of these alias;
    * per-worker message-count log2 buckets — captures data placement and skew at
      the granularity the EFF/COST model is sensitive to;
    * a key-space bucket (log2 of the max key) — a workload that suddenly spans a
      different key universe has different duplication structure;
    * a skew bucket (:func:`skew_bucket`, log2 of the sampled top-key share) —
      plans instantiated on skewed vs uniform epochs never alias.  Only
      computed under ``balance="auto"`` (it is what makes skew verdicts safe
      to replay); ``"off"`` plans carry no skew decision to alias, so the
      default mode skips the extra O(n) hashing pass entirely;
    * the payload width — the wire format the cost model charges;
    * the streaming mode and — under ``"auto"`` — the chunking-policy bucket
      (:meth:`repro_torch.core.streaming.ChunkPlan.signature`): a plan compiled as a
      barrier carries no frozen ChunkPlan and must never serve a pipelined
      caller (and vice versa), so the execution models never alias.  Byte
      identity of the streamed path makes *within*-bucket aliasing safe —
      any chunking of the same data yields the same bytes.

    The per-worker ``counts`` tuple stays last: plan repair's participant-subset
    matching (:func:`repro_torch.core.resilience.repair.try_repair`) relies on every
    other component comparing positionally when workers are lost.
    """
    widths = {m.width for m in bufs.values() if m.n} or {1}
    max_key = 0
    for m in bufs.values():
        if m.n:
            mk = int(m.keys.max())
            if mk > max_key:
                max_key = mk
    counts = tuple((int(w), _log2_bucket(m.n)) for w, m in sorted(bufs.items()))
    return (
        part_fn.name,
        comb_fn.name if comb_fn is not None else None,
        float(rate),
        str(balance),
        float(skew_threshold) if balance == "auto" and skew_threshold is not None
        else None,
        tuple(sorted(widths)),
        _log2_bucket(max_key),
        skew_bucket(bufs) if balance == "auto" else None,
        stream.signature() if streaming == "auto" and stream is not None else None,
        counts,
    )


def topology_tag(topology: NetworkTopology, epoch: int = 0) -> tuple:
    """The key's topology component: the fingerprint, epoch-tagged when elastic.

    Epoch 0 (every non-elastic cluster, and an elastic cluster before its
    first scale event) keeps the bare fingerprint — keys are byte-identical
    to the pre-elastic format, so existing journals, caches, and tests are
    untouched.  After a scale event the tag becomes ``(fingerprint, epoch)``:
    every plan cached under an older epoch stops being *reachable by key*
    instantly — O(1) invalidation with no namespace scan — while remaining a
    repair candidate (:func:`repro_torch.core.resilience.repair.try_repair` re-keys
    it onto the new epoch when the topology still fits).
    """
    fp = topology.fingerprint()
    return fp if epoch == 0 else (fp, epoch)


def split_topology_tag(tag: tuple) -> tuple[tuple, int]:
    """Invert :func:`topology_tag` -> (fingerprint, epoch).

    Unambiguous: a bare fingerprint is a tuple of level *tuples*, so its
    second element is never an int.
    """
    if len(tag) == 2 and isinstance(tag[1], int):
        return tag[0], tag[1]
    return tag, 0


def plan_key(template_id: str, topology: NetworkTopology,
             srcs: Sequence[int], dsts: Sequence[int], signature: tuple,
             epoch: int = 0) -> tuple:
    """Full cache key: plans never alias across participant sets, topologies,
    or elastic topology epochs."""
    return (template_id, topology_tag(topology, epoch), tuple(srcs),
            tuple(dsts), signature)


# Positional names of the plan-key and stats-signature components, for the
# explainability surface: a cache miss is diagnosed by diffing the missed key
# against its closest cached relative and naming the components that diverged.
# Must track plan_key()/stats_signature() ordering.
KEY_COMPONENTS = ("template", "topology", "srcs", "dsts", "signature")
SIG_COMPONENTS = ("part_fn", "comb_fn", "rate", "balance", "skew_threshold",
                  "widths", "key_bucket", "skew_bucket", "stream", "counts")


def key_diff(a: tuple, b: tuple) -> list[str]:
    """Names of the plan-key components on which ``a`` and ``b`` diverge;
    signature components are reported as ``signature.<component>``."""
    out = []
    for name, xa, xb in zip(KEY_COMPONENTS, a, b):
        if xa == xb:
            continue
        if name == "topology":
            # same physical layout under different elastic epochs is an
            # epoch-only divergence — its own diagnosis (the plan was
            # invalidated by a scale event, not by a layout change)
            fa, ea = split_topology_tag(xa)
            fb, eb = split_topology_tag(xb)
            out.append("topology" if fa != fb else "topology.epoch")
            continue
        if name != "signature":
            out.append(name)
            continue
        out.extend(f"signature.{sig}"
                   for sig, sa, sb in zip(SIG_COMPONENTS, xa, xb) if sa != sb)
    return out


# ---------------------------------------------------------------------------
# Compiled plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LevelDecision:
    """One instantiated hierarchical stage of an adaptive template."""

    level: str                             # topology level name
    eff_cost: EffCost                      # the frozen $COMPUTE_EFF_COST verdict
    nbrs: dict[int, tuple[int, ...]]       # wid -> neighbors (incl. wid), frozen
    baseline_r: float                      # reduction ratio the plan was built on

    @property
    def beneficial(self) -> bool:
        return self.eff_cost.beneficial


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """A fully instantiated (template x topology x stats) shuffle plan.

    Replaying a plan skips neighbor discovery, sampling, and EFF/COST estimation;
    the executor (threaded or vectorized) only moves and combines data.
    """

    key: tuple
    template_id: str
    srcs: tuple[int, ...]
    dsts: tuple[int, ...]
    levels: tuple[LevelDecision, ...]      # innermost-first; empty for static templates
    skew: SkewDecision | None = None       # frozen skew-aware instantiation verdict
    baseline_imbalance: float | None = None
    # ^ max/mean per-destination received bytes measured on the plan's own
    #   fresh run — the load-drift baseline (ground truth, like baseline_r).
    stream: ChunkPlan | None = None
    # ^ frozen chunking policy when the plan was compiled from a streamed run:
    #   replays (threaded or vectorized) chunk exactly like the run that froze
    #   it.  None = the plan executes as a barrier.

    def level(self, name: str) -> LevelDecision | None:
        for ld in self.levels:
            if ld.level == name:
                return ld
        return None

    @property
    def decisions(self) -> list[tuple[str, EffCost]]:
        out: list = []
        if self.skew is not None:
            # fresh instantiation records the rebalance verdict before any
            # hierarchy-level verdicts; replays report the same order
            out.append(("rebalance", self.skew))
        out.extend((ld.level, ld.eff_cost) for ld in self.levels)
        return out


def compile_plan(
    key: tuple,
    template_id: str,
    topology: NetworkTopology,
    srcs: Sequence[int],
    dsts: Sequence[int],
    decisions: Sequence[tuple[str, EffCost]],
    observed: dict[str, float] | None = None,
    baseline_imbalance: float | None = None,
    stream: ChunkPlan | None = None,
) -> CompiledPlan:
    """Freeze a fresh run's instantiation into a replayable plan.

    ``decisions`` are the (level, EffCost) pairs the adaptive template recorded
    (identical across workers: the sampling server broadcasts one verdict),
    plus at most one ``("rebalance", SkewDecision)`` entry from skew-aware
    instantiation, which freezes as the plan's ``skew``.
    ``observed`` maps level -> measured reduction ratio from the fresh run's actual
    exchanges; when present it becomes the drift baseline (ground truth beats the
    sample estimate it validated).  ``baseline_imbalance`` is the fresh run's
    measured per-destination load imbalance (the load-drift baseline).
    Neighbor lists are materialized per worker with one vectorized group
    computation per level.
    """
    srcs = tuple(srcs)
    observed = observed or {}
    wids = np.asarray(srcs, dtype=np.int64)
    levels = []
    skew = None
    for level_name, ec in decisions:
        if level_name == "rebalance":
            skew = ec
            continue
        lv = topology.level(level_name)
        groups = wids // lv.group_size                   # vectorized $FIND_NBRS
        nbrs: dict[int, tuple[int, ...]] = {}
        for g in np.unique(groups):
            members = tuple(int(w) for w in wids[groups == g])
            for w in members:
                nbrs[w] = members
        baseline = observed.get(level_name, ec.reduction_ratio)
        levels.append(LevelDecision(level=level_name, eff_cost=ec, nbrs=nbrs,
                                    baseline_r=baseline))
    return CompiledPlan(key=key, template_id=template_id, srcs=srcs,
                        dsts=tuple(dsts), levels=tuple(levels), skew=skew,
                        baseline_imbalance=baseline_imbalance, stream=stream)


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

# The counter set every namespace (and the pooled view) carries; one literal
# so adding a counter cannot silently diverge the three stats surfaces.
_STATS_KEYS = ("hits", "misses", "invalidations", "refreshes", "evictions",
               "repairs")


# How many recently-invalidated keys a namespace remembers, with the cause —
# the explainability surface uses them to say "this miss is the invalidation
# you triggered last call", not just "miss".
_INVALIDATION_MEMORY = 512


class _Namespace:
    """One tenant's private plan store: its own LRU order, budget, counters."""

    __slots__ = ("plans", "hits_by_key", "capacity", "stats", "invalidated",
                 "tags")

    def __init__(self, capacity: int):
        self.plans: OrderedDict[tuple, CompiledPlan] = OrderedDict()
        self.hits_by_key: dict[tuple, int] = {}
        self.capacity = capacity
        self.stats = dict.fromkeys(_STATS_KEYS, 0)
        # key -> why it was dropped ("reduction_drift" | "load_drift" |
        # "refresh" | "explicit"), bounded FIFO
        self.invalidated: OrderedDict[tuple, str] = OrderedDict()
        # (topology-tag, srcs) -> live entry count: the cheap predicate
        # behind the repair-scan short-circuit (has_repair_relatives); a
        # handful of distinct pairs at most, maintained at every
        # insert/remove
        self.tags: dict[tuple, int] = {}

    def note_invalidated(self, key: tuple, kind: str) -> None:
        self.invalidated[key] = kind
        self.invalidated.move_to_end(key)
        while len(self.invalidated) > _INVALIDATION_MEMORY:
            self.invalidated.popitem(last=False)

    def tag_add(self, key: tuple) -> None:
        t = key[1:3]
        self.tags[t] = self.tags.get(t, 0) + 1

    def tag_drop(self, key: tuple) -> None:
        t = key[1:3]
        n = self.tags.get(t, 0) - 1
        if n > 0:
            self.tags[t] = n
        else:
            self.tags.pop(t, None)


class PlanCache:
    """Tenant-namespaced LRU cache of :class:`CompiledPlan` with drift-based
    invalidation.

    Every operation takes a ``tenant`` namespace (default: the single-tenant
    facade's :data:`~repro_torch.core.tenancy.DEFAULT_TENANT`); namespaces are fully
    isolated — a lookup never returns another tenant's plan, and each
    namespace runs its own LRU under its own entry budget, so one tenant's
    churn cannot evict another's working set.  ``capacity`` is the budget a
    namespace gets unless :meth:`set_budget` assigns it one (the service maps
    the tenant's ``quota`` knob to that call).

    Thread-safe: the manager serving multiple application threads shares one
    instance.  ``stats()`` exposes pooled hit/miss/invalidation counters plus
    a per-tenant breakdown (surfaced by the service, the launch drivers, and
    the benchmarks).
    """

    def __init__(self, capacity: int = 256, *,
                 drift_tolerance: float = DRIFT_TOLERANCE,
                 skew_drift_tolerance: float = SKEW_DRIFT_TOLERANCE,
                 refresh_every: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self.drift_tolerance = drift_tolerance
        self.skew_drift_tolerance = skew_drift_tolerance
        self.refresh_every = refresh_every          # 0 = never force re-instantiation
        self._spaces: dict[str, _Namespace] = {}
        self._lock = threading.Lock()
        self._metrics = None
        # How many times repair has snapshotted a namespace (scan()).  Not
        # part of _STATS_KEYS: it measures the *gate* in front of repair, not
        # cache effectiveness, and the zero-scan regression test reads it.
        self.scans = 0

    def _space(self, tenant: str) -> _Namespace:
        ns = self._spaces.get(tenant)
        if ns is None:
            ns = self._spaces[tenant] = _Namespace(self.capacity)
        return ns

    def set_budget(self, tenant: str, capacity: int) -> None:
        """Assign ``tenant``'s namespace its own LRU entry budget (shrinking
        below the current size evicts LRU-first immediately)."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        with self._lock:
            ns = self._space(tenant)
            ns.capacity = capacity
            while len(ns.plans) > ns.capacity:
                old, _ = ns.plans.popitem(last=False)
                ns.hits_by_key.pop(old, None)
                ns.tag_drop(old)
                ns.stats["evictions"] += 1

    # ---- lookup --------------------------------------------------------------
    def get(self, key: tuple, tenant: str = DEFAULT_TENANT) -> CompiledPlan | None:
        with self._lock:
            ns = self._space(tenant)
            plan = ns.plans.get(key)
            if plan is None:
                ns.stats["misses"] += 1
                return None
            hits = ns.hits_by_key.get(key, 0) + 1
            if self.refresh_every and hits > self.refresh_every:
                # Periodic refresh: drop the entry so rejected stages (which emit
                # no drift observations) get re-evaluated from fresh samples.
                del ns.plans[key]
                del ns.hits_by_key[key]
                ns.tag_drop(key)
                ns.note_invalidated(key, "refresh")
                ns.stats["refreshes"] += 1
                ns.stats["misses"] += 1
                return None
            ns.hits_by_key[key] = hits
            ns.plans.move_to_end(key)
            ns.stats["hits"] += 1
            return plan

    def peek(self, key: tuple, tenant: str = DEFAULT_TENANT) -> CompiledPlan | None:
        """The cached plan without ANY accounting side effects: no hit/miss
        counters, no LRU reorder, no periodic refresh.  The admission
        batcher's probe pass uses this so grouping submissions for one
        vmapped dispatch leaves cache statistics exactly as the subsequent
        real ``get`` calls will write them."""
        with self._lock:
            ns = self._spaces.get(tenant)
            return None if ns is None else ns.plans.get(key)

    def put(self, key: tuple, plan: CompiledPlan, *, repaired: bool = False,
            tenant: str = DEFAULT_TENANT) -> None:
        with self._lock:
            ns = self._space(tenant)
            if repaired:
                ns.stats["repairs"] += 1
            if key not in ns.plans:
                ns.tag_add(key)
            ns.plans[key] = plan
            ns.invalidated.pop(key, None)   # re-compiled: the drop is history
            ns.plans.move_to_end(key)
            ns.hits_by_key.setdefault(key, 0)
            while len(ns.plans) > ns.capacity:
                old, _ = ns.plans.popitem(last=False)
                ns.hits_by_key.pop(old, None)
                ns.tag_drop(old)
                ns.stats["evictions"] += 1

    def scan(self, tenant: str = DEFAULT_TENANT) -> list[tuple[tuple, CompiledPlan]]:
        """Snapshot of (key, plan) pairs, MRU last, within one tenant's
        namespace.  Used by the resilience layer's plan repair to find a
        healthy-topology base plan for a degraded scenario — repair never
        crosses tenant namespaces; does not touch hit/miss accounting or LRU
        order."""
        with self._lock:
            self.scans += 1
            return list(self._space(tenant).plans.items())

    def has_repair_relatives(self, key: tuple,
                             tenant: str = DEFAULT_TENANT) -> bool:
        """Could a repair scan find a candidate for ``key`` in ``tenant``'s
        namespace?  Sound over-approximation in O(#distinct pairs): every
        repair case (degraded topology, elastic epoch re-key, lost-worker
        participant subset) requires a cached plan differing from ``key`` in
        its topology tag or its ``srcs`` — when every cached plan shares
        both, no candidate can exist and the namespace :meth:`scan` is
        skipped entirely (the cold healthy-cluster fast path)."""
        with self._lock:
            ns = self._spaces.get(tenant)
            return ns is not None and any(t != key[1:3]
                                          for t in ns.tags)

    def invalidate(self, key: tuple, tenant: str = DEFAULT_TENANT,
                   kind: str = "explicit") -> bool:
        """Drop one entry; ``kind`` records *why* (drift observers pass
        ``"reduction_drift"``/``"load_drift"``) so a subsequent miss on the
        same key can be explained as this invalidation."""
        with self._lock:
            ns = self._space(tenant)
            if key in ns.plans:
                del ns.plans[key]
                ns.hits_by_key.pop(key, None)
                ns.tag_drop(key)
                ns.note_invalidated(key, kind)
                ns.stats["invalidations"] += 1
                return True
            return False

    def clear(self, tenant: str | None = None) -> None:
        """Empty one tenant's namespace, or every namespace when ``None``.

        Only the cached plans are dropped — each namespace keeps its budget
        (the service's ``quota`` assignment) and its counters, so flushing
        plans never lets a tenant escape its quota."""
        with self._lock:
            if tenant is None:
                spaces = list(self._spaces.values())
            else:
                ns = self._spaces.get(tenant)
                spaces = [ns] if ns is not None else []
            for ns in spaces:
                ns.plans.clear()
                ns.hits_by_key.clear()
                ns.tags.clear()

    # ---- drift ---------------------------------------------------------------
    def observe(self, key: tuple, observed: dict[str, float],
                tenant: str = DEFAULT_TENANT) -> bool:
        """Feed measured per-level reduction ratios from a cached execution.

        Returns True (and drops the entry) if any level's observation drifted
        beyond ``drift_tolerance`` from the plan's baseline.
        """
        with self._lock:
            plan = self._space(tenant).plans.get(key)
        if plan is None:
            return False
        for level_name, r_obs in observed.items():
            ld = plan.level(level_name)
            if ld is not None and reduction_drift(ld.baseline_r, r_obs,
                                                  tolerance=self.drift_tolerance):
                return self.invalidate(key, tenant, kind="reduction_drift")
        return False

    def observe_loads(self, key: tuple, observed_imbalance: float,
                      tenant: str = DEFAULT_TENANT) -> bool:
        """Feed the measured per-destination load imbalance (max/mean received
        bytes) from a cached execution.

        Only plans that carry a skew verdict participate: their
        ``baseline_imbalance`` was measured on the fresh run they froze, so a
        deviation beyond ``skew_drift_tolerance`` means the key distribution
        moved — a hot key appeared under a plan that didn't split it, or the
        splits a plan replays are no longer warranted.  Returns True (and
        drops the entry) on drift.
        """
        with self._lock:
            plan = self._space(tenant).plans.get(key)
        if plan is None or plan.skew is None or plan.baseline_imbalance is None:
            return False
        if abs(plan.baseline_imbalance - observed_imbalance) \
                > self.skew_drift_tolerance:
            return self.invalidate(key, tenant, kind="load_drift")
        return False

    # ---- explainability ------------------------------------------------------
    def explain_miss(self, key: tuple, tenant: str = DEFAULT_TENANT) -> dict:
        """Why would ``get(key, tenant)`` miss *right now*?  Read-only (no
        counter or LRU effects).

        Returns ``{"reason": code, "diff": [component names], "invalidated":
        kind-or-None}``.  Reasons: ``"invalidated_<kind>"`` when the exact key
        was recently dropped (drift, refresh, explicit) and not re-compiled;
        ``"cold"`` when the namespace holds no plan for this template at all;
        ``"key_mismatch"`` otherwise, with ``diff`` naming the components on
        which the closest cached candidate (fewest diverging components, same
        template preferred) differs — e.g. ``["signature.counts"]`` for a
        workload whose per-worker message counts left their log2 buckets.
        """
        with self._lock:
            ns = self._spaces.get(tenant)
            if ns is None:
                return {"reason": "cold", "diff": [], "invalidated": None}
            dropped = ns.invalidated.get(key)
            candidates = list(ns.plans)
        if dropped is not None:
            return {"reason": f"invalidated_{dropped}", "diff": [],
                    "invalidated": dropped}
        same_template = [k for k in candidates if k[0] == key[0]]
        pool = same_template or candidates
        if not pool:
            return {"reason": "cold", "diff": [], "invalidated": None}
        diff = min((key_diff(key, k) for k in pool), key=len)
        return {"reason": "key_mismatch", "diff": diff, "invalidated": None}

    # ---- metrics plumbing ----------------------------------------------------
    def bind_metrics(self, registry) -> None:
        """Publish this cache through a metrics registry (satellite of the
        telemetry plane): a collector samples :meth:`stats` at snapshot time,
        so the registry's ``teshu_plancache_*`` series *read* the same
        counters ``stats()`` reports — one source, no drift between the two
        surfaces.  ``registry`` is any object with ``register_collector``."""
        self._metrics = registry
        registry.register_collector(self._collect_metrics)

    def _collect_metrics(self):
        stats = self.stats()
        out = []
        for t, s in stats.get("tenants", {}).items():
            for k in _STATS_KEYS:
                out.append((f"teshu_plancache_{k}", {"tenant": t}, s[k]))
            out.append(("teshu_plancache_size", {"tenant": t}, s["size"]))
            out.append(("teshu_plancache_capacity", {"tenant": t},
                        s["capacity"]))
        return out

    # ---- introspection -------------------------------------------------------
    def stats(self, tenant: str | None = None) -> dict:
        """Pooled counters + total size, plus a ``tenants`` per-namespace
        breakdown; with ``tenant`` given, that namespace's counters alone."""
        with self._lock:
            if tenant is not None:
                ns = self._spaces.get(tenant)
                if ns is None:
                    return dict(dict.fromkeys(_STATS_KEYS, 0), size=0,
                                capacity=self.capacity)
                return dict(ns.stats, size=len(ns.plans), capacity=ns.capacity)
            pooled = dict.fromkeys(_STATS_KEYS, 0)
            size = 0
            per_tenant: dict[str, dict] = {}
            for t, ns in self._spaces.items():
                for k in pooled:
                    pooled[k] += ns.stats[k]
                size += len(ns.plans)
                per_tenant[t] = dict(ns.stats, size=len(ns.plans),
                                     capacity=ns.capacity)
            return dict(pooled, size=size, tenants=per_tenant)

    def has(self, key: tuple, tenant: str = DEFAULT_TENANT) -> bool:
        """Membership within one tenant's namespace (no LRU/stats effects).
        This is the lookup-predicate form; ``in`` aggregates across tenants."""
        with self._lock:
            ns = self._spaces.get(tenant)
            return ns is not None and key in ns.plans

    def __len__(self) -> int:
        """Total cached plans across ALL namespaces (introspection aggregate;
        use :meth:`stats` for the per-tenant breakdown)."""
        with self._lock:
            return sum(len(ns.plans) for ns in self._spaces.values())

    def __contains__(self, key: tuple) -> bool:
        """True if ANY tenant's namespace holds ``key`` — an introspection
        aggregate, not a lookup predicate: a hit here does not mean
        ``get(key, tenant)`` will succeed for a given tenant (use
        :meth:`has` for namespace-scoped membership)."""
        with self._lock:
            return any(key in ns.plans for ns in self._spaces.values())


# ---------------------------------------------------------------------------
# Executor lowerings
# ---------------------------------------------------------------------------

def attach_lowering(plan: CompiledPlan, lowering) -> None:
    """Freeze an executor lowering (e.g. the device-replay routing tables of
    :mod:`repro_torch.core.torchplan`) onto a cached plan.

    The lowering is derived purely from the plan, so it shares the plan's
    identity and lifetime: keyed by the same stats signature, evicted with
    the same LRU entry, discarded with the plan on drift recompiles.  Frozen
    dataclasses without ``slots`` still accept new attributes through
    ``object.__setattr__`` — the value is a cache annotation, not plan state,
    so the frozen contract (the key's immutability) is preserved.
    """
    object.__setattr__(plan, "_lowering", lowering)


def get_lowering(plan: CompiledPlan):
    """The lowering previously attached with :func:`attach_lowering`, or
    None when the plan has not been lowered yet."""
    return getattr(plan, "_lowering", None)
