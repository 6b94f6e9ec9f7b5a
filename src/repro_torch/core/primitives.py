"""The six TeShu template primitives (Table 2) on a simulated worker cluster.

The paper's primitives — SEND, RECV, FETCH, PART, COMB, SAMP — are synchronous
per-worker operations.  Here they run against :class:`LocalCluster`, a deterministic
in-process cluster: each worker is a thread, mailboxes are FIFO queues per (src, dst)
pair, and every byte that crosses a topology boundary is charged to a
:class:`CostLedger` at the level it crosses.  The ledger is the measurement substrate
for the paper's evaluation (communication saving is *exact*; execution time comes from
the topology cost model, which is how we reproduce Table 4 on a single-host container).

The device analogues of PART/COMB live in :mod:`repro_torch.kernels`; the
semantics here are the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Sequence

import numpy as np

from .messages import Combiner, Msgs, PartFn, partition
from .obs import Observability
from .sampling import partition_aware_sample, sample_with_fallback
from .skew import (DEFAULT_SKEW_THRESHOLD, LocalSkewStats, merge_skew_stats,
                   plan_rebalance)
from .tenancy import DEFAULT_TENANT
from .topology import NetworkTopology


# ---------------------------------------------------------------------------
# Cost ledger: exact byte accounting + topology-model time
# ---------------------------------------------------------------------------

class CostLedger:
    """Charges transfers/combines to (epoch, worker, level); computes modelled time.

    Epochs are synchronization intervals (advanced at every cluster-wide rendezvous);
    modelled execution time is the sum over epochs of the slowest worker's serialized
    cost in that epoch — the standard BSP bound and how shuffle completion is gated on
    the straggler (paper §1: "performance is often gated on tail completion time").

    Accounting is incremental: charges update per-level byte totals and the current
    epoch's per-worker cost as they arrive, and closed epochs fold into a running
    time sum at ``advance_epoch``.  ``snapshot()`` is therefore O(levels) no matter
    how many shuffles ran — it used to rescan the whole charge history, which made
    repeated shuffles (exactly what the plan cache optimizes) quadratic.

    **Streamed (chunk-pipelined) epochs.**  A chunk-tagged charge (``chunk=`` on
    the charge methods) lands in one of two per-worker *lanes* — transfer or
    combine — instead of the serialized epoch cost.  When the stream's
    end-of-stream rendezvous calls :meth:`end_stream`, the epoch closes under
    the two-stage pipeline bound instead of the BSP sum::

        t_w = max(X_w, C_w) + min(X_w, C_w) / nchunks_w

    — with ``nchunks`` chunks in flight the non-dominant lane is hidden behind
    the dominant one except for a single chunk's fill/drain ramp.  For one
    chunk this degenerates to ``X + C`` (exactly the barrier epoch); for many
    chunks it approaches ``max(X, C)``, which is how modelled time reflects
    senders transferring chunk *c+1* while receivers combine chunk *c*.
    """

    def __init__(self, topology: NetworkTopology):
        self.topology = topology
        self._lock = threading.Lock()
        self.epoch = 0
        self.sample_bytes = 0                                # SAMP overhead, for Fig. 6
        self._bws = np.array([lv.bw_bytes_per_s for lv in topology.levels])
        self._bytes_per_level = np.zeros(len(topology.levels), dtype=np.int64)
        self._total_bytes = 0
        # per-destination received data bytes (skew visibility: the receiver a
        # hash-partitioned hot key lands on is the shuffle's tail).  Sample
        # shipments are control-plane traffic and are never counted here.
        self._recv_bytes: dict[int, int] = {}
        # per-tenant lanes: every charge is tagged with the tenant whose
        # shuffle issued it, so a shared cluster can report (and the admission
        # layer can schedule on) each tenant's observed byte load and the
        # serialized seconds of transfer/combine work it charged.
        self._tenant_bytes: dict[str, int] = {}
        self._tenant_cost: dict[str, float] = {}
        # current (open) epoch: per-worker serialized cost + levels crossed
        self._cur_cost: dict[int, float] = collections.defaultdict(float)
        self._cur_levels: set[int] = set()
        # current (open) streamed epoch: per-worker transfer/combine lanes,
        # chunk depth, and the levels its transfers crossed
        self._stream_xfer: dict[int, float] = {}
        self._stream_comb: dict[int, float] = {}
        self._stream_nchunks: dict[int, int] = {}
        self._stream_levels: set[int] = set()
        self._closed_time = 0.0                              # folded epochs
        # durable-storage lanes: bytes flushed to / restored from the shuffle
        # store.  Deliberately separate from ``total_bytes`` and modelled
        # time — spilling is a lifetime decision, not a wire transfer, and
        # keeping the lanes apart is what preserves byte-identical stats
        # between storage modes.
        self._spill_bytes = 0
        self._restore_bytes = 0
        self._tenant_spill: dict[str, int] = {}

    def retarget(self, topology: NetworkTopology) -> None:
        """Swap the topology under the accounting (elastic grow/shrink).

        Accounting continuity requires the same hierarchy shape — same level
        count, same level names — so every per-level byte lane keeps its
        meaning; only the worker count (and, in principle, bandwidths) may
        change.  Open epochs keep their already-charged costs: a scale event
        lands at a quiescent point, between shuffles.
        """
        if (len(topology.levels) != len(self.topology.levels)
                or any(a.name != b.name for a, b in
                       zip(topology.levels, self.topology.levels))):
            raise ValueError("retarget requires a structurally identical "
                             "hierarchy (same level count and names)")
        with self._lock:
            self.topology = topology
            self._bws = np.array([lv.bw_bytes_per_s for lv in topology.levels])

    def _charge_lane(self, tenant: str | None, nbytes: int, cost: float) -> None:
        """Fold a charge into its tenant's lane (lock held by the caller)."""
        t = DEFAULT_TENANT if tenant is None else tenant
        self._tenant_bytes[t] = self._tenant_bytes.get(t, 0) + nbytes
        self._tenant_cost[t] = self._tenant_cost.get(t, 0.0) + cost

    def charge_transfer(self, wid: int, level: int, nbytes: int, *, sample: bool = False,
                        dst: int | None = None, chunk: int | None = None,
                        tenant: str | None = None) -> None:
        if level < 0 or nbytes == 0:
            return
        with self._lock:
            self._bytes_per_level[level] += nbytes
            self._total_bytes += nbytes
            cost = nbytes / self.topology.levels[level].bw_bytes_per_s
            self._charge_lane(tenant, nbytes, cost)
            if chunk is None:
                self._cur_cost[wid] += cost
                self._cur_levels.add(level)
            else:
                self._stream_xfer[wid] = self._stream_xfer.get(wid, 0.0) + cost
                self._stream_nchunks[wid] = max(self._stream_nchunks.get(wid, 0),
                                                chunk + 1)
                self._stream_levels.add(level)
            if sample:
                self.sample_bytes += nbytes
            elif dst is not None:
                self._recv_bytes[dst] = self._recv_bytes.get(dst, 0) + nbytes

    def charge_transfers(self, wid: int, levels: np.ndarray, nbytes: np.ndarray,
                         *, sample: bool = False, dsts: np.ndarray | None = None,
                         chunk: int | None = None,
                         tenant: str | None = None) -> None:
        """Batched charge for one worker: vectorized aggregation, one lock pass.

        The vectorized executor produces per-destination (level, bytes) arrays in
        one shot; folding them here instead of per-destination calls removes the
        per-message/per-peer Python round trips from the data plane's hot loop.
        """
        levels = np.asarray(levels)
        nbytes = np.asarray(nbytes)
        keep = (levels >= 0) & (nbytes > 0)
        if not np.any(keep):
            return
        if dsts is not None:
            dsts = np.asarray(dsts)[keep]
        levels, nbytes = levels[keep], nbytes[keep]
        per_level = np.bincount(levels, weights=nbytes,
                                minlength=len(self.topology.levels)).astype(np.int64)
        cost = float(np.sum(per_level / self._bws))
        total = int(per_level.sum())
        with self._lock:
            self._bytes_per_level += per_level
            self._total_bytes += total
            self._charge_lane(tenant, total, cost)
            if chunk is None:
                self._cur_cost[wid] += cost
                self._cur_levels.update(int(l) for l in np.nonzero(per_level)[0])
            else:
                self._stream_xfer[wid] = self._stream_xfer.get(wid, 0.0) + cost
                self._stream_nchunks[wid] = max(self._stream_nchunks.get(wid, 0),
                                                chunk + 1)
                self._stream_levels.update(int(l) for l in np.nonzero(per_level)[0])
            if sample:
                self.sample_bytes += total
            elif dsts is not None:
                for d, b in zip(dsts, nbytes):
                    self._recv_bytes[int(d)] = (self._recv_bytes.get(int(d), 0)
                                                + int(b))

    def charge_combine(self, wid: int, nbytes: int, *, chunk: int | None = None,
                       tenant: str | None = None) -> None:
        cost = nbytes / self.topology.levels[0].combine_bytes_per_s
        with self._lock:
            self._charge_lane(tenant, 0, cost)   # combine moves no wire bytes
            if chunk is None:
                self._cur_cost[wid] += cost
            else:
                self._stream_comb[wid] = self._stream_comb.get(wid, 0.0) + cost
                self._stream_nchunks[wid] = max(self._stream_nchunks.get(wid, 0),
                                                chunk + 1)

    def charge_spill(self, nbytes: int, *, tenant: str | None = None,
                     restore: bool = False) -> None:
        """Charge a storage flush (or, with ``restore=True``, a store read).

        Spill traffic never enters ``total_bytes``, per-level lanes, or the
        modelled-time epochs: those describe the shuffle's wire plan, which
        is identical whether or not its blocks were also persisted.
        """
        if nbytes == 0:
            return
        t = DEFAULT_TENANT if tenant is None else tenant
        with self._lock:
            if restore:
                self._restore_bytes += nbytes
            else:
                self._spill_bytes += nbytes
                self._tenant_spill[t] = self._tenant_spill.get(t, 0) + nbytes

    def recv_imbalance(self, dsts: Sequence[int]) -> float:
        """max/mean of received data bytes across ``dsts`` so far (1.0 when the
        ledger has seen no received bytes for them).  The skew-aware EFF/COST
        coupling reads this at instantiation time: a destination that has been
        running hot prices the BSP tail of the combine decision."""
        with self._lock:
            loads = [self._recv_bytes.get(int(d), 0) for d in dsts]
        if len(loads) < 2 or sum(loads) <= 0:
            return 1.0
        return float(max(loads) / (sum(loads) / len(loads)))

    def _open_epoch_time(self) -> float:
        if not self._cur_cost:
            return 0.0
        lat = max((self.topology.levels[l].latency_s for l in self._cur_levels),
                  default=0.0)
        return max(self._cur_cost.values()) + lat

    def _open_stream_time(self) -> float:
        if not self._stream_xfer and not self._stream_comb:
            return 0.0
        t = 0.0
        for w in set(self._stream_xfer) | set(self._stream_comb):
            x = self._stream_xfer.get(w, 0.0)
            c = self._stream_comb.get(w, 0.0)
            n = max(1, self._stream_nchunks.get(w, 1))
            t = max(t, max(x, c) + min(x, c) / n)
        lat = max((self.topology.levels[l].latency_s for l in self._stream_levels),
                  default=0.0)
        return t + lat

    def advance_epoch(self) -> None:
        with self._lock:
            self._closed_time += self._open_epoch_time()
            self._cur_cost.clear()
            self._cur_levels.clear()
            self.epoch += 1

    def end_stream(self) -> None:
        """Close the open streamed epoch under the pipeline bound (no-op when
        no chunk-tagged charge arrived, so a stream that fell back to barrier
        execution costs nothing extra)."""
        with self._lock:
            if not self._stream_xfer and not self._stream_comb:
                return
            self._closed_time += self._open_stream_time()
            self._stream_xfer.clear()
            self._stream_comb.clear()
            self._stream_nchunks.clear()
            self._stream_levels.clear()
            self.epoch += 1

    # ---- aggregation --------------------------------------------------------
    def bytes_at_level(self, level: int) -> int:
        with self._lock:
            return int(self._bytes_per_level[level])

    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    def modelled_time(self) -> float:
        with self._lock:
            return (self._closed_time + self._open_epoch_time()
                    + self._open_stream_time())

    def tenant_bytes(self) -> dict[str, int]:
        """Per-tenant data+sample bytes charged so far (the sampled load
        statistic the admission layer's fairness weights feed on)."""
        with self._lock:
            return dict(self._tenant_bytes)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "total_bytes": self._total_bytes,
                "bytes_per_level": {lv.name: int(self._bytes_per_level[i])
                                    for i, lv in enumerate(self.topology.levels)},
                "sample_bytes": self.sample_bytes,
                "recv_bytes_per_worker": dict(self._recv_bytes),
                "bytes_per_tenant": dict(self._tenant_bytes),
                "cost_per_tenant": dict(self._tenant_cost),
                "spill_bytes": self._spill_bytes,
                "restore_bytes": self._restore_bytes,
                "spill_bytes_per_tenant": dict(self._tenant_spill),
                "modelled_time_s": (self._closed_time + self._open_epoch_time()
                                    + self._open_stream_time()),
            }

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Difference of two snapshots — the per-shuffle stats block."""
        recv_before = before.get("recv_bytes_per_worker", {})
        tb_before = before.get("bytes_per_tenant", {})
        tc_before = before.get("cost_per_tenant", {})
        ts_before = before.get("spill_bytes_per_tenant", {})
        return {
            "spill_bytes": (after.get("spill_bytes", 0)
                            - before.get("spill_bytes", 0)),
            "restore_bytes": (after.get("restore_bytes", 0)
                              - before.get("restore_bytes", 0)),
            "spill_bytes_per_tenant": {
                t: b - ts_before.get(t, 0)
                for t, b in after.get("spill_bytes_per_tenant", {}).items()},
            "total_bytes": after["total_bytes"] - before["total_bytes"],
            "sample_bytes": after["sample_bytes"] - before["sample_bytes"],
            "modelled_time_s": after["modelled_time_s"] - before["modelled_time_s"],
            "bytes_per_level": {k: after["bytes_per_level"][k]
                                - before["bytes_per_level"][k]
                                for k in after["bytes_per_level"]},
            "recv_bytes_per_worker": {
                w: b - recv_before.get(w, 0)
                for w, b in after.get("recv_bytes_per_worker", {}).items()},
            "bytes_per_tenant": {
                t: b - tb_before.get(t, 0)
                for t, b in after.get("bytes_per_tenant", {}).items()},
            "cost_per_tenant": {
                t: c - tc_before.get(t, 0.0)
                for t, c in after.get("cost_per_tenant", {}).items()},
        }


# ---------------------------------------------------------------------------
# Rendezvous: the "sampling server" gather (Figure 4) and cluster barriers
# ---------------------------------------------------------------------------

class Rendezvous:
    """All participants contribute a value; one computation runs; all get the result.

    Reused sequentially (generation counter) — one use per adaptive level per shuffle.
    Waiters poll ``abort_event`` (set when any participant of the owning shuffle
    dies) so a failure surfaces in ~50ms instead of the full RPC timeout.
    """

    def __init__(self, nparticipants: int, abort_event: threading.Event | None = None):
        self.n = nparticipants
        self._cond = threading.Condition()
        self._gen = 0
        self._contrib: dict[int, object] = {}
        self._result: object = None
        self._abort = abort_event

    def gather_compute(self, wid: int, value, fn: Callable[[dict], object]):
        with self._cond:
            gen = self._gen
            self._contrib[wid] = value
            if len(self._contrib) == self.n:
                self._result = fn(dict(self._contrib))
                self._contrib.clear()
                self._gen += 1
                self._cond.notify_all()
                return self._result
            waited = 0.0
            while self._gen == gen:
                if not self._cond.wait(timeout=0.05):
                    waited += 0.05
                    if self._abort is not None and self._abort.is_set():
                        raise ShuffleAborted(
                            f"rendezvous abandoned at gen {gen}: a participant "
                            f"died (worker {wid} was waiting)")
                    if waited >= 120.0:
                        raise TimeoutError(f"rendezvous stuck at gen {gen} (worker {wid})")
            return self._result


# ---------------------------------------------------------------------------
# The simulated cluster
# ---------------------------------------------------------------------------

class DeadWorker(Exception):
    """Raised inside a worker thread when a fault is injected (failure testing)."""


class ShuffleAborted(TimeoutError):
    """A shuffle attempt cannot complete because a participant became unreachable.

    Subclasses ``TimeoutError`` deliberately: to a peer, a dead worker is
    indistinguishable from an RPC that never answers — callers that handled the
    old slow-timeout path keep working, they just hear about it in ~50ms.  The
    resilience layer (:mod:`repro_torch.core.resilience`) catches this specifically,
    attaches a :class:`~repro_torch.core.resilience.detector.FailureReport` as
    ``.report``, and drives plan repair / participant-scoped recovery.
    """

    def __init__(self, message: str, *, shuffle_id: int | None = None):
        super().__init__(message)
        self.shuffle_id = shuffle_id
        self.report = None          # FailureReport, attached by the detector


@dataclasses.dataclass(frozen=True)
class EndOfStream:
    """End-of-stream marker: a sender's (or publisher's) chunk stream is done.

    Carries the number of chunks the stream held so receivers (and recovery)
    can assert they saw a complete stream.  Control-plane: never charged."""

    nchunks: int


@dataclasses.dataclass(frozen=True)
class FaultInjection:
    """Kill worker ``wid`` after it completes ``after_stage`` stages (§6 testing).

    Stage indices follow the topology hierarchy: stage *i* is the exchange at
    ``topology.levels[i]`` for adaptive templates (checkpointed via
    ``WorkerContext.CKPT``); the global exchange is the final, uncheckpointed
    stage.  ``after_stage=-1`` kills the worker at its first primitive call;
    ``after_stage=k`` lets it finish stage ``k`` and die at the first primitive
    of the next stage — the same instant on the threaded and vectorized
    executors, so recovery tests can compare them byte for byte.  Static
    templates (vanilla/bruck/two-level) never complete a checkpointed stage, so
    only ``after_stage=-1`` fires for them (death before the global exchange).

    ``after_chunk`` (streaming runs) kills the worker *mid-stream* instead: it
    dies at the first primitive call after completing that many chunk units of
    the global exchange stream — sender units (one chunk partitioned and sent
    to every destination) count first, then receiver units (one chunk folded
    into the running accumulator), matching the order the per-worker programs
    run in.  When set, ``after_stage`` is ignored.
    """

    wid: int
    after_stage: int = -1
    after_chunk: int | None = None


@dataclasses.dataclass
class ShuffleArgs:
    """Per-invocation arguments (Table 1).

    ``plan`` carries a :class:`repro_torch.core.plancache.CompiledPlan` when the service
    found one for this (template, topology, stats-signature) key; templates consult
    it through ``WorkerContext.PLAN_STAGE`` to skip re-instantiation.
    """

    template_id: str
    shuffle_id: int
    srcs: tuple[int, ...]
    dsts: tuple[int, ...]
    part_fn: PartFn
    comb_fn: Combiner | None
    rate: float = 0.01            # $RATE
    seed: int = 0
    tenant: str = DEFAULT_TENANT  # owning tenant: journal + ledger-lane tag
    balance: str = "off"          # "off" | "auto": skew-aware instantiation
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD
    plan: "object | None" = None  # CompiledPlan (kept untyped: no core cycle)
    stream: "object | None" = None
    # ^ repro_torch.core.streaming.ChunkPlan when the service runs this shuffle as
    #   chunk-pipelined sub-epochs; None keeps the barrier execution model.
    recovery: "object | None" = None
    # ^ resilience.recovery.RecoveryContext when the service runs with
    #   resilience enabled (checkpoint store, resume map, attempt number,
    #   speculation set); None keeps every primitive on its zero-overhead path.
    storage: "object | None" = None
    # ^ storage.StorageContext when the storage knob is "spill" or "durable";
    #   None keeps the pre-storage data plane byte-for-byte.


class LocalCluster:
    """Deterministic in-process cluster of worker threads over a NetworkTopology."""

    def __init__(self, topology: NetworkTopology, *, rpc_timeout: float = 120.0,
                 run_timeout: float = 300.0):
        self.topology = topology
        self.rpc_timeout = rpc_timeout      # RECV/FETCH wait bound
        self.run_timeout = run_timeout      # whole-cluster run bound
        self.ledger = CostLedger(topology)
        # the telemetry plane: a metrics registry (always on) + a span tracer
        # (the shared no-op until the service's tracing knob enables it)
        self.obs = Observability()
        # NOT defaultdicts: two threads hitting a missing key concurrently would
        # each run the factory and use *different* objects (defaultdict.__missing__
        # does not re-check after the factory call, which can release the GIL), so
        # a SEND could land in an orphaned queue.  Plain dict + atomic setdefault.
        self._mail: dict[tuple[int, int], queue.Queue] = {}
        # pull-mode publish board, keyed (shuffle_id, src) so invocations don't alias
        self._published: dict[tuple[int, int], dict[int, Msgs]] = {}
        self._published_ev: dict[tuple[int, int], threading.Event] = {}
        # per-shuffle key indexes so end_shuffle tears down O(own keys) state
        # instead of scanning every live key on the board (a concurrent-tenant
        # service pays that scan once per shuffle, per tenant)
        self._pub_index: dict[int, set] = {}
        self._rv_index: dict[int, set] = {}
        self._rendezvous: dict[tuple, Rendezvous] = {}
        self._rv_lock = threading.Lock()
        self.failed_workers: set[int] = set()
        self.worker_delays: dict[int, float] = {}   # injected straggler delays (s)
        self.fault_injections: dict[int, FaultInjection] = {}  # mid-stage kills
        # per-shuffle failure signalling: an abort event (set the instant any
        # participant dies) and the set of workers that have exited abnormally,
        # so peers blocked on them fail fast instead of burning rpc_timeout.
        self._abort_ev: dict[int, threading.Event] = {}
        self._unreachable: dict[int, set[int]] = {}

    # ---- infrastructure ------------------------------------------------------
    def reset_ledger(self) -> None:
        self.ledger = CostLedger(self.topology)

    def set_topology(self, topology: NetworkTopology) -> None:
        """Grow or shrink the worker set in place (elastic scaling).

        Mailboxes and publish boards are keyed lazily by worker id, so new
        workers need no setup and removed workers leave no live state once
        their shuffles have quiesced; the ledger is retargeted (not reset) so
        byte lanes and modelled time accumulate across scale events.
        """
        self.topology = topology
        self.ledger.retarget(topology)

    def _mailbox(self, src: int, dst: int) -> queue.Queue:
        q = self._mail.get((src, dst))
        if q is None:                       # setdefault returns the winner on a race
            q = self._mail.setdefault((src, dst), queue.Queue())
        return q

    def _publish_event(self, key: tuple[int, int]) -> threading.Event:
        ev = self._published_ev.get(key)
        if ev is None:
            ev = self._published_ev.setdefault(key, threading.Event())
            self._pub_index.setdefault(key[0], set()).add(key)
        return ev

    def publish(self, key: tuple, value) -> None:
        """Post to the publish board (and index the key for teardown)."""
        self._published[key] = value
        self._pub_index.setdefault(key[0], set()).add(key)
        self._publish_event(key).set()

    # ---- failure signalling ---------------------------------------------------
    def abort_event(self, shuffle_id: int) -> threading.Event:
        ev = self._abort_ev.get(shuffle_id)
        if ev is None:
            ev = self._abort_ev.setdefault(shuffle_id, threading.Event())
        return ev

    def mark_unreachable(self, shuffle_id: int, wid: int) -> None:
        """Record that ``wid`` exited this shuffle abnormally (died or aborted):
        peers blocked waiting on it should stop waiting."""
        s = self._unreachable.get(shuffle_id)
        if s is None:
            s = self._unreachable.setdefault(shuffle_id, set())
        s.add(wid)

    def unreachable(self, shuffle_id: int) -> set[int]:
        return self._unreachable.get(shuffle_id, set())

    # ---- fault injection (failure testing, §6) --------------------------------
    def inject_fault(self, wid: int, after_stage: int = -1,
                     after_chunk: int | None = None) -> None:
        """Arrange for ``wid`` to die mid-shuffle; see :class:`FaultInjection`."""
        self.fault_injections[wid] = FaultInjection(
            wid=wid, after_stage=after_stage, after_chunk=after_chunk)

    def clear_fault(self, wid: int) -> None:
        self.fault_injections.pop(wid, None)

    def restart_worker(self, wid: int) -> None:
        """Simulate the scheduler restarting a dead worker's process: it rejoins
        healthy (its pending fault injection died with the old process)."""
        self.failed_workers.discard(wid)
        self.fault_injections.pop(wid, None)

    def rendezvous(self, key: tuple, nparticipants: int) -> Rendezvous:
        with self._rv_lock:
            rv = self._rendezvous.get(key)
            if rv is None:
                # key[0] is the owning shuffle id for all rendezvous uses
                rv = self._rendezvous[key] = Rendezvous(
                    nparticipants, abort_event=self.abort_event(key[0]))
                self._rv_index.setdefault(key[0], set()).add(key)
            return rv

    def end_shuffle(self, shuffle_id: int, *, aborted: bool = False,
                    participants: Sequence[int] | None = None) -> None:
        """Free per-invocation control state (rendezvous, publish boards).

        All such state is keyed ``(shuffle_id, ...)``; without this, a long-lived
        service running one shuffle per superstep/step — exactly the regime the
        plan cache targets — grows memory linearly with shuffle count.

        ``aborted=True`` (failure/timeout path) additionally discards mailboxes:
        they are keyed ``(src, dst)`` with no shuffle id, so undelivered
        messages from the aborted run would otherwise be RECV'd by a retry and
        silently corrupt its output.  When the aborted shuffle's
        ``participants`` are known, only the queues *between* them are dropped
        (its messages can live nowhere else) — a concurrent shuffle on a
        disjoint worker set (another tenant's, in the multi-tenant service)
        keeps its in-flight queues untouched.  Without a participant set the
        cleanup falls back to orphaning every queue.
        """
        with self._rv_lock:
            for k in self._rv_index.pop(shuffle_id, ()):
                self._rendezvous.pop(k, None)
        for k in self._pub_index.pop(shuffle_id, ()):
            self._published.pop(k, None)
            self._published_ev.pop(k, None)
        self._abort_ev.pop(shuffle_id, None)
        self._unreachable.pop(shuffle_id, None)
        if aborted:
            if participants is None:
                self._mail = {}   # orphan old queues; lingerers can't pollute
            else:
                ps = set(participants)
                # in-place removal: concurrent shuffles keep inserting into
                # (and draining) this dict, so never swap the object out
                for k in [k for k in list(self._mail)
                          if k[0] in ps and k[1] in ps]:
                    self._mail.pop(k, None)

    def run_workers(self, wids: Sequence[int], fn: Callable[[int], object],
                    timeout: float | None = None,
                    abort_event: threading.Event | None = None) -> dict[int, object]:
        """Run ``fn(wid)`` on a thread per worker; propagate the first exception.

        A worker that dies (:class:`DeadWorker`) stops silently, but sets
        ``abort_event`` so peers blocked on it (RECV/FETCH/rendezvous) fail in
        ~50ms rather than the full RPC timeout.  When any worker raised
        :class:`ShuffleAborted` it is preferred over other errors — it carries
        the failure context the resilience layer diagnoses from.
        """
        results: dict[int, object] = {}
        errors: list[BaseException] = []

        def body(w: int) -> None:
            try:
                if w in self.failed_workers:
                    raise DeadWorker(f"worker {w} is failed")
                results[w] = fn(w)
            except DeadWorker:
                if abort_event is not None:   # simulated crash: silently stops,
                    abort_event.set()         # but peers must stop waiting on it
            except BaseException as e:    # noqa: BLE001 - rethrown below
                errors.append(e)

        timeout = self.run_timeout if timeout is None else timeout
        threads = [threading.Thread(target=body, args=(w,), daemon=True) for w in wids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        if any(t.is_alive() for t in threads):
            raise TimeoutError("cluster run timed out (deadlock or straggler)")
        if errors:
            raise next((e for e in errors if isinstance(e, ShuffleAborted)),
                       errors[0])
        return results


class WorkerContext:
    """Per-worker view of the cluster inside one shuffle: the six primitives.

    This is the object a template's code runs against; its method names follow
    Table 2 of the paper.
    """

    def __init__(self, cluster: LocalCluster, wid: int, args: ShuffleArgs):
        self.cluster = cluster
        self.topology = cluster.topology
        self.wid = wid
        self.args = args
        self.part_fn = args.part_fn  # effective partFunc; skew instantiation may
        #                              swap in a hot-key-scattering wrapper
        self.decisions: list = []    # (level, EffCost) pairs from adaptive templates
        self.observed: list = []     # (level, pre_bytes, post_bytes) per exchange
        self.stages_done = 0         # completed hierarchy stages (CKPT/RESUME)
        self.chunks_done = 0         # completed global-stream chunk units

    @property
    def chunk_plan(self):
        """The shuffle's ChunkPlan (None on barrier runs)."""
        return self.args.stream

    # ---- failure machinery ----------------------------------------------------
    def _die(self, reason: str) -> None:
        """This worker crashes now: flag it dead, wake everyone waiting on it."""
        self.cluster.failed_workers.add(self.wid)
        self.cluster.abort_event(self.args.shuffle_id).set()
        raise DeadWorker(f"worker {self.wid} {reason}")

    def _check_fault(self) -> None:
        """Entry gate of every primitive: crash if failed or a fault matured.

        An injected fault fires at the first primitive call after the worker has
        completed ``after_stage`` stages — i.e. mid-shuffle, at a point that is
        identical on the threaded and vectorized executors.
        """
        if self.wid in self.cluster.failed_workers:
            self._die("is failed")
        fi = self.cluster.fault_injections.get(self.wid)
        if fi is None:
            return
        if fi.after_chunk is not None:
            if self.chunks_done > fi.after_chunk:
                self._die("killed by fault injection "
                          f"(after chunk {fi.after_chunk})")
        elif self.stages_done > fi.after_stage:
            self._die(f"killed by fault injection (after stage {fi.after_stage})")

    def _peer_unreachable(self, peer: int) -> bool:
        return (peer in self.cluster.failed_workers
                or peer in self.cluster.unreachable(self.args.shuffle_id))

    def _abort(self, message: str) -> None:
        raise ShuffleAborted(message, shuffle_id=self.args.shuffle_id)

    def _served_block(self, src: int) -> Msgs | None:
        """On a retry where ``src`` is store-served, its global partition for
        this worker comes from the shuffle store — ``src`` is not running."""
        rc = self.args.recovery
        st = self.args.storage
        if (rc is None or st is None
                or src not in getattr(rc, "store_served", ())):
            return None
        return st.store.get_block(st.tenant, self.args.shuffle_id, "global",
                                  src, self.wid)

    # ---- Table-2 primitives ---------------------------------------------------
    def SEND(self, dst: int, msgs: Msgs, *, sample: bool = False,
             chunk: int | None = None) -> None:
        """Push ``msgs`` to ``dst``.  ``chunk`` tags a streamed sub-epoch chunk:
        the transfer is charged to the ledger's pipelined lanes instead of the
        serialized epoch cost."""
        self._check_fault()
        level = self.topology.crossing_level(self.wid, dst)
        self.cluster.ledger.charge_transfer(self.wid, level, msgs.nbytes,
                                            sample=sample, dst=dst, chunk=chunk,
                                            tenant=self.args.tenant)
        self.cluster._mailbox(self.wid, dst).put(msgs)

    def SEND_EOS(self, dst: int, nchunks: int) -> None:
        """Close this worker's chunk stream to ``dst`` (control-plane, free)."""
        self._check_fault()
        self.cluster._mailbox(self.wid, dst).put(EndOfStream(nchunks))

    def RECV(self, src: int, timeout: float | None = None) -> Msgs:
        """Blocking receive; fails fast (~50ms) once ``src`` is known dead.

        The unreachable check runs only while the queue is empty, so a message
        the sender got out before dying is still delivered — detection never
        races ahead of data that actually arrived.
        """
        self._check_fault()
        blk = self._served_block(src)
        if blk is not None:   # restore charged by the store; no wire transfer
            return blk
        timeout = self.cluster.rpc_timeout if timeout is None else timeout
        q = self.cluster._mailbox(src, self.wid)
        deadline = time.monotonic() + timeout
        while True:
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                if self._peer_unreachable(src):
                    self._abort(f"RECV({src} -> {self.wid}): sender unreachable")
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"RECV({src} -> {self.wid}) timed out")

    def RECV_CHUNK(self, src: int, timeout: float | None = None) -> "Msgs | EndOfStream":
        """Next item of ``src``'s chunk stream: a ``Msgs`` chunk or the
        :class:`EndOfStream` marker.  Same failure semantics as :meth:`RECV`
        (push mode: transfer bytes were charged by the sender)."""
        return self.RECV(src, timeout=timeout)

    def FETCH(self, src: int, timeout: float | None = None) -> Msgs:
        """Pull mode: wait until ``src`` PUBLISHed its partitions, take ours.

        Data bytes are charged to the fetching worker (it pays the wait)."""
        self._check_fault()
        blk = self._served_block(src)
        if blk is not None:   # restore charged by the store; no wire transfer
            return blk
        timeout = self.cluster.rpc_timeout if timeout is None else timeout
        key = (self.args.shuffle_id, src)
        ev = self.cluster._publish_event(key)
        deadline = time.monotonic() + timeout
        while not ev.wait(timeout=0.05):
            if self._peer_unreachable(src):
                self._abort(f"FETCH from {src}: publisher unreachable")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"FETCH from {src} timed out")
        msgs = self.cluster._published[key].get(self.wid, Msgs.empty())
        level = self.topology.crossing_level(src, self.wid)
        self.cluster.ledger.charge_transfer(self.wid, level, msgs.nbytes,
                                            dst=self.wid,
                                            tenant=self.args.tenant)
        return msgs

    def FETCH_CHUNK(self, src: int, chunk: int,
                    timeout: float | None = None) -> "Msgs | EndOfStream":
        """Pull-mode streaming: fetch chunk ``chunk`` of ``src``'s published
        stream, or :class:`EndOfStream` once the publisher closed the stream at
        or before that index.  Data bytes are charged to the fetching worker
        (it pays the wait), into the pipelined lanes."""
        self._check_fault()
        timeout = self.cluster.rpc_timeout if timeout is None else timeout
        sid = self.args.shuffle_id
        key = (sid, src, chunk)
        eos_key = (sid, src, "eos")
        ev = self.cluster._publish_event(key)
        eos_ev = self.cluster._publish_event(eos_key)
        deadline = time.monotonic() + timeout
        while True:
            if ev.wait(timeout=0.05):
                break
            if eos_ev.is_set():
                nchunks = self.cluster._published[eos_key]
                if chunk >= nchunks:
                    return EndOfStream(nchunks)
            if self._peer_unreachable(src):
                self._abort(f"FETCH_CHUNK from {src}: publisher unreachable")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"FETCH_CHUNK({src}, {chunk}) timed out")
        msgs = self.cluster._published[key].get(self.wid, Msgs.empty())
        level = self.topology.crossing_level(src, self.wid)
        self.cluster.ledger.charge_transfer(self.wid, level, msgs.nbytes,
                                            dst=self.wid, chunk=chunk,
                                            tenant=self.args.tenant)
        return msgs

    def PART(self, msgs: Msgs, dsts: Sequence[int], part_fn: PartFn | None = None,
             *, publish: bool = False, chunk: int | None = None) -> dict[int, Msgs]:
        self._check_fault()
        parts = partition(msgs, list(dsts), part_fn or self.part_fn)
        st = self.args.storage
        if (st is not None and st.persist and chunk is None
                and tuple(dsts) == self.args.dsts
                and self.stages_done >= st.min_stages):
            # durable mode: the global PART output outlives this worker.  The
            # publish board / mailboxes stay the fast path (a cache over the
            # store); the persisted copy is what recovery serves from.
            st.store.put_parts(st.tenant, self.args.shuffle_id, "global",
                               self.wid, parts)
        if publish:  # pull mode: make partitions visible to FETCHers
            key = ((self.args.shuffle_id, self.wid) if chunk is None
                   else (self.args.shuffle_id, self.wid, chunk))
            self.cluster.publish(key, parts)
        return parts

    def PUT_BLOCK(self, stage: str, parts: dict[int, Msgs], *,
                  chunk: int | None = None) -> bool:
        """Persist one PART output to the shuffle store (no-op without one).

        Returns ``False`` when there is no store for this shuffle or the
        tenant's quota declined the put."""
        self._check_fault()
        st = self.args.storage
        if st is None:
            return False
        return st.store.put_parts(st.tenant, self.args.shuffle_id, stage,
                                  self.wid, parts, chunk=chunk)

    def GET_BLOCK(self, stage: str, src: int, *,
                  chunk: int | None = None) -> Msgs | None:
        """Read this worker's slice of ``src``'s persisted PART output."""
        self._check_fault()
        st = self.args.storage
        if st is None:
            return None
        return st.store.get_block(st.tenant, self.args.shuffle_id, stage,
                                  src, self.wid, chunk=chunk)

    def PUBLISH_EOS(self, nchunks: int) -> None:
        """Close this worker's published chunk stream (pull-mode end-of-stream)."""
        self._check_fault()
        self.cluster.publish((self.args.shuffle_id, self.wid, "eos"), nchunks)

    def COMB(self, msgs: Msgs | Sequence[Msgs], comb_fn: Combiner | None = None) -> Msgs:
        self._check_fault()
        comb = comb_fn or self.args.comb_fn
        batch = Msgs.concat(list(msgs)) if not isinstance(msgs, Msgs) else msgs
        if comb is None:
            return batch
        self.cluster.ledger.charge_combine(self.wid, batch.nbytes,
                                           tenant=self.args.tenant)
        return comb(batch)

    def COMB_INC(self, acc: Msgs | None, msgs: Msgs, *,
                 chunk: int | None = None) -> Msgs:
        """Incrementally combine an arriving chunk into the running accumulator.

        Byte-identical to the one-shot barrier combine: the accumulator rows
        concat *ahead of* the chunk's rows, and the combiner's sequential
        left fold (see :class:`repro_torch.core.messages.Combiner`) continues
        exactly where the previous fold stopped.  Only the chunk's bytes are
        charged — summed over a stream this equals the single barrier combine
        charge, but it lands in the pipelined combine lane.
        """
        self._check_fault()
        comb = self.args.comb_fn
        batch = msgs if acc is None else Msgs.concat([acc, msgs])
        if comb is None:
            return batch
        self.cluster.ledger.charge_combine(self.wid, msgs.nbytes, chunk=chunk,
                                           tenant=self.args.tenant)
        return comb(batch)

    def SAMP(self, msgs: Msgs, rate: float | None = None,
             part_fn: PartFn | None = None, *, fallback: bool = False):
        """Partition-aware sample of this worker's buffer ($RATE).

        ``fallback=True`` returns the bounded-retry sample *list* of
        :func:`repro_torch.core.sampling.sample_with_fallback` instead of a single
        batch, so an empty primary group can be re-drawn pool-side.
        """
        self._check_fault()
        rate = self.args.rate if rate is None else rate
        seed = self.args.seed + self.args.shuffle_id
        if fallback:
            return sample_with_fallback(msgs, rate, part_fn or self.args.part_fn,
                                        seed=seed)
        return partition_aware_sample(msgs, rate, part_fn or self.args.part_fn,
                                      seed=seed)

    # ---- $-parameters (instantiated from topology) ------------------------------
    def FIND_NBRS(self, level_name: str, peers: Sequence[int]) -> list[int]:
        return self.topology.neighbors(self.wid, peers, level_name)

    # ---- checkpoint/resume (resilience.recovery) --------------------------------
    def _stage_participants(self, level_idx: int) -> int:
        """How many srcs will actually execute the stage at ``level_idx``.

        On a recovery attempt, workers resuming past a stage skip its barriers
        and sampling rendezvous entirely, so every collective for that stage
        must be sized to the restart subset — otherwise it would wait forever
        for participants that are replaying from checkpoints.
        """
        rc = self.args.recovery
        if rc is None:
            return len(self.args.srcs)
        resume = rc.resume_stages
        return sum(1 for w in self.args.srcs if resume.get(w, -1) < level_idx)

    def CKPT(self, level_name: str, bufs: Msgs) -> Msgs:
        """Mark the stage at ``level_name`` complete; persist the combined
        intermediate when resilience is on (no-op otherwise).  Returns ``bufs``
        so templates can write ``bufs = ctx.CKPT(level, bufs)``.

        The checkpoint lives manager-side (it survives this worker's death);
        recovery replays it so only the participants of the *failed* stage
        re-execute (§6's restart-a-subset).
        """
        idx = self.topology.level_index(level_name)
        self.stages_done = idx + 1
        rc = self.args.recovery
        if rc is not None:
            rc.store.save(self.args.shuffle_id, self.wid, idx, level_name, bufs)
            if rc.record_stage is not None:
                rc.record_stage(self.wid, level_name)
        return bufs

    def RESUME(self, level_name: str) -> Msgs | None:
        """Recovery fast-forward for the stage at ``level_name``.

        Returns ``None`` when the stage must execute (normal path and the
        failed/unreached stages of a recovery attempt).  On a recovery attempt,
        stages this worker already completed are skipped: the stage it resumes
        *at* returns the checkpointed intermediate, earlier ones return an
        empty placeholder (the real buffers are restored at the resume stage).
        """
        rc = self.args.recovery
        if rc is None:
            return None
        idx = self.topology.level_index(level_name)
        rs = rc.resume_stages.get(self.wid, -1)
        if idx > rs:
            return None
        ck = rc.store.load(self.args.shuffle_id, self.wid, idx) if idx == rs else None
        if idx == rs and ck is None:
            return None               # defensive: no checkpoint -> re-execute
        self.stages_done = idx + 1
        return Msgs.empty() if idx < rs else ck

    # ---- streaming: end-of-stream rendezvous + chunk-granular checkpoints ------
    def STREAM_EOS(self, tag: str, nparticipants: int) -> None:
        """The lightweight end-of-stream rendezvous that replaces the global
        barrier for a streamed exchange: once every participant finished
        sending and folding its chunks, the streamed epoch closes under the
        ledger's pipeline bound.  No data moves — it is a pure control-plane
        synchronization, keyed per stage so multi-stage templates can stream
        each exchange as its own sub-epoch."""
        self._check_fault()
        rv = self.cluster.rendezvous(
            (self.args.shuffle_id, "stream-eos", tag), nparticipants)
        rv.gather_compute(self.wid, None,
                          lambda _: self.cluster.ledger.end_stream())

    def CKPT_STREAM(self, tag: str, peer_idx: int, folded: int, pre_bytes: int,
                    acc: Msgs | None) -> None:
        """Checkpoint the running accumulator after a completed chunk fold
        (no-op without resilience).  Lives manager-side, so a retry resumes
        the fold from the last completed chunk instead of the last stage."""
        rc = self.args.recovery
        if rc is not None:
            rc.store.save_stream(self.args.shuffle_id, self.wid, tag,
                                 peer_idx, folded, pre_bytes, acc)

    def RESUME_STREAM(self, tag: str):
        """Chunk-granular recovery fast-forward for a streamed fold: returns
        the last :class:`~repro_torch.core.resilience.recovery.StreamCheckpoint`
        this worker saved for ``tag`` (or None).  The resumed cursor is
        journaled as a ``stage`` record so tests and operators can audit that
        recovery restarted mid-stream, not from scratch."""
        rc = self.args.recovery
        if rc is None or rc.attempt == 0:
            return None
        ck = rc.store.load_stream(self.args.shuffle_id, self.wid, tag)
        if ck is not None and rc.record_stage is not None:
            rc.record_stage(self.wid,
                            f"stream-resume:{tag}:{ck.peer_idx}:{ck.folded}")
        return ck

    # ---- compiled-plan fast path (plancache) ------------------------------------
    def PLAN_STAGE(self, level_name: str):
        """Cached (neighbors, EffCost) for this level, or (None, None) on miss.

        A hit replays the frozen instantiation: no FIND_NBRS scan, no SAMP pass
        over the keys, no sampling-server rendezvous.  For stages the plan deems
        beneficial a cluster-wide barrier still advances the cost-model epoch —
        the exchange is a synchronization point whether or not it was re-sampled —
        so cached and fresh runs keep comparable BSP accounting.
        """
        plan = self.args.plan
        if plan is None:
            return None, None
        ld = plan.level(level_name)
        if ld is None:
            return None, None
        nbrs = list(ld.nbrs.get(self.wid, (self.wid,)))
        if ld.beneficial:
            # Every src executing this stage joins the barrier (participation
            # must be uniform even for a worker alone in its group, or the
            # rendezvous would never fill); resumed workers are excluded.
            n = self._stage_participants(self.topology.level_index(level_name))
            rv = self.cluster.rendezvous(
                (self.args.shuffle_id, "plan-epoch", level_name), n)
            rv.gather_compute(self.wid, None,
                              lambda _: self.cluster.ledger.advance_epoch())
        return nbrs, ld.eff_cost

    def OBSERVE(self, level_name: str, pre_bytes: int, post_bytes: int) -> None:
        """Record a stage's actual data reduction (drift detection input)."""
        self.observed.append((level_name, pre_bytes, post_bytes))

    def local_level_names(self) -> list[str]:
        """Hierarchy levels below 'global'/'pod' where local shuffles can combine."""
        return [lv.name for lv in self.topology.levels[:-1]]

    # ---- sampling-server rendezvous ($COMPUTE_EFF_COST, Figure 4) --------------
    def GATHER_SAMPLES(self, tag: str, sample, full_bytes: int,
                       compute: Callable[[list, list[int]], object]):
        """Ship this worker's sample group to the sampling server (srcs[0]); one
        evaluation runs there; every worker receives the result.  Sample transfer
        bytes are charged (this is the overhead Figure 6 measures), and the epoch
        advances afterwards (a cluster-wide synchronization point).  ``sample``
        is one ``Msgs`` batch or a fallback list of them (``SAMP(fallback=True)``)."""
        self._check_fault()
        srcs = self.args.srcs
        server = srcs[0]
        level = self.topology.crossing_level(self.wid, server)
        nbytes = (sum(s.nbytes for s in sample) if isinstance(sample, list)
                  else sample.nbytes)
        self.cluster.ledger.charge_transfer(self.wid, level, nbytes, sample=True,
                                            tenant=self.args.tenant)
        tracer = self.cluster.obs.tracer
        if tracer.enabled:
            tracer.point("sampling", shuffle_id=self.args.shuffle_id,
                         tenant=self.args.tenant, wid=self.wid, tag=tag,
                         sample_bytes=nbytes)
        try:                     # stage-scoped when the tag names a level (the
            n = self._stage_participants(self.topology.level_index(tag))
        except KeyError:         # adaptive template's use); else every src
            n = len(srcs)
        rv = self.cluster.rendezvous((self.args.shuffle_id, tag), n)

        def fn(contrib: dict):
            samples = [contrib[w][0] for w in sorted(contrib)]
            sizes = [contrib[w][1] for w in sorted(contrib)]
            out = compute(samples, sizes)
            self.cluster.ledger.advance_epoch()
            return out

        return rv.gather_compute(self.wid, (sample, full_bytes), fn)

    # ---- skew rendezvous (heavy-hitter sketches, core/skew.py) -----------------
    def GATHER_SKEW(self, stats: LocalSkewStats):
        """Pool every participant's heavy-hitter sketch + load vector; one
        rebalance decision is computed and broadcast (the skew analogue of the
        Figure-4 sampling server).  Sketch shipment is charged as sampling
        overhead — it is control-plane bytes, O(capacity) per worker no matter
        how much data the sketch scanned.  Participation spans srcs *and*
        dsts: receivers need the decision for the owner-merge stage."""
        self._check_fault()
        participants = sorted(set(self.args.srcs) | set(self.args.dsts))
        server = participants[0]
        level = self.topology.crossing_level(self.wid, server)
        self.cluster.ledger.charge_transfer(self.wid, level, stats.nbytes,
                                            sample=True,
                                            tenant=self.args.tenant)
        tracer = self.cluster.obs.tracer
        if tracer.enabled:
            tracer.point("skew_sampling", shuffle_id=self.args.shuffle_id,
                         tenant=self.args.tenant, wid=self.wid,
                         sketch_bytes=stats.nbytes)
        rv = self.cluster.rendezvous((self.args.shuffle_id, "skew"),
                                     len(participants))

        def fn(contrib: dict):
            sketch, loads = merge_skew_stats([contrib[w] for w in sorted(contrib)])
            decision = plan_rebalance(sketch, loads, self.args.part_fn,
                                      len(self.args.dsts),
                                      threshold=self.args.skew_threshold)
            self.cluster.ledger.advance_epoch()
            return decision

        return rv.gather_compute(self.wid, stats, fn)
