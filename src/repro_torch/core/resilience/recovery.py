"""Participant-scoped recovery (paper §6): restart the minimal subset.

The paper's robustness story is that a failure mid-shuffle restarts *only the
affected participants*, not the world.  The pieces here make that concrete on
both executors:

* :class:`CheckpointStore` — manager-side snapshots of each worker's combined
  intermediate at every completed hierarchy stage (written by
  ``WorkerContext.CKPT`` / the vectorized stage loop).  They live outside the
  worker processes, so a worker's death does not lose its completed work.
* :func:`consistent_resume_stages` — clamps raw per-worker checkpoints to
  *group-consistent* resume points: a stage's exchange is all-or-nothing per
  neighbor group (every member holds every other member's partition), so a
  worker may only resume past a stage if its whole group completed it.
* :class:`RecoveryCoordinator` — on a failed attempt, replays the manager's
  journal + checkpoint store into a :class:`RecoveryContext`: dead workers are
  restarted, every worker gets a resume stage, and the retry re-executes only
  the stages the failure actually invalidated.  The decision is journaled as a
  ``recovery`` record, and re-executed stages journal fresh ``stage`` records
  — which is how tests (and operators) audit that the restart set was minimal.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

from ..manager import ShuffleManager
from ..messages import Msgs
from ..primitives import LocalCluster
from ..tenancy import DEFAULT_TENANT
from ..topology import NetworkTopology

from .detector import FailureReport


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    stage_idx: int
    stage: str
    msgs: Msgs


@dataclasses.dataclass(frozen=True)
class StreamCheckpoint:
    """Chunk-granular fold state of a streamed exchange (one per (worker, tag)).

    ``peer_idx`` / ``folded`` form the cursor into the receiver's ordered
    source streams: streams before ``peer_idx`` are fully folded into ``acc``,
    and ``folded`` chunks of stream ``peer_idx`` are.  Because senders re-send
    identical streams on a retry (chunking is a pure function of their input)
    and the combiner folds sequentially, *any* prefix cursor resumes to the
    same final bytes — recovery restarts from the last completed chunk instead
    of the last stage.
    """

    peer_idx: int
    folded: int
    pre_bytes: int
    acc: Msgs | None


class CheckpointStore:
    """Thread-safe per-(shuffle, worker, stage) intermediate snapshots.

    Buffers are copied on the way in and out, so neither the running workers
    nor a recovery replay can alias the stored bytes.  State is scoped by
    shuffle id and dropped wholesale when the shuffle completes, so a
    long-lived service does not grow with shuffle count.

    Besides the per-stage checkpoints it also holds *stream* checkpoints —
    the :class:`StreamCheckpoint` fold cursors of chunk-pipelined exchanges,
    keyed ``(shuffle, worker, tag)`` where ``tag`` is the streamed stage
    (``"global"`` or a hierarchy level name).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # shuffle_id -> wid -> stage_idx -> Checkpoint
        self._data: dict[int, dict[int, dict[int, Checkpoint]]] = {}
        # shuffle_id -> (wid, tag) -> StreamCheckpoint
        self._streams: dict[int, dict[tuple[int, str], StreamCheckpoint]] = {}

    def save(self, shuffle_id: int, wid: int, stage_idx: int, stage: str,
             msgs: Msgs) -> None:
        ck = Checkpoint(stage_idx=stage_idx, stage=stage, msgs=msgs.copy())
        with self._lock:
            self._data.setdefault(shuffle_id, {}).setdefault(wid, {})[stage_idx] = ck

    def load(self, shuffle_id: int, wid: int, stage_idx: int) -> Msgs | None:
        with self._lock:
            ck = self._data.get(shuffle_id, {}).get(wid, {}).get(stage_idx)
            return None if ck is None else ck.msgs.copy()

    def last_stage(self, shuffle_id: int, wid: int) -> int:
        with self._lock:
            stages = self._data.get(shuffle_id, {}).get(wid)
            return max(stages) if stages else -1

    def stages(self, shuffle_id: int) -> dict[int, int]:
        """wid -> highest checkpointed stage index (raw, pre-clamp)."""
        with self._lock:
            return {w: max(s) for w, s in self._data.get(shuffle_id, {}).items()
                    if s}

    # ---- stream (chunk-granular) checkpoints ---------------------------------
    def save_stream(self, shuffle_id: int, wid: int, tag: str, peer_idx: int,
                    folded: int, pre_bytes: int, acc: Msgs | None) -> None:
        ck = StreamCheckpoint(peer_idx=peer_idx, folded=folded,
                              pre_bytes=pre_bytes,
                              acc=None if acc is None else acc.copy())
        with self._lock:
            self._streams.setdefault(shuffle_id, {})[(wid, tag)] = ck

    def load_stream(self, shuffle_id: int, wid: int,
                    tag: str) -> StreamCheckpoint | None:
        with self._lock:
            ck = self._streams.get(shuffle_id, {}).get((wid, tag))
        if ck is None:
            return None
        return dataclasses.replace(
            ck, acc=None if ck.acc is None else ck.acc.copy())

    def clear(self, shuffle_id: int) -> None:
        with self._lock:
            self._data.pop(shuffle_id, None)
            self._streams.pop(shuffle_id, None)

    def stats(self) -> dict:
        with self._lock:
            entries = sum(len(s) for ws in self._data.values()
                          for s in ws.values())
            nbytes = sum(ck.msgs.nbytes for ws in self._data.values()
                         for s in ws.values() for ck in s.values())
            stream_entries = sum(len(s) for s in self._streams.values())
            return {"shuffles": len(self._data), "checkpoints": entries,
                    "nbytes": nbytes, "stream_checkpoints": stream_entries}


def consistent_resume_stages(raw: dict[int, int], srcs,
                             topology: NetworkTopology) -> dict[int, int]:
    """Clamp raw checkpoint heights to group-consistent resume points.

    A worker resumes at stage *s* only if, for every level ``j <= s``, every
    member of its level-``j`` neighbor group checkpointed stage ``j`` — a
    stage exchange needs *all* group members' partitions, so a group where
    anyone fell short must re-execute from the last stage the whole group
    completed.  Workers with no valid resume stage are omitted (full re-run).
    """
    srcs = list(srcs)
    out: dict[int, int] = {}
    for w in srcs:
        rs = -1
        for j, lv in enumerate(topology.levels[:-1]):
            members = [m for m in srcs
                       if m // lv.group_size == w // lv.group_size]
            if min((raw.get(m, -1) for m in members), default=-1) >= j:
                rs = j
            else:
                break
        if rs >= 0:
            out[w] = rs
    return out


@dataclasses.dataclass
class RecoveryContext:
    """Everything one execution attempt needs to be fault-aware.

    Threaded through ``ShuffleArgs.recovery`` to ``WorkerContext`` (threaded
    executor) and ``run_shuffle_vectorized`` (batched executor).  ``attempt``
    0 is the ordinary first try — checkpoints are written but nothing resumes.
    """

    store: CheckpointStore
    attempt: int = 0
    resume_stages: dict[int, int] = dataclasses.field(default_factory=dict)
    speculated: frozenset = frozenset()
    record_stage: Callable[[int, str], None] | None = None
    store_served: frozenset = frozenset()
    # ^ senders whose global PART outputs survive in the shuffle store: the
    #   retry serves their partitions from the store (RECV/FETCH short-circuit)
    #   instead of re-executing them — they run nothing and journal nothing.


class RecoveryCoordinator:
    """Builds per-attempt :class:`RecoveryContext`\\ s and journals decisions."""

    def __init__(self, cluster: LocalCluster, manager: ShuffleManager,
                 store: CheckpointStore):
        self.cluster = cluster
        self.manager = manager
        self.store = store

    def _stage_recorder(self, shuffle_id: int, template_id: str,
                        attempt: int,
                        tenant: str = DEFAULT_TENANT) -> Callable[[int, str], None]:
        def record(wid: int, stage: str) -> None:
            self.manager.record_stage(wid, shuffle_id, template_id, stage,
                                      attempt=attempt, tenant=tenant)
        return record

    def initial_context(self, shuffle_id: int, template_id: str,
                        speculated: frozenset = frozenset(),
                        tenant: str = DEFAULT_TENANT) -> RecoveryContext:
        return RecoveryContext(
            store=self.store, attempt=0, speculated=speculated,
            record_stage=self._stage_recorder(shuffle_id, template_id, 0,
                                              tenant=tenant))

    def prepare_retry(self, shuffle_id: int, template_id: str, srcs,
                      topology: NetworkTopology, report: FailureReport,
                      attempt: int,
                      speculated: frozenset = frozenset(),
                      tenant: str = DEFAULT_TENANT,
                      storage=None, dsts=None,
                      hierarchical: bool = False) -> RecoveryContext:
        """Restart the dead, compute the minimal restart set, journal it.

        The restart set (workers that will re-execute at least one stage) is
        ``srcs - {fully resumed}``; everyone else replays checkpoints.  For a
        mid-stage death this is exactly the dead worker's neighbor group at
        the failed level — §6's "subset of participants".

        With durable ``storage`` (a :class:`repro_torch.core.storage.StorageContext`)
        and the shuffle's ``dsts``, the restart set shrinks further: a sender
        whose *entire* global PART output survives in the shuffle store is
        **served** — the retry reads its partitions from the store and the
        worker re-executes nothing at all.  Only workers whose un-persisted
        outputs died re-run.  A dead worker's staged (not-yet-flushed) blocks
        are discarded first: they died with the worker that wrote them.  For
        ``hierarchical`` templates a served sender must additionally be fully
        resumed (all local stages group-consistent): otherwise a re-executing
        group member would wait on it at a local exchange it will never run.
        """
        for w in report.dead:
            self.cluster.restart_worker(w)
        raw = self.store.stages(shuffle_id)
        resume = consistent_resume_stages(raw, srcs, topology)
        n_local = max(0, len(topology.levels) - 1)
        served: list[int] = []
        served_blocks = served_bytes = 0
        if storage is not None and dsts:
            store = storage.store
            for w in report.dead:
                store.discard_staged(storage.tenant, shuffle_id, w)
            store.flush(shuffle_id)
            for w in srcs:
                if hierarchical and resume.get(w, -1) < n_local - 1:
                    continue
                sizes = [store.block_bytes(storage.tenant, shuffle_id,
                                           "global", w, d) for d in dsts]
                if all(s is not None for s in sizes):
                    served.append(w)
                    served_blocks += len(sizes)
                    served_bytes += sum(sizes)
        restart = sorted(w for w in srcs
                         if w not in served
                         and resume.get(w, -1) < n_local - 1)
        info = {
            "restarted": sorted(report.dead),
            "restart_set": restart,
            "resume_stages": {str(w): s for w, s in sorted(resume.items())},
            "failure_kind": report.kind,
        }
        if storage is not None:
            info["store_served"] = sorted(served)
        self.manager.record_recovery(shuffle_id, info, attempt=attempt,
                                     tenant=tenant)
        if served:
            self.manager.record_restore(shuffle_id, {
                "served": sorted(served),
                "blocks": served_blocks,
                "bytes": served_bytes,
                "restart_set": restart,
            }, attempt=attempt, tenant=tenant)
        return RecoveryContext(
            store=self.store, attempt=attempt, resume_stages=resume,
            speculated=speculated,
            record_stage=self._stage_recorder(shuffle_id, template_id, attempt,
                                              tenant=tenant),
            store_served=frozenset(served))
