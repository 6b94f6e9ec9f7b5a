"""The Shuffle Manager (paper §3.3): a central controller deployed as a service.

Responsibilities implemented here, mapping 1:1 to the paper's description:

* **store and serve templates** — operators ``install_template``; the first worker
  request per (worker, template) is a synchronous RPC (simulated), later invocations
  hit the worker-local cache and only fire an async record RPC.
* **records** — every shuffle start/end at every worker allocates a record with
  worker id, shuffle id, template id and timestamp.
* **progress / stragglers** — records give per-worker durations; workers slower than
  ``factor ×`` the median of completed peers (or started but unfinished long past it)
  are flagged, enabling re-execution of a subset of participants (§6).
* **fault tolerance** — records are journaled to an append-only JSONL log; the
  manager state can be rebuilt from the journal (``recover``), and the journal can be
  mirrored to replicas (``replicas=``), per the paper's replication note.
* **compiled plans** — the manager owns the :class:`repro_torch.core.plancache.PlanCache`:
  instantiated plans are control-plane state, stored and invalidated centrally just
  like templates and records (the service consults it on every ``shuffle()``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Iterable

from .plancache import PlanCache
from .tenancy import DEFAULT_TENANT
from .templates import TEMPLATES, ShuffleTemplate

# Journal schema version, written as a compact ``"v"`` field on every line.
# Version history: 0 (implicit) = the seed format and its additive extensions
# (stage/attempt/info/tenant, all defaulted on read); 1 = the first version
# that stamps itself; 2 = durable-storage record kinds ``spill`` (a shuffle's
# PART outputs were flushed to the shuffle store) and ``restore`` (a recovery
# served surviving senders' partitions from the store); 3 = elastic-topology
# record kinds ``scale_out`` / ``scale_in`` (the cluster grew / drained burst
# workers) and ``drain_handoff`` (a scale-in victim's staged store blocks
# were flushed before removal).  The reader is tolerant both ways: lines
# without ``v`` replay as version 0, and unknown fields from future versions
# are ignored, so v0/v1/v2 journals still recover.
JOURNAL_VERSION = 3


@dataclasses.dataclass
class ShuffleRecord:
    """One journal line.  ``wid`` is ``-1`` for manager-scope events (failure
    diagnosis, recovery orchestration, speculation) that no single worker owns.

    ``kind`` values: ``start``/``end`` (per-worker shuffle lifecycle, the
    paper's records), ``stage`` (a worker completed one hierarchy stage —
    recovery's restart-set evidence), ``failure`` (detector diagnosis),
    ``recovery`` (restart/resume decision for a retry attempt), ``speculation``
    (straggler work duplicated onto backups), ``spill`` (schema v2: blocks
    flushed to the durable shuffle store), ``restore`` (schema v2: a recovery
    served senders from the store), ``scale_out``/``scale_in``/
    ``drain_handoff`` (schema v3: elastic topology events; ``shuffle_id`` is
    ``-1`` — they are cluster-scope, not shuffle-scope).  Old journals (no
    ``stage`` /
    ``attempt`` / ``info`` / ``tenant`` fields) still replay: the new fields
    default — in particular, records written before the multi-tenant service
    existed belong to :data:`~repro_torch.core.tenancy.DEFAULT_TENANT`, which is
    exactly the tenant the single-application facade runs as.
    """

    wid: int
    shuffle_id: int
    template_id: str
    kind: str          # "start" | "end" | "stage" | "failure" | "recovery" | "speculation"
    ts: float
    stage: str | None = None
    attempt: int = 0
    info: dict | None = None
    tenant: str = DEFAULT_TENANT
    version: int = JOURNAL_VERSION   # journal schema version (the "v" field)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if self.stage is None:
            del d["stage"]          # keep start/end lines in the seed format
        if self.info is None:
            del d["info"]
        if self.attempt == 0:
            del d["attempt"]
        if self.tenant == DEFAULT_TENANT:
            del d["tenant"]         # single-tenant journals keep the seed format
        d["v"] = d.pop("version")
        return json.dumps(d)

    @staticmethod
    def from_json(line: str) -> "ShuffleRecord":
        """Tolerant reader: ``v`` defaults to 0 (pre-version journals), and
        fields this version does not know are dropped rather than rejected —
        a journal written by a newer schema still replays the records it
        shares with this one."""
        d = json.loads(line)
        version = d.pop("v", 0)
        known = {f.name for f in dataclasses.fields(ShuffleRecord)}
        rec = ShuffleRecord(**{k: v for k, v in d.items() if k in known})
        rec.version = version
        return rec


class ShuffleManager:
    """In-process stand-in for the manager service (RPCs become method calls)."""

    def __init__(self, journal_path: str | None = None,
                 replicas: Iterable[str] = (), clock=time.monotonic,
                 plan_cache: PlanCache | None = None):
        self._templates: dict[str, ShuffleTemplate] = dict(TEMPLATES)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self._records: list[ShuffleRecord] = []
        self._worker_cache: set[tuple[int, str]] = set()
        self._lock = threading.Lock()
        self._clock = clock
        self.rpc_count = {"sync": 0, "async": 0}
        self._journal_paths = [p for p in ([journal_path] if journal_path else [])] \
            + list(replicas)
        self._journals = []
        for p in self._journal_paths:
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            self._journals.append(open(p, "a", buffering=1))

    # ---- template store ----------------------------------------------------
    def install_template(self, template: ShuffleTemplate) -> None:
        with self._lock:
            self._templates[template.template_id] = template

    def get_template(self, template_id: str, wid: int | None) -> ShuffleTemplate:
        """Worker-side fetch.  First fetch per (worker, template) is a sync RPC;
        subsequent calls are served from the worker-local cache (async record only)."""
        with self._lock:
            if wid is not None and (wid, template_id) not in self._worker_cache:
                self.rpc_count["sync"] += 1
                self._worker_cache.add((wid, template_id))
            else:
                self.rpc_count["async"] += 1
            t = self._templates.get(template_id)
        if t is None:
            raise KeyError(f"template {template_id!r} not installed")
        return t

    @property
    def templates(self) -> dict[str, ShuffleTemplate]:
        return dict(self._templates)

    # ---- records & journal ---------------------------------------------------
    def _append(self, rec: ShuffleRecord) -> None:
        with self._lock:
            self._records.append(rec)
            for j in self._journals:
                j.write(rec.to_json() + "\n")

    def record_start(self, wid: int, shuffle_id: int, template_id: str,
                     attempt: int = 0, tenant: str = DEFAULT_TENANT) -> None:
        self._append(ShuffleRecord(wid, shuffle_id, template_id, "start",
                                   self._clock(), attempt=attempt, tenant=tenant))

    def record_end(self, wid: int, shuffle_id: int, template_id: str,
                   attempt: int = 0, tenant: str = DEFAULT_TENANT) -> None:
        self._append(ShuffleRecord(wid, shuffle_id, template_id, "end",
                                   self._clock(), attempt=attempt, tenant=tenant))

    # ---- resilience records (journal-driven recovery, §6) ----------------------
    def record_stage(self, wid: int, shuffle_id: int, template_id: str,
                     stage: str, attempt: int = 0,
                     tenant: str = DEFAULT_TENANT) -> None:
        """A worker finished one hierarchy stage (and checkpointed it).  On a
        recovery attempt these records are the proof of *which* participants
        re-executed — the §6 "restart a subset" contract is asserted on them."""
        self._append(ShuffleRecord(wid, shuffle_id, template_id, "stage",
                                   self._clock(), stage=stage, attempt=attempt,
                                   tenant=tenant))

    def record_failure(self, shuffle_id: int, info: dict, attempt: int = 0,
                       tenant: str = DEFAULT_TENANT) -> None:
        self._append(ShuffleRecord(-1, shuffle_id, "", "failure", self._clock(),
                                   attempt=attempt, info=info, tenant=tenant))

    def record_recovery(self, shuffle_id: int, info: dict, attempt: int = 0,
                        tenant: str = DEFAULT_TENANT) -> None:
        self._append(ShuffleRecord(-1, shuffle_id, "", "recovery", self._clock(),
                                   attempt=attempt, info=info, tenant=tenant))

    def record_spill(self, shuffle_id: int, info: dict, attempt: int = 0,
                     tenant: str = DEFAULT_TENANT) -> None:
        """Schema v2: a shuffle's PART outputs were flushed to the durable
        shuffle store (block/byte counts in ``info``)."""
        self._append(ShuffleRecord(-1, shuffle_id, "", "spill", self._clock(),
                                   attempt=attempt, info=info, tenant=tenant))

    def record_restore(self, shuffle_id: int, info: dict, attempt: int = 0,
                       tenant: str = DEFAULT_TENANT) -> None:
        """Schema v2: a recovery attempt served surviving senders' partitions
        from the shuffle store instead of re-executing them."""
        self._append(ShuffleRecord(-1, shuffle_id, "", "restore", self._clock(),
                                   attempt=attempt, info=info, tenant=tenant))

    def record_scale_out(self, info: dict,
                         tenant: str = DEFAULT_TENANT) -> None:
        """Schema v3: burst workers joined the topology (ids, new size,
        epoch, reason in ``info``).  Cluster-scope: ``shuffle_id`` is -1."""
        self._append(ShuffleRecord(-1, -1, "", "scale_out", self._clock(),
                                   info=info, tenant=tenant))

    def record_scale_in(self, info: dict,
                        tenant: str = DEFAULT_TENANT) -> None:
        """Schema v3: burst workers were drained out of the topology."""
        self._append(ShuffleRecord(-1, -1, "", "scale_in", self._clock(),
                                   info=info, tenant=tenant))

    def record_drain_handoff(self, info: dict,
                             tenant: str = DEFAULT_TENANT) -> None:
        """Schema v3: a scale-in victim's staged store blocks were flushed
        (worker ids, block/byte counts in ``info``) before removal — the
        journal evidence that graceful drain lost nothing."""
        self._append(ShuffleRecord(-1, -1, "", "drain_handoff", self._clock(),
                                   info=info, tenant=tenant))

    def record_speculation(self, shuffle_id: int, info: dict,
                           attempt: int = 0,
                           tenant: str = DEFAULT_TENANT) -> None:
        self._append(ShuffleRecord(-1, shuffle_id, "", "speculation",
                                   self._clock(), attempt=attempt, info=info,
                                   tenant=tenant))

    def records(self, shuffle_id: int | None = None,
                kind: str | None = None,
                tenant: str | None = None) -> list[ShuffleRecord]:
        with self._lock:
            return [r for r in self._records
                    if (shuffle_id is None or r.shuffle_id == shuffle_id)
                    and (kind is None or r.kind == kind)
                    and (tenant is None or r.tenant == tenant)]

    def tenants(self) -> list[str]:
        """Every tenant that appears in the journal (replayed or live)."""
        with self._lock:
            return sorted({r.tenant for r in self._records})

    def stage_records(self, shuffle_id: int,
                      attempt: int | None = None) -> list[ShuffleRecord]:
        return [r for r in self.records(shuffle_id, kind="stage")
                if attempt is None or r.attempt == attempt]

    def recovery_records(self, shuffle_id: int) -> list[ShuffleRecord]:
        return self.records(shuffle_id, kind="recovery")

    def failure_records(self, shuffle_id: int) -> list[ShuffleRecord]:
        return self.records(shuffle_id, kind="failure")

    # ---- progress / stragglers -------------------------------------------------
    def progress(self, shuffle_id: int) -> dict:
        recs = self.records(shuffle_id)
        started = {r.wid for r in recs if r.kind == "start"}
        ended = {r.wid for r in recs if r.kind == "end"}
        return {"started": sorted(started), "finished": sorted(ended),
                "pending": sorted(started - ended)}

    def durations(self, shuffle_id: int) -> dict[int, float]:
        recs = self.records(shuffle_id)
        t0 = {r.wid: r.ts for r in recs if r.kind == "start"}
        t1 = {r.wid: r.ts for r in recs if r.kind == "end"}
        return {w: t1[w] - t0[w] for w in t0 if w in t1}

    def stragglers(self, shuffle_id: int, factor: float = 3.0,
                   now: float | None = None) -> list[int]:
        """Workers whose duration (or elapsed time if unfinished) exceeds
        ``factor × median(finished durations)``."""
        durs = self.durations(shuffle_id)
        if not durs:
            return []
        med = sorted(durs.values())[len(durs) // 2]
        threshold = max(factor * med, 1e-9)
        out = [w for w, d in durs.items() if d > threshold]
        now = self._clock() if now is None else now
        prog = self.progress(shuffle_id)
        recs = self.records(shuffle_id)
        t0 = {r.wid: r.ts for r in recs if r.kind == "start"}
        out += [w for w in prog["pending"] if now - t0[w] > threshold]
        return sorted(set(out))

    def incomplete_shuffles(self) -> list[int]:
        """Shuffle ids with at least one started-but-unfinished worker — the restart
        set after a failure (§6: restart the tasks of a subset of participants)."""
        with self._lock:
            ids = {r.shuffle_id for r in self._records}
        return sorted(s for s in ids if self.progress(s)["pending"])

    # ---- recovery -------------------------------------------------------------
    @staticmethod
    def recover(journal_path: str, **kwargs) -> "ShuffleManager":
        """Rebuild manager state from a journal (or replica) after a crash."""
        mgr = ShuffleManager(**kwargs)
        if os.path.exists(journal_path):
            with open(journal_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        mgr._records.append(ShuffleRecord.from_json(line))
        return mgr

    def close(self) -> None:
        for j in self._journals:
            j.close()
