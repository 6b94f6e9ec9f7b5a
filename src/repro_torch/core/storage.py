"""Durable shuffle storage: a write-behind spill store for PART outputs.

Shuffle data in TeShu historically lived only in worker mailboxes and the
publish boards of :class:`repro_torch.core.primitives.LocalCluster` — it died with
its executor.  That coupling forces recovery to re-execute every surviving
sender and forces streaming sessions to fold early once ``max_inflight``
fills.  Exoshuffle and FuxiShuffle both decouple shuffle-block lifetime from
executor lifetime; this module is TeShu's version of that split.

:class:`ShuffleStore` keeps serialized :class:`~repro_torch.core.messages.Msgs`
blocks keyed ``(tenant, shuffle_id, stage, src, dst, chunk)`` in a pluggable
backend (:class:`MemoryBackend` or :class:`LocalDirBackend`).  Writes land in
an in-memory *staging* area and are flushed to the backend by a background
write-behind thread; ``flush()`` is the synchronous barrier executors call
before taking their after-snapshot so spill charges land deterministically.
Reads (``get_block``) serve from staging first, then the backend — the
publish boards become a cache over the store, not the source of truth.

The store is tenant-namespaced with optional per-tenant byte quotas; a put
that would exceed the quota is declined atomically (all-or-none per PART
output) with a machine-readable reason surfaced through ``explain()``.

Cost accounting: flushed bytes are charged to the bound cluster's
:class:`~repro_torch.core.primitives.CostLedger` ``spill_bytes`` lane and restores
to ``restore_bytes`` — separate lanes that never touch ``total_bytes`` or
modelled time, so byte-identity across executors is preserved by
construction.

The ``storage`` knob has three modes (resolved cluster → tenant → per-call
like every other knob):

* ``"off"``     — no store; the pre-storage data plane, unchanged.
* ``"spill"``   — streaming sessions may spill inflight chunks to the store
  instead of folding early; one-shot shuffles do not persist.
* ``"durable"`` — additionally, store-direct templates persist their global
  PART outputs so recovery can serve surviving senders' partitions from the
  store instead of re-executing them.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import struct
import threading
import urllib.parse

import numpy as np

from .messages import Msgs

STORAGE_MODES = ("off", "spill", "durable")

# Templates whose senders emit one global PART over the full destination set
# — the same set the vectorized executor can replay directly.  Hierarchical
# folding templates (bruck, two_level) interleave combine state into their
# exchanges, so their intermediate PARTs are not per-(src, dst) final
# partitions and cannot be served from the store.
STORE_DIRECT = frozenset({"vanilla_push", "vanilla_pull", "coordinated",
                          "network_aware"})

_HEADER = struct.Struct("<qq")  # (n, width) — int64 keys + float64 vals follow


def serialize_msgs(msgs: Msgs) -> bytes:
    """Exact wire form: ``<qq`` header + raw int64 keys + raw float64 vals.

    Round-trips bit-for-bit (no text encoding, no float formatting), which is
    what lets a restored block fold byte-identically to the original.
    """
    keys = np.ascontiguousarray(msgs.keys, dtype=np.int64)
    vals = np.ascontiguousarray(msgs.vals, dtype=np.float64)
    return _HEADER.pack(msgs.n, msgs.width) + keys.tobytes() + vals.tobytes()


def deserialize_msgs(blob: bytes) -> Msgs:
    n, width = _HEADER.unpack_from(blob, 0)
    off = _HEADER.size
    keys = np.frombuffer(blob, dtype=np.int64, count=n, offset=off).copy()
    off += 8 * n
    vals = np.frombuffer(blob, dtype=np.float64, count=n * width,
                         offset=off).copy().reshape(n, width)
    return Msgs(keys, vals)


@dataclasses.dataclass(frozen=True)
class BlockKey:
    """One persisted PART output (or one spilled stream chunk slice)."""

    tenant: str
    shuffle_id: int
    stage: str
    src: int
    dst: int
    chunk: int | None = None


class MemoryBackend:
    """Blocks in a process-local dict — the default backend."""

    def __init__(self) -> None:
        self._blocks: dict[BlockKey, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: BlockKey, blob: bytes) -> None:
        with self._lock:
            self._blocks[key] = blob

    def get(self, key: BlockKey) -> bytes | None:
        with self._lock:
            return self._blocks.get(key)

    def delete_shuffle(self, tenant: str, shuffle_id: int) -> None:
        with self._lock:
            dead = [k for k in self._blocks
                    if k.tenant == tenant and k.shuffle_id == shuffle_id]
            for k in dead:
                del self._blocks[k]

    def close(self) -> None:
        with self._lock:
            self._blocks.clear()


class LocalDirBackend:
    """One file per block under ``root/<tenant>/<shuffle_id>/``.

    Tenant ids are percent-encoded into a single path component, so namespace
    isolation survives tenants named ``../other`` or ``a/b``.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _dir(self, tenant: str, shuffle_id: int) -> str:
        return os.path.join(self.root,
                            urllib.parse.quote(tenant, safe=""),
                            str(shuffle_id))

    def _path(self, key: BlockKey) -> str:
        chunk = "x" if key.chunk is None else str(key.chunk)
        return os.path.join(self._dir(key.tenant, key.shuffle_id),
                            f"{key.stage}_{key.src}_{key.dst}_{chunk}.blk")

    def put(self, key: BlockKey, blob: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, path)

    def get(self, key: BlockKey) -> bytes | None:
        try:
            with open(self._path(key), "rb") as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    def delete_shuffle(self, tenant: str, shuffle_id: int) -> None:
        shutil.rmtree(self._dir(tenant, shuffle_id), ignore_errors=True)

    def close(self) -> None:
        pass


def _shuffle_stats() -> dict:
    return {"staged_blocks": 0, "flushed_blocks": 0, "flushed_bytes": 0,
            "restored_blocks": 0, "restored_bytes": 0,
            "declines": 0, "decline_reason": None}


class ShuffleStore:
    """Tenant-namespaced, quota-aware, write-behind block store.

    Puts stage blocks in memory and return immediately; a background flusher
    drains staging into the backend.  ``flush()`` is the synchronous barrier:
    spill bytes are charged to the bound cluster's ledger exactly once per
    flushed block version, at flush time, so any executor that flushes before
    its after-snapshot sees a deterministic spill delta regardless of what
    the background thread got to first.
    """

    def __init__(self, backend=None, *, write_behind: bool = True) -> None:
        self.backend = backend if backend is not None else MemoryBackend()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._staged: dict[BlockKey, bytes] = {}
        self._sizes: dict[BlockKey, int] = {}          # every live block
        self._index: dict[tuple, set[BlockKey]] = {}   # (tenant, sid) -> keys
        self._usage: dict[str, int] = {}
        self._quota: dict[str, int] = {}
        self._per_shuffle: dict[tuple, dict] = {}
        self._counters = {"puts": 0, "put_bytes": 0, "gets": 0,
                          "staged_blocks": 0, "staged_bytes": 0,
                          "flushed_blocks": 0, "flushed_bytes": 0,
                          "restored_blocks": 0, "restored_bytes": 0,
                          "declines": 0}
        self._cluster = None
        self._closed = False
        self._flusher = None
        # keys drained by the background flusher but not yet written+charged;
        # the synchronous flush() barrier waits these out so an executor's
        # after-snapshot never misses an in-flight spill charge
        self._writing: set[BlockKey] = set()
        if write_behind:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="teshu-store-flusher",
                daemon=True)
            self._flusher.start()

    # -- wiring -------------------------------------------------------------

    def bind(self, cluster) -> None:
        """Attach the cluster whose ledger spill/restore charges go to.

        The ledger object itself is read at charge time (``cluster.ledger``):
        ``reset_ledger`` replaces the ledger instance and a cached reference
        would silently charge a dead ledger.
        """
        self._cluster = cluster

    def set_quota(self, tenant: str, nbytes: int | None) -> None:
        with self._lock:
            if nbytes is None:
                self._quota.pop(tenant, None)
            else:
                self._quota[tenant] = int(nbytes)

    # -- charging / tracing (outside the store lock) ------------------------

    def _charge(self, nbytes: int, tenant: str, *, restore: bool) -> None:
        if self._cluster is not None:
            self._cluster.ledger.charge_spill(nbytes, tenant=tenant,
                                              restore=restore)

    def _point(self, name: str, **attrs) -> None:
        cl = self._cluster
        if cl is None:
            return
        tracer = getattr(getattr(cl, "obs", None), "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.point(name, shuffle_id=attrs.pop("shuffle_id", None),
                         **attrs)

    # -- write path ---------------------------------------------------------

    def put_parts(self, tenant: str, shuffle_id: int, stage: str, src: int,
                  parts: dict, *, chunk: int | None = None) -> bool:
        """Stage one PART output (a ``{dst: Msgs}`` dict) atomically.

        All-or-none under the tenant quota: either every destination's block
        is staged or the whole put is declined (reason ``quota_exceeded``).
        Returns ``True`` on success.
        """
        blobs = {d: serialize_msgs(m) for d, m in sorted(parts.items())}
        total = sum(len(b) for b in blobs.values())
        ns = (tenant, shuffle_id)
        with self._lock:
            if self._closed:
                return False
            stats = self._per_shuffle.setdefault(ns, _shuffle_stats())
            quota = self._quota.get(tenant)
            # overwrites replace the old version: quota-check the delta
            delta = total - sum(
                self._sizes.get(BlockKey(tenant, shuffle_id, stage, src, d,
                                         chunk), 0)
                for d in blobs)
            if quota is not None and self._usage.get(tenant, 0) + delta > quota:
                stats["declines"] += 1
                stats["decline_reason"] = "quota_exceeded"
                self._counters["declines"] += 1
                declined = True
            else:
                declined = False
                for d, blob in blobs.items():
                    key = BlockKey(tenant, shuffle_id, stage, src, d, chunk)
                    old = self._sizes.get(key, 0)
                    self._staged[key] = blob
                    self._sizes[key] = len(blob)
                    self._index.setdefault(ns, set()).add(key)
                    self._usage[tenant] = (self._usage.get(tenant, 0)
                                           + len(blob) - old)
                    self._counters["puts"] += 1
                    self._counters["put_bytes"] += len(blob)
                    self._counters["staged_blocks"] += 1
                    self._counters["staged_bytes"] += len(blob)
                    stats["staged_blocks"] += 1
                self._cv.notify_all()
        self._point("storage_put", shuffle_id=shuffle_id, tenant=tenant,
                    stage=stage, src=src, blocks=len(blobs), bytes=total,
                    declined=declined)
        return not declined

    # -- flush (write-behind drain + synchronous barrier) -------------------

    def _drain_locked(self, keys: list[BlockKey]) -> list[tuple[BlockKey, bytes]]:
        out = []
        for k in keys:
            blob = self._staged.pop(k, None)
            if blob is not None:
                out.append((k, blob))
        return out

    def _write_out(self, batch: list[tuple[BlockKey, bytes]]) -> None:
        per_shuffle: dict[tuple, tuple[int, int]] = {}
        for key, blob in batch:
            self.backend.put(key, blob)
            ns = (key.tenant, key.shuffle_id)
            b, n = per_shuffle.get(ns, (0, 0))
            per_shuffle[ns] = (b + len(blob), n + 1)
        with self._lock:
            for ns, (nbytes, nblocks) in per_shuffle.items():
                stats = self._per_shuffle.setdefault(ns, _shuffle_stats())
                stats["flushed_blocks"] += nblocks
                stats["flushed_bytes"] += nbytes
                self._counters["flushed_blocks"] += nblocks
                self._counters["flushed_bytes"] += nbytes
                self._counters["staged_blocks"] -= nblocks
                self._counters["staged_bytes"] -= nbytes
        for (tenant, _sid), (nbytes, _n) in per_shuffle.items():
            self._charge(nbytes, tenant, restore=False)

    def _flush_loop(self) -> None:
        while True:
            with self._lock:
                while not self._staged and not self._closed:
                    self._cv.wait()
                if self._closed and not self._staged:
                    return
                batch = self._drain_locked(list(self._staged))
                self._writing.update(k for k, _ in batch)
            try:
                if batch:
                    self._write_out(batch)
            finally:
                with self._lock:
                    self._writing.difference_update(k for k, _ in batch)
                    self._cv.notify_all()

    def flush(self, shuffle_id: int | None = None,
              tenant: str | None = None) -> int:
        """Synchronously drain matching staged blocks; returns blocks written.

        Executors call this before taking an after-snapshot so the spill lane
        in the ledger delta is deterministic.
        """
        def _match(k: BlockKey) -> bool:
            return ((shuffle_id is None or k.shuffle_id == shuffle_id)
                    and (tenant is None or k.tenant == tenant))

        with self._lock:
            batch = self._drain_locked([k for k in self._staged if _match(k)])
        if batch:
            self._write_out(batch)
        # barrier: wait out any matching batch the background flusher drained
        # but has not finished writing + charging yet
        with self._lock:
            while any(_match(k) for k in self._writing):
                self._cv.wait()
        return len(batch)

    def drain_workers(self, wids) -> tuple[int, int]:
        """Synchronously flush every staged block whose *source* is one of
        ``wids``; returns ``(blocks, bytes)`` written.

        The elastic scale-in handoff: a drained worker's staged PART outputs
        must reach the backend before the worker leaves the topology, so
        durable recovery can still serve them.  Blocks the background flusher
        already picked up are waited out — when this returns, nothing of the
        victims' data remains in volatile staging.
        """
        victims = set(wids)
        with self._lock:
            batch = self._drain_locked(
                [k for k in self._staged if k.src in victims])
        nbytes = sum(len(b) for _, b in batch)
        if batch:
            self._write_out(batch)
        with self._lock:
            while any(k.src in victims for k in self._writing):
                self._cv.wait()
        return len(batch), nbytes

    # -- read path ----------------------------------------------------------

    def get_block(self, tenant: str, shuffle_id: int, stage: str, src: int,
                  dst: int, *, chunk: int | None = None) -> Msgs | None:
        key = BlockKey(tenant, shuffle_id, stage, src, dst, chunk)
        with self._lock:
            blob = self._staged.get(key)
            # a key the background flusher drained but hasn't landed yet is
            # neither staged nor in the backend — wait the write out
            while blob is None and key in self._writing:
                self._cv.wait()
                blob = self._staged.get(key)
        if blob is None:
            blob = self.backend.get(key)
        if blob is None:
            return None
        msgs = deserialize_msgs(blob)
        with self._lock:
            self._counters["gets"] += 1
            self._counters["restored_blocks"] += 1
            self._counters["restored_bytes"] += len(blob)
            stats = self._per_shuffle.setdefault((tenant, shuffle_id),
                                                 _shuffle_stats())
            stats["restored_blocks"] += 1
            stats["restored_bytes"] += len(blob)
        self._charge(len(blob), tenant, restore=True)
        self._point("storage_get", shuffle_id=shuffle_id, tenant=tenant,
                    stage=stage, src=src, dst=dst, bytes=len(blob))
        return msgs

    def has_block(self, tenant: str, shuffle_id: int, stage: str, src: int,
                  dst: int, *, chunk: int | None = None) -> bool:
        return self.block_bytes(tenant, shuffle_id, stage, src, dst,
                                chunk=chunk) is not None

    def block_bytes(self, tenant: str, shuffle_id: int, stage: str, src: int,
                    dst: int, *, chunk: int | None = None) -> int | None:
        with self._lock:
            return self._sizes.get(
                BlockKey(tenant, shuffle_id, stage, src, dst, chunk))

    # -- lifecycle ----------------------------------------------------------

    def discard_staged(self, tenant: str, shuffle_id: int, src: int) -> int:
        """Drop a dead worker's not-yet-flushed blocks (its outputs died with
        it; only what reached the backend — or staging from a *surviving*
        worker — is trustworthy for serving)."""
        with self._lock:
            dead = [k for k in self._staged
                    if k.tenant == tenant and k.shuffle_id == shuffle_id
                    and k.src == src]
            for k in dead:
                blob = self._staged.pop(k)
                self._sizes.pop(k, None)
                self._index.get((tenant, shuffle_id), set()).discard(k)
                self._usage[tenant] = self._usage.get(tenant, 0) - len(blob)
                self._counters["staged_blocks"] -= 1
                self._counters["staged_bytes"] -= len(blob)
            return len(dead)

    def drop(self, tenant: str, shuffle_id: int) -> None:
        """Release a shuffle's namespace: staging, backend files, and quota."""
        ns = (tenant, shuffle_id)
        with self._lock:
            for k in self._index.pop(ns, set()):
                blob = self._staged.pop(k, None)
                if blob is not None:
                    self._counters["staged_blocks"] -= 1
                    self._counters["staged_bytes"] -= len(blob)
                size = self._sizes.pop(k, 0)
                self._usage[tenant] = self._usage.get(tenant, 0) - size
            self._per_shuffle.pop(ns, None)
        self.backend.delete_shuffle(tenant, shuffle_id)

    def shuffle_stats(self, tenant: str, shuffle_id: int) -> dict:
        with self._lock:
            return dict(self._per_shuffle.get((tenant, shuffle_id)) or {})

    def take_shuffle_stats(self, tenant: str, shuffle_id: int) -> dict:
        with self._lock:
            return dict(self._per_shuffle.pop((tenant, shuffle_id), None)
                        or {})

    def usage(self, tenant: str) -> int:
        with self._lock:
            return self._usage.get(tenant, 0)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["usage_per_tenant"] = {t: b for t, b in self._usage.items()
                                       if b > 0}
            return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cv.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            self._flusher = None
        self.backend.close()


@dataclasses.dataclass(frozen=True)
class StorageContext:
    """Everything the data plane needs to know about one shuffle's storage.

    ``persist`` is resolved at submit time: mode ``durable`` *and* a
    store-direct template.  ``min_stages`` guards hierarchical templates —
    a network-aware sender's *local*-stage PART can coincidentally target the
    full destination set (one group spanning every dst); persisting that
    pre-fold block under the global key would serve stale data.  The global
    PART is the only one issued after all local stages checkpointed, so
    ``stages_done >= min_stages`` identifies it exactly.
    """

    store: ShuffleStore
    mode: str
    tenant: str
    persist: bool = False
    min_stages: int = 0
    decline: str | None = None
