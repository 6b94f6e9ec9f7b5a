"""Load signals for the autoscaler: a bounded window of cluster samples.

The cluster already produces every signal an autoscaler needs — the
:class:`~repro_torch.core.tenancy.AdmissionQueue` knows its depth, the
:class:`~repro_torch.core.primitives.CostLedger` carries per-tenant byte lanes, and
``run_pending()`` measures realized coflow completion times.  The
:class:`LoadMonitor` samples them into one bounded deque so policies read a
smoothed, self-contained view instead of poking live service internals.

All timestamps are *modelled* seconds (``CostLedger.modelled_time()``), the
same clock the journal and the scheduler use — scaling decisions replay
deterministically in tests and benchmarks.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque

DEFAULT_WINDOW = 64


@dataclasses.dataclass(frozen=True)
class LoadSample:
    """One observation of cluster load, taken at a ``run_pending`` boundary."""

    ts: float                              # modelled seconds
    queue_depth: int                       # admission-queue submissions waiting
    pending_coflows: int                   # distinct coflows not yet executed
    tenant_bytes: dict                     # tenant -> cumulative ledger bytes
    ccts: tuple = ()                       # realized coflow completion times (s)


class LoadMonitor:
    """Bounded window of :class:`LoadSample`; the policy's only input.

    Thread-safe (``record`` runs under the service's run-pending lock, but
    operators may read concurrently).
    """

    def __init__(self, window: int = DEFAULT_WINDOW):
        if window < 2:
            raise ValueError(f"window must be >= 2: {window}")
        self._samples: deque[LoadSample] = deque(maxlen=window)
        self._lock = threading.Lock()

    def record(self, *, ts: float, queue_depth: int, pending_coflows: int,
               tenant_bytes: dict | None = None,
               ccts: tuple = ()) -> LoadSample:
        s = LoadSample(ts=float(ts), queue_depth=int(queue_depth),
                       pending_coflows=int(pending_coflows),
                       tenant_bytes=dict(tenant_bytes or {}),
                       ccts=tuple(ccts))
        with self._lock:
            self._samples.append(s)
        return s

    # ---- derived views ------------------------------------------------------
    def latest(self) -> LoadSample | None:
        with self._lock:
            return self._samples[-1] if self._samples else None

    def samples(self) -> list[LoadSample]:
        with self._lock:
            return list(self._samples)

    def mean_cct(self) -> float:
        """Mean realized coflow completion time over the window (0 when no
        coflow has finished yet)."""
        with self._lock:
            ccts = [c for s in self._samples for c in s.ccts]
        return sum(ccts) / len(ccts) if ccts else 0.0

    def backlog_seconds(self) -> float:
        """Estimated modelled seconds of queued work: pending coflows times
        the mean realized CCT.  Zero until at least one CCT is observed —
        a cold cluster has no basis for a time estimate, so threshold
        policies fall back to the coflow-count signal."""
        latest = self.latest()
        if latest is None:
            return 0.0
        return latest.pending_coflows * self.mean_cct()

    def byte_rates(self) -> dict:
        """Per-tenant ledger byte rate (bytes / modelled second) between the
        oldest and newest window samples; empty until two samples exist."""
        with self._lock:
            if len(self._samples) < 2:
                return {}
            first, last = self._samples[0], self._samples[-1]
        dt = last.ts - first.ts
        if dt <= 0:
            return {}
        out = {}
        for t, b in last.tenant_bytes.items():
            out[t] = (b - first.tenant_bytes.get(t, 0)) / dt
        return out
