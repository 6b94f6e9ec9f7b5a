"""The explainability surface: ``ShuffleReport`` and its builder.

``cluster.explain(shuffle_id)`` answers the operator questions an adaptive
shuffle service raises — *why did this shuffle fall back off its requested
engine, miss the plan cache, trigger a skew rebalance, or get its plan
drift-invalidated* — as one structured, machine-checkable report.

Three sources feed it, each durable at a different horizon:

* the service's per-shuffle **decision log** (always on, bounded like the
  owner-tag table): cache lookup outcome with the key-component diff from
  :meth:`repro_torch.core.plancache.PlanCache.explain_miss`, the fallback chain
  with each engine's decline reason, skew verdicts, and drift invalidations;
* the **journal** (via the :class:`~repro_torch.core.manager.ShuffleManager`):
  per-worker progress, failures, recovery and speculation records;
* the **flight recorder** (when tracing is enabled): the span timeline.

Reason codes are stable strings (``unsupported_combiner``,
``unsupported_part_fn``, ``streamed_replay``, ``key_mismatch``,
``invalidated_reduction_drift``, ...) — tests and dashboards match on them,
``why()`` renders them for humans.  Codes retired by the full-coverage device
lowering (``template_not_lowerable`` on built-in templates,
``skew_rebalance_triggered``) are never emitted anymore; dashboards matching
on them simply stop seeing samples.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ShuffleReport:
    """Everything the service can reconstruct about one shuffle's decisions."""

    shuffle_id: int
    tenant: str | None = None
    template: str | None = None
    execution: str | None = None
    requested_executor: str | None = None
    engine: str | None = None              # executor that produced the bytes
    fallback_reason: str | None = None     # requested engine's decline code
    fallbacks: list = dataclasses.field(default_factory=list)
    # ^ full decline chain: [{"engine": ..., "reason": ...}, ...]
    cache: dict | None = None              # outcome / reason / diff / closest
    skew: dict | None = None               # rebalance verdict of this run
    drift: dict | None = None              # invalidation this run triggered
    storage: dict | None = None            # store mode / spill + restore
    #                                        telemetry / decline reason
    elastic: dict | None = None            # topology epoch / size / burst ids
    #                                        when the run saw a scaled cluster
    status: str | None = None              # "ok" | "failed" | None (unknown)
    attempts: int = 0
    streamed: bool = False
    progress: dict = dataclasses.field(default_factory=dict)
    failures: list = dataclasses.field(default_factory=list)
    recovery: list = dataclasses.field(default_factory=list)
    spans: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def why(self) -> list[str]:
        """Human-readable rendering of the machine-checkable reason codes."""
        out = []
        if self.cache is not None:
            outcome = self.cache.get("outcome")
            if outcome == "miss":
                reason = self.cache.get("reason", "unknown")
                diff = self.cache.get("diff") or []
                msg = f"plan-cache miss ({reason})"
                if diff:
                    msg += ": diverged on " + ", ".join(diff)
                out.append(msg)
            elif outcome == "repaired":
                out.append("plan-cache miss repaired from a cached relative")
            elif outcome == "bypass":
                out.append("plan cache bypassed (execution='fresh')")
            else:
                out.append("plan-cache hit")
        for fb in self.fallbacks:
            out.append(f"fell back off {fb['engine']}: {fb['reason']}")
        if self.skew is not None and self.skew.get("triggered"):
            out.append(
                f"skew rebalance triggered: {self.skew.get('splits', 0)} hot "
                f"key(s) split (est. imbalance "
                f"{self.skew.get('est_imbalance', 0.0):.2f} > threshold "
                f"{self.skew.get('threshold', 0.0):.2f})")
        if self.drift is not None:
            out.append(f"plan drift-invalidated ({self.drift.get('kind')})")
        if self.storage is not None:
            st = self.storage
            if st.get("decline") == "template_not_persistable":
                out.append(
                    "store persistence declined: template produces no final "
                    "per-(src, dst) partitions (durable mode ran as spill)")
            if st.get("decline_reason") == "quota_exceeded":
                out.append(
                    f"store put(s) declined over the tenant storage quota "
                    f"({st.get('declines', 0)} decline(s))")
            if st.get("flushed_blocks"):
                out.append(
                    f"spilled {st['flushed_blocks']} block(s) / "
                    f"{st.get('flushed_bytes', 0)} bytes to the shuffle store")
            if st.get("restored_blocks"):
                out.append(
                    f"restored {st['restored_blocks']} block(s) / "
                    f"{st.get('restored_bytes', 0)} bytes from the shuffle "
                    "store")
        if self.elastic is not None:
            out.append(
                f"ran on an elastically scaled topology: epoch "
                f"{self.elastic.get('epoch')}, {self.elastic.get('workers')} "
                f"worker(s), burst {self.elastic.get('burst', [])}")
        if self.status == "failed":
            out.append("shuffle failed (see .failures)")
        elif self.attempts > 1:
            out.append(f"recovered after {self.attempts} attempts")
        if not out:
            out.append("no recorded decisions for this shuffle id")
        return out


def build_report(cluster, shuffle_id: int) -> ShuffleReport:
    """Assemble the report from the decision log + journal + flight recorder.

    ``cluster`` is a :class:`~repro_torch.core.service.TeShuCluster` (duck-typed:
    needs ``_report_for``, ``manager``, ``obs``, ``shuffle_owner``).
    """
    rep = ShuffleReport(shuffle_id=shuffle_id)
    noted = cluster._report_for(shuffle_id)
    if noted:
        for field in ("tenant", "template", "execution", "requested_executor",
                      "engine", "fallback_reason", "cache", "skew", "drift",
                      "storage", "elastic", "status"):
            if field in noted:
                setattr(rep, field, noted[field])
        rep.fallbacks = list(noted.get("fallbacks", ()))
        rep.attempts = int(noted.get("attempts", 0))
        rep.streamed = bool(noted.get("streamed", False))
    if rep.tenant is None:
        rep.tenant = cluster.shuffle_owner(shuffle_id)
    mgr = cluster.manager
    recs = mgr.records(shuffle_id)
    if recs and rep.template is None:
        rep.template = next((r.template_id for r in recs if r.template_id),
                            None)
    if recs and rep.tenant is None:
        rep.tenant = recs[0].tenant
    rep.progress = mgr.progress(shuffle_id)
    rep.failures = [{"attempt": r.attempt, "info": r.info}
                    for r in recs if r.kind == "failure"]
    rep.recovery = [{"attempt": r.attempt, "kind": r.kind, "info": r.info}
                    for r in recs
                    if r.kind in ("recovery", "speculation", "restore")]
    if rep.status is None and rep.failures and rep.attempts == 0:
        rep.status = "failed"
    rep.spans = cluster.obs.tracer.spans(shuffle_id)
    return rep
