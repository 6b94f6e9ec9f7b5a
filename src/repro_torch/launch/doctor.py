"""The shuffle doctor: post-mortem a journal (or a live cluster's records).

    PYTHONPATH=src python -m repro_torch.launch.doctor runs/journal.jsonl
    PYTHONPATH=src python -m repro_torch.launch.doctor runs/journal.jsonl --shuffle 3
    PYTHONPATH=src python -m repro_torch.launch.doctor runs/journal.jsonl --tenant ml --json

Answers, from the append-only journal alone, the questions an operator asks
after the fact: which shuffles ran (per tenant), which failed and why the
detector said so, which recovered and what restarted, who straggled, and how
long each worker took.  The journal is version-tolerant
(:meth:`repro_torch.core.manager.ShuffleRecord.from_json`): pre-version lines
replay as schema v0, newer-schema lines have unknown fields dropped.

For *decision*-level questions on a live service — why a shuffle fell back
off its requested engine, missed the plan cache, or was drift-invalidated —
use ``cluster.explain(shuffle_id)`` (:mod:`repro_torch.core.obs`), which reads the
in-process decision log the journal does not carry.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.manager import ShuffleManager


def diagnose_shuffle(mgr: ShuffleManager, sid: int,
                     straggler_factor: float = 3.0) -> dict:
    """One shuffle's journal evidence, condensed to a verdict dict."""
    recs = mgr.records(sid)
    prog = mgr.progress(sid)
    durs = mgr.durations(sid)
    failures = [r for r in recs if r.kind == "failure"]
    recoveries = [r for r in recs if r.kind == "recovery"]
    speculations = [r for r in recs if r.kind == "speculation"]
    spills = [r for r in recs if r.kind == "spill"]
    restores = [r for r in recs if r.kind == "restore"]
    attempts = max((r.attempt for r in recs), default=0) + 1
    template = next((r.template_id for r in recs if r.template_id), None)
    tenant = next((r.tenant for r in recs), None)
    # straggler check on the final attempt's timings only makes sense when
    # everyone finished; with pending workers the elapsed-time arm applies
    now = max((r.ts for r in recs), default=0.0)
    stragglers = mgr.stragglers(sid, factor=straggler_factor, now=now)
    if failures and prog["pending"]:
        status = "failed"
    elif failures:
        status = "recovered"
    elif prog["pending"]:
        status = "incomplete"
    else:
        status = "ok"
    return {
        "shuffle_id": sid,
        "tenant": tenant,
        "template": template,
        "status": status,
        "attempts": attempts,
        "workers": {"started": len(prog["started"]),
                    "finished": len(prog["finished"]),
                    "pending": prog["pending"]},
        "durations": {str(w): round(d, 6) for w, d in sorted(durs.items())},
        "stragglers": stragglers,
        "failures": [r.info for r in failures if r.info],
        "recoveries": [r.info for r in recoveries if r.info],
        "speculations": [r.info for r in speculations if r.info],
        "spills": [r.info for r in spills if r.info],
        "restores": [r.info for r in restores if r.info],
        "journal_versions": sorted({r.version for r in recs}),
    }


_SCALE_KINDS = ("scale_out", "scale_in", "drain_handoff")


def diagnose_cluster(recs) -> dict | None:
    """The cluster-scope elastic timeline: scale events, drain handoffs, and
    each burst worker's lifetime (schema v3 records carry ``shuffle_id`` -1 —
    they belong to the cluster, not to any one shuffle).  None when the
    journal holds no scale records."""
    scale = sorted((r for r in recs if r.kind in _SCALE_KINDS),
                   key=lambda r: r.ts)
    if not scale:
        return None
    events, handoffs = [], []
    born: dict[int, float] = {}
    lifetimes: dict[int, float | None] = {}
    for r in scale:
        info = r.info or {}
        ts = info.get("ts", r.ts)       # modelled ts when the event carries it
        if r.kind == "drain_handoff":
            handoffs.append(dict(info))
            continue
        events.append(dict(info, kind=r.kind))
        for w in info.get("workers", []):
            if r.kind == "scale_out":
                born[w] = ts
                lifetimes[w] = None     # still alive unless a scale_in follows
            elif w in born:
                lifetimes[w] = round(ts - born.pop(w), 6)
    return {
        "shuffle_id": None,
        "kind": "cluster",
        "scale_events": events,
        "drain_handoffs": handoffs,
        "burst_worker_lifetimes": {str(w): s
                                   for w, s in sorted(lifetimes.items())},
    }


def diagnose(journal_path: str, *, shuffle_id: int | None = None,
             tenant: str | None = None,
             straggler_factor: float = 3.0) -> list[dict]:
    mgr = ShuffleManager.recover(journal_path)
    try:
        recs = mgr.records(tenant=tenant)
        # -1 is the cluster-scope pseudo-id (scale/drain records); it gets
        # its own timeline entry, never a per-shuffle verdict
        sids = sorted({r.shuffle_id for r in recs if r.shuffle_id >= 0})
        if shuffle_id is not None:
            sids = [s for s in sids if s == shuffle_id]
        out = [diagnose_shuffle(mgr, s, straggler_factor) for s in sids]
        if shuffle_id is None:
            cluster = diagnose_cluster(recs)
            if cluster is not None:
                out.append(cluster)
        return out
    finally:
        mgr.close()


def render(reports: list[dict]) -> str:
    if not reports:
        return "no matching shuffle records in the journal"
    out = []
    for r in reports:
        if r.get("kind") == "cluster":
            out.append("cluster elastic timeline:")
            for e in r["scale_events"]:
                out.append(
                    f"  {e['kind']} [{e.get('reason', '?')}] workers "
                    f"{e.get('workers', [])} -> size {e.get('size', '?')} "
                    f"(epoch {e.get('epoch', '?')}, t={e.get('ts', 0):.4f}s)")
            for h in r["drain_handoffs"]:
                out.append(
                    f"  drain handoff: workers {h.get('workers', [])} flushed "
                    f"{h.get('blocks', 0)} block(s) / {h.get('bytes', 0)} "
                    "bytes before removal")
            for w, s in r["burst_worker_lifetimes"].items():
                life = "still attached" if s is None else f"{s:.4f}s"
                out.append(f"  burst worker {w}: {life}")
            continue
        hdr = (f"shuffle {r['shuffle_id']} [{r['template'] or '?'}] "
               f"tenant={r['tenant'] or '?'}: {r['status'].upper()} "
               f"({r['attempts']} attempt(s))")
        out.append(hdr)
        w = r["workers"]
        out.append(f"  workers: {w['finished']}/{w['started']} finished"
                   + (f", pending {w['pending']}" if w["pending"] else ""))
        if r["durations"]:
            durs = r["durations"].values()
            out.append(f"  durations: min {min(durs):.4f}s "
                       f"max {max(durs):.4f}s over {len(durs)} workers")
        if r["stragglers"]:
            out.append(f"  stragglers: {r['stragglers']}")
        for f in r["failures"]:
            out.append(f"  failure: {f}")
        for rec in r["recoveries"]:
            out.append(f"  recovery: {rec}")
        for s in r["speculations"]:
            out.append(f"  speculation: {s}")
        for s in r["spills"]:
            out.append(f"  spill: {s['blocks']} block(s) / {s['bytes']} bytes "
                       "written behind to the shuffle store")
        for s in r["restores"]:
            served = s.get("served", [])
            restart = s.get("restart_set", [])
            out.append(
                f"  restore: {len(served)} sender(s) served from the store "
                f"({s.get('blocks', 0)} block(s) / {s.get('bytes', 0)} bytes)"
                f" vs {len(restart)} re-executed: served={served} "
                f"re-executed={restart}")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.doctor",
        description="Post-mortem a shuffle journal.")
    ap.add_argument("journal", help="path to the JSONL journal (or a replica)")
    ap.add_argument("--shuffle", type=int, default=None,
                    help="restrict to one shuffle id")
    ap.add_argument("--tenant", default=None,
                    help="restrict to one tenant's records")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of text")
    args = ap.parse_args(argv)
    reports = diagnose(args.journal, shuffle_id=args.shuffle,
                       tenant=args.tenant,
                       straggler_factor=args.straggler_factor)
    if args.json:
        print(json.dumps(reports, indent=2))
    else:
        print(render(reports))
    return 0 if reports else 1


if __name__ == "__main__":
    sys.exit(main())
