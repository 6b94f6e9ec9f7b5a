"""Vectorized template execution: replay a CompiledPlan as batched numpy.

The threaded :func:`repro_torch.core.templates.run_shuffle` is the *reference* executor:
one Python thread per worker, primitives exchanging through mailboxes.  That
fidelity matters for fresh instantiation (sampling rendezvous, stragglers,
failures), but once a plan is compiled the remaining work is pure data movement —
partition, transfer accounting, combine — and the thread-per-worker round trips
dominate wall time.

This module executes a cached plan single-threaded with batched numpy:

* partitions are computed with one stable argsort + ``np.split`` per buffer
  (:func:`repro_torch.core.messages.partition`), never a per-message Python loop;
* ledger charges are folded per worker with ``CostLedger.charge_transfers``
  (one vectorized bincount + one lock acquisition instead of one call per peer);
* combines remain the vectorized sort + ``ufunc.reduceat`` — or, opt-in via
  :func:`set_comb_backend`, the CUDA segment-combine kernel
  (:mod:`repro_torch.kernels.combine`) for SUM combiners.

Equivalence contract: for the supported templates the output buffers are
*byte-identical* to the threaded plan path (same partition functions, same concat
orders, same stable sorts) and the ledger sees the same charges in the same
epochs.  ``tests/test_plancache.py`` pins this.

Supported: vanilla_push, vanilla_pull, coordinated, network_aware.  Bruck and
two-level interleave SEND/RECV in log-step rounds whose ordering is inherently
sequential per worker; they fall back to the threaded executor (still skipping
re-instantiation via the plan).

Fault awareness: when the service runs with resilience enabled
(``args.recovery`` carries a RecoveryContext) this executor no longer declines
fault scenarios.  It checkpoints every worker's combined intermediate after
every stage, honors injected faults at exactly the stage boundary where the
threaded executor's worker would die (raising ``ShuffleAborted`` for the
recovery coordinator), and on a retry resumes each worker from its
group-consistent checkpoint — re-executing only the stages the failure
invalidated.  Wall-clock straggler delays remain a threaded-executor concern
(they are real sleeps), except when speculation neutralizes them.
"""
from __future__ import annotations

import numpy as np

from .messages import Combiner, Msgs, partition
from .primitives import LocalCluster, ShuffleAborted, ShuffleArgs
from .skew import owner_merge_plan, scatter_part_fn
from .templates import ShuffleResult, aggregate_observed

VECTORIZABLE = frozenset(
    {"vanilla_push", "vanilla_pull", "coordinated", "network_aware"})

_COMB_BACKEND = "numpy"
_COMB_DEVICE = "cuda"          # where the "cuda" backend runs its combines


def set_comb_backend(name: str, device: str = "cuda") -> str:
    """Select the combine backend: ``"numpy"`` (default) or ``"cuda"``.

    The CUDA path routes SUM combines through the port's segment-combine
    kernel on ``device`` (the card unless the caller asks for ``"cpu"``,
    where the kernel's plain version runs).  It accumulates in float32, so
    it is opt-in: the default backend keeps bit-exact float64 semantics.
    Returns the previous backend (so callers can restore it).
    """
    global _COMB_BACKEND, _COMB_DEVICE
    if name not in ("numpy", "cuda"):
        raise ValueError(f"unknown combine backend: {name!r}")
    prev, _COMB_BACKEND, _COMB_DEVICE = _COMB_BACKEND, name, device
    return prev


def _cuda_sum_combine(msgs: Msgs) -> Msgs:
    import torch

    from ..kernels.combine import segment_combine

    uniq, inv = np.unique(msgs.keys, return_inverse=True)
    out = segment_combine(
        torch.as_tensor(inv.reshape(-1), dtype=torch.int32, device=_COMB_DEVICE),
        torch.as_tensor(msgs.vals, dtype=torch.float32,
                        device=_COMB_DEVICE).contiguous(),
        num_segments=int(uniq.size))
    return Msgs(uniq, out.cpu().numpy().astype(np.float64))


def combine_msgs(combiner: Combiner, msgs: Msgs) -> Msgs:
    if _COMB_BACKEND == "cuda" and combiner.name == "sum" and msgs.n:
        return _cuda_sum_combine(msgs)
    return combiner(msgs)


def vectorize_decline(cluster: LocalCluster, args: ShuffleArgs) -> str | None:
    """Why batched execution is invalid for this invocation, or ``None`` when
    it can run.  Reason codes are machine-checkable and surface through
    ``ShuffleResult.fallback_reason`` / ``cluster.explain()``."""
    if args.plan is None:
        return "no_plan"
    if args.template_id not in VECTORIZABLE:
        return "template_not_vectorizable"
    if args.recovery is not None:
        pending_delays = set(cluster.worker_delays) - set(args.recovery.speculated)
        return "straggler_delays" if pending_delays else None
    if cluster.failed_workers:
        return "failed_workers"
    if cluster.worker_delays:
        return "straggler_delays"
    if cluster.fault_injections:
        return "fault_injections"
    return None


def can_vectorize(cluster: LocalCluster, args: ShuffleArgs) -> bool:
    """Batched execution is valid when a plan exists and the template is
    supported.  Without a RecoveryContext, any fault/straggler injection needs
    the thread-level simulation; with one, this executor handles dead workers
    and injected faults itself, and only wall-clock delays that speculation
    did not neutralize still require real threads to sleep in."""
    return vectorize_decline(cluster, args) is None


def _comb(args: ShuffleArgs, ledger, wid: int, batches) -> Msgs:
    """ctx.COMB semantics: concat, charge the combine, apply the combiner."""
    batch = batches if isinstance(batches, Msgs) else Msgs.concat(list(batches))
    if args.comb_fn is None:
        return batch
    ledger.charge_combine(wid, batch.nbytes, tenant=args.tenant)
    return combine_msgs(args.comb_fn, batch)


def owner_merge(ledger, topo, args: ShuffleArgs, skew,
                out: dict[int, Msgs]) -> None:
    """Batched replay of templates.owner_merge, in place on ``out``: every
    sharer's forwarded rows come from its post-receiver buffer (removals
    across owners are disjoint key sets), then each owner combines [kept] +
    sharer rows in sorted-sharer order — row for row what the threaded stage
    does, and charged as it charges them: every sharer's transfer first,
    then one combine per owner.  The vectorized and the torch executors
    both run it."""
    merge = owner_merge_plan(skew, args.part_fn, tuple(args.dsts))
    inbox: dict[int, list[Msgs]] = {}
    for owner, (owned_keys, sharers) in merge.items():
        got = []
        for s in sharers:
            mask = np.isin(out[s].keys, owned_keys)
            rows = out[s].take(np.nonzero(mask)[0])
            out[s] = out[s].take(np.nonzero(~mask)[0])
            ledger.charge_transfer(s, topo.crossing_level(s, owner),
                                   rows.nbytes, dst=owner,
                                   tenant=args.tenant)
            got.append(rows)
        inbox[owner] = got
    for owner, got in inbox.items():
        out[owner] = _comb(args, ledger, owner,
                           Msgs.concat([out[owner]] + got))


def run_shuffle_vectorized(
    cluster: LocalCluster,
    args: ShuffleArgs,
    bufs: dict[int, Msgs],
    manager=None,
) -> ShuffleResult:
    """Execute ``args.plan`` on the batched data plane; see module docstring."""
    tracer = cluster.obs.tracer
    if not tracer.enabled:
        return _run_vectorized_impl(cluster, args, bufs, manager)
    with tracer.span("exec", shuffle_id=args.shuffle_id, tenant=args.tenant,
                     engine="vectorized", template=args.template_id,
                     streamed=args.stream is not None):
        return _run_vectorized_impl(cluster, args, bufs, manager)


def _run_vectorized_impl(
    cluster: LocalCluster,
    args: ShuffleArgs,
    bufs: dict[int, Msgs],
    manager=None,
) -> ShuffleResult:
    plan = args.plan
    if plan is None:
        raise ValueError("vectorized execution requires a CompiledPlan")
    if args.template_id not in VECTORIZABLE:
        raise ValueError(f"template {args.template_id!r} is not vectorizable")
    skew_active = plan.skew is not None and plan.skew.triggered
    if args.stream is not None and not skew_active:
        # chunk-pipelined replay: byte-identical to the threaded streaming
        # driver (a rebalanced plan falls through to the barrier replay below,
        # exactly like the threaded driver falls back to barrier programs)
        return _run_streamed_vectorized(cluster, args, bufs, manager)
    topo = cluster.topology
    ledger = cluster.ledger
    sid = args.shuffle_id
    rc = args.recovery
    attempt = rc.attempt if rc is not None else 0
    resume = dict(rc.resume_stages) if rc is not None else {}
    srcs, dsts = list(args.srcs), list(args.dsts)
    participants = sorted(set(srcs) | set(dsts))
    st = args.storage
    persist = st is not None and st.persist
    served = (frozenset(getattr(rc, "store_served", ()) or ())
              if rc is not None else frozenset())
    if served:
        # store-served pure senders execute nothing and journal nothing —
        # the same evidence the threaded driver leaves
        participants = [w for w in participants
                        if w in dsts or w not in served]
    live = [w for w in srcs if w not in served]
    skew = plan.skew if plan.skew is not None and plan.skew.triggered else None
    # the effective partFunc mirrors the threaded ctx.part_fn: the hot-key
    # scatter wraps every PART the plan replays (it passes through untouched
    # for assignments outside the decision's slot space)
    eff_part = scatter_part_fn(args.part_fn, skew) if skew else args.part_fn
    if manager is not None:
        manager.get_template(args.template_id, wid=None)
        for w in participants:
            manager.record_start(w, sid, args.template_id, attempt=attempt,
                                 tenant=args.tenant)
    before = ledger.snapshot()
    observed: list[tuple] = []

    def _first_casualty(stage_idx: int, workers) -> tuple[int, str] | None:
        """A worker about to execute this stage that is dead or whose injected
        fault has matured — the same death point as the threaded executor's
        first-primitive-of-the-stage check.  Chunk-scoped faults
        (``after_chunk``) never mature at stage boundaries (they only fire
        inside a streamed global exchange, which the barrier replay never
        runs)."""
        for w in workers:
            if resume.get(w, -1) >= stage_idx:
                continue                      # resuming past it: nothing to run
            if w in cluster.failed_workers:
                return w, "is failed"
            fi = cluster.fault_injections.get(w)
            if fi is not None and fi.after_chunk is None \
                    and stage_idx > fi.after_stage:
                return w, f"killed by fault injection (after stage {fi.after_stage})"
        return None

    def _abort(w: int, why: str, stage_name: str) -> None:
        cluster.failed_workers.add(w)
        cluster.abort_event(sid).set()
        cluster.end_shuffle(sid, aborted=True, participants=participants)
        raise ShuffleAborted(
            f"worker {w} {why} (vectorized, stage {stage_name!r})",
            shuffle_id=sid)

    # ---- sender side -------------------------------------------------------
    if args.template_id == "network_aware":
        # local combine, then each hierarchical stage from the plan; on a
        # recovery attempt, workers past a stage replay its checkpoint instead
        state = {w: (None if w in served or resume.get(w, -1) >= 0
                     else _comb(args, ledger, w, bufs.get(w, Msgs.empty())))
                 for w in srcs}
        for li, ld in enumerate(plan.levels):
            bad = _first_casualty(li, live)
            if bad is not None:
                _abort(*bad, ld.level)
            for w in live:
                if resume.get(w, -1) == li:
                    state[w] = rc.store.load(sid, w, li)
            execute = [w for w in live if resume.get(w, -1) < li]
            if ld.eff_cost.beneficial and execute:
                tracer = cluster.obs.tracer
                stage_sp = tracer.span(
                    "stage", shuffle_id=sid, tenant=args.tenant,
                    level=ld.level, workers=len(execute),
                ) if tracer.enabled else None
                ledger.advance_epoch()    # the stage barrier (PLAN_STAGE's epoch)
                staged = {}
                for w in execute:
                    nbrs = list(ld.nbrs.get(w, (w,)))
                    if len(nbrs) > 1:
                        staged[w] = (nbrs, partition(state[w], nbrs, eff_part))
                for w, (nbrs, parts) in staged.items():
                    peers = [n for n in nbrs if n != w]
                    ledger.charge_transfers(
                        w,
                        np.fromiter((topo.crossing_level(w, n) for n in peers),
                                    dtype=np.int64, count=len(peers)),
                        np.fromiter((parts[n].nbytes for n in peers),
                                    dtype=np.int64, count=len(peers)),
                        dsts=np.asarray(peers, dtype=np.int64),
                        tenant=args.tenant)
                for w, (nbrs, parts) in staged.items():
                    got = [parts[w]] + [staged[n][1][w] for n in nbrs if n != w]
                    pre = sum(g.nbytes for g in got)
                    state[w] = _comb(args, ledger, w, got)
                    observed.append((ld.level, pre, state[w].nbytes))
                if stage_sp is not None:
                    stage_sp.end()
            if rc is not None:
                for w in execute:
                    rc.store.save(sid, w, li, ld.level, state[w])
                    if rc.record_stage is not None:
                        rc.record_stage(w, ld.level)
    else:
        state = {w: bufs.get(w, Msgs.empty()) for w in srcs}

    # faults that mature at (or before) the global exchange, incl. dead
    # receivers — static templates reach here with zero completed stages
    bad = _first_casualty(len(plan.levels), live)
    if bad is None:
        dead_dst = next((d for d in dsts if d in cluster.failed_workers), None)
        if dead_dst is not None:
            bad = (dead_dst, "is failed")
    if bad is not None:
        if persist:
            # mirror the threaded driver: surviving senders' global PARTs
            # complete (and persist) even though the exchange aborts, so the
            # retry's store-served set is identical on both executors
            n_stages = len(plan.levels)
            for w in live:
                if w == bad[0] or w in cluster.failed_workers:
                    continue
                fi = cluster.fault_injections.get(w)
                if (fi is not None and fi.after_chunk is None
                        and n_stages > fi.after_stage):
                    continue
                st.store.put_parts(st.tenant, sid, "global", w,
                                   partition(state[w], dsts, eff_part))
        _abort(*bad, "global")

    # ---- global stage ------------------------------------------------------
    parts_by_src = {}
    for w in srcs:
        if w in served:
            # store-backed replay: this sender's persisted partitions, read
            # back byte-identically (restore charged by the store; no wire
            # transfer and no re-execution)
            loaded = {}
            for d in dsts:
                blk = st.store.get_block(st.tenant, sid, "global", w, d)
                loaded[d] = blk if blk is not None else Msgs.empty()
            parts_by_src[w] = loaded
        else:
            parts_by_src[w] = partition(state[w], dsts, eff_part)
            if persist:
                st.store.put_parts(st.tenant, sid, "global", w,
                                   parts_by_src[w])

    if args.template_id in ("vanilla_push", "network_aware"):
        # push: the sender pays the transfer (served senders send nothing)
        for w in live:
            ledger.charge_transfers(
                w,
                np.fromiter((topo.crossing_level(w, d) for d in dsts),
                            dtype=np.int64, count=len(dsts)),
                np.fromiter((parts_by_src[w][d].nbytes for d in dsts),
                            dtype=np.int64, count=len(dsts)),
                dsts=np.asarray(dsts, dtype=np.int64),
                tenant=args.tenant)
        fetch_order = {d: srcs for d in dsts}
        charge_receiver = False
    elif args.template_id == "vanilla_pull":
        fetch_order = {d: srcs for d in dsts}
        charge_receiver = True
    else:  # coordinated: ring-rotated FETCH order, receiver pays
        n = len(srcs)
        fetch_order = {d: [srcs[(srcs.index(d) - t) % n] for t in range(n)]
                       for d in dsts}
        charge_receiver = True

    out: dict[int, Msgs] = {}
    for d in dsts:
        got = [parts_by_src[s][d] for s in fetch_order[d]]
        if charge_receiver:
            # pull mode: the receiver pays — but a served sender's partition
            # came from the store, not the wire, so it is never charged
            chg = [s for s in fetch_order[d] if s not in served]
            ledger.charge_transfers(
                d,
                np.fromiter((topo.crossing_level(s, d) for s in chg),
                            dtype=np.int64, count=len(chg)),
                np.fromiter((parts_by_src[s][d].nbytes for s in chg),
                            dtype=np.int64, count=len(chg)),
                dsts=np.full(len(chg), d, dtype=np.int64),
                tenant=args.tenant)
        out[d] = _comb(args, ledger, d, got)

    # ---- owner merge (rebalanced plans) ------------------------------------
    if skew is not None:
        owner_merge(ledger, topo, args, skew, out)

    if persist:
        # write-behind barrier: spill charges land before the after-snapshot
        st.store.flush(sid)
    ledger.advance_epoch()                # shuffle completion is a barrier
    if rc is not None:
        cluster.end_shuffle(sid)          # symmetric with the threaded driver
    after = ledger.snapshot()
    if manager is not None:
        for w in participants:
            manager.record_end(w, sid, args.template_id, attempt=attempt,
                               tenant=args.tenant)
    return ShuffleResult(
        bufs=out,
        decisions=list(plan.decisions),
        stats=ledger.delta(before, after),
        observed=aggregate_observed([observed]),
        cached=True,
        vectorized=True,
        engine="vectorized",
    )


# ---------------------------------------------------------------------------
# Chunk-pipelined replay
# ---------------------------------------------------------------------------

def _fold_chunks(args: ShuffleArgs, ledger, wid: int, acc: Msgs | None,
                 piece: Msgs, chunk: int) -> Msgs:
    """The batched mirror of ``WorkerContext.COMB_INC``: accumulator rows
    concat ahead of the chunk, only the chunk's bytes are charged (pipelined
    combine lane), and the combiner's sequential fold continues exactly."""
    batch = piece if acc is None else Msgs.concat([acc, piece])
    if args.comb_fn is None:
        return batch
    ledger.charge_combine(wid, piece.nbytes, chunk=chunk, tenant=args.tenant)
    return combine_msgs(args.comb_fn, batch)


def _run_streamed_vectorized(
    cluster: LocalCluster,
    args: ShuffleArgs,
    bufs: dict[int, Msgs],
    manager=None,
) -> ShuffleResult:
    """Replay a streamed CompiledPlan chunk-by-chunk, single-threaded.

    Mirrors the threaded streaming driver exactly: stable chunked partitions,
    fold order (own partitions first for local stages; source order — or ring
    order for ``coordinated`` — for the global stream), per-chunk ledger
    charges into the pipelined lanes, ``end_stream`` where the threaded
    end-of-stream rendezvous fires, and chunk-granular stream checkpoints
    under resilience.  ``after_chunk`` fault injections mature at the same
    chunk-unit boundaries as the threaded executor (sender units first, then
    fold units), so mid-chunk kills recover byte-identically on both
    executors.
    """
    plan = args.plan
    cp = args.stream
    topo = cluster.topology
    ledger = cluster.ledger
    sid = args.shuffle_id
    rc = args.recovery
    attempt = rc.attempt if rc is not None else 0
    resume = dict(rc.resume_stages) if rc is not None else {}
    srcs, dsts = list(args.srcs), list(args.dsts)
    participants = sorted(set(srcs) | set(dsts))
    if manager is not None:
        manager.get_template(args.template_id, wid=None)
        for w in participants:
            manager.record_start(w, sid, args.template_id, attempt=attempt,
                                 tenant=args.tenant)
    before = ledger.snapshot()
    observed: list[tuple] = []

    def _chunk_budget(w: int) -> int | None:
        fi = cluster.fault_injections.get(w)
        return None if fi is None or fi.after_chunk is None else fi.after_chunk

    def _stage_casualty(stage_idx: int, workers) -> tuple[int, str] | None:
        for w in workers:
            if resume.get(w, -1) >= stage_idx:
                continue
            if w in cluster.failed_workers:
                return w, "is failed"
            fi = cluster.fault_injections.get(w)
            if fi is not None and fi.after_chunk is None \
                    and stage_idx > fi.after_stage:
                return w, f"killed by fault injection (after stage {fi.after_stage})"
        return None

    def _abort(w: int, why: str, stage_name: str) -> None:
        cluster.failed_workers.add(w)
        cluster.abort_event(sid).set()
        cluster.end_shuffle(sid, aborted=True, participants=participants)
        raise ShuffleAborted(
            f"worker {w} {why} (vectorized streamed, stage {stage_name!r})",
            shuffle_id=sid)

    # ---- local hierarchy stages (network_aware), each a streamed sub-epoch --
    if args.template_id == "network_aware":
        state = {w: (None if resume.get(w, -1) >= 0
                     else _comb(args, ledger, w, bufs.get(w, Msgs.empty())))
                 for w in srcs}
        for li, ld in enumerate(plan.levels):
            bad = _stage_casualty(li, srcs)
            if bad is not None:
                _abort(*bad, ld.level)
            for w in srcs:
                if resume.get(w, -1) == li:
                    state[w] = rc.store.load(sid, w, li)
            execute = [w for w in srcs if resume.get(w, -1) < li]
            if ld.eff_cost.beneficial and execute:
                ledger.advance_epoch()    # the stage barrier (PLAN_STAGE's epoch)
                staged = {}
                for w in execute:
                    nbrs = list(ld.nbrs.get(w, (w,)))
                    if len(nbrs) > 1:
                        chunks = [partition(piece, nbrs, args.part_fn)
                                  for piece in cp.chunks(state[w])]
                        staged[w] = (nbrs, chunks)
                for w, (nbrs, chunks) in staged.items():
                    peers = [n for n in nbrs if n != w]
                    for c, parts in enumerate(chunks):
                        ledger.charge_transfers(
                            w,
                            np.fromiter((topo.crossing_level(w, n) for n in peers),
                                        dtype=np.int64, count=len(peers)),
                            np.fromiter((parts[n].nbytes for n in peers),
                                        dtype=np.int64, count=len(peers)),
                            dsts=np.asarray(peers, dtype=np.int64), chunk=c,
                            tenant=args.tenant)
                for w, (nbrs, chunks) in staged.items():
                    # fold own partitions first, then each neighbor's chunk
                    # stream in group order — the barrier concat order
                    acc, pre = None, 0
                    for c, parts in enumerate(chunks):
                        acc = _fold_chunks(args, ledger, w, acc, parts[w], c)
                        pre += parts[w].nbytes
                    for n in nbrs:
                        if n == w:
                            continue
                        for c, parts in enumerate(staged[n][1]):
                            acc = _fold_chunks(args, ledger, w, acc, parts[w], c)
                            pre += parts[w].nbytes
                    state[w] = acc if acc is not None else Msgs.empty()
                    observed.append((ld.level, pre, state[w].nbytes))
                ledger.end_stream()       # the stage's end-of-stream rendezvous
            if rc is not None:
                for w in execute:
                    rc.store.save(sid, w, li, ld.level, state[w])
                    if rc.record_stage is not None:
                        rc.record_stage(w, ld.level)
    else:
        state = {w: bufs.get(w, Msgs.empty()) for w in srcs}

    # stage-scoped faults that mature at the global exchange, incl. dead
    # receivers (chunk-scoped faults mature inside the stream, below)
    bad = _stage_casualty(len(plan.levels), srcs)
    if bad is None:
        dead_dst = next((d for d in dsts if d in cluster.failed_workers), None)
        if dead_dst is not None:
            bad = (dead_dst, "is failed")
    if bad is not None:
        _abort(*bad, "global")

    # ---- global streamed exchange ------------------------------------------
    nch = {s: cp.nchunks(state[s]) for s in srcs}
    # sender cuts: how much of each stream exists before a chunk fault fires.
    # A sender completes chunk units 0..budget, then dies at its next
    # primitive — the next chunk's PART, or the EOS send when all chunks went.
    casualty = None
    sent, eos_sent = {}, {}
    for s in srcs:
        b = _chunk_budget(s)
        if b is None or b >= nch[s]:
            sent[s], eos_sent[s] = nch[s], True
        else:
            sent[s] = min(nch[s], b + 1)
            eos_sent[s] = False
            if casualty is None:
                casualty = s
    parts_by_src = {
        s: [partition(cp.chunk(state[s], c), dsts, args.part_fn)
            for c in range(sent[s])]
        for s in srcs}

    receiver_pays = args.template_id in ("vanilla_pull", "coordinated")
    if not receiver_pays:                 # push: the sender pays, per chunk
        for s in srcs:
            for c in range(sent[s]):
                parts = parts_by_src[s][c]
                ledger.charge_transfers(
                    s,
                    np.fromiter((topo.crossing_level(s, d) for d in dsts),
                                dtype=np.int64, count=len(dsts)),
                    np.fromiter((parts[d].nbytes for d in dsts),
                                dtype=np.int64, count=len(dsts)),
                    dsts=np.asarray(dsts, dtype=np.int64), chunk=c,
                    tenant=args.tenant)
    if args.template_id == "coordinated":
        n = len(srcs)
        fold_order = {d: [srcs[(srcs.index(d) - t) % n] for t in range(n)]
                      for d in dsts}
    else:
        fold_order = {d: srcs for d in dsts}

    out: dict[int, Msgs] = {}
    abort_receiver = None                 # (wid, why) when a fold unit died
    for d in dsts:
        order = fold_order[d]
        ck = (rc.store.load_stream(sid, d, "global")
              if rc is not None and attempt > 0 else None)
        if ck is not None and rc.record_stage is not None:
            rc.record_stage(
                d, f"stream-resume:global:{ck.peer_idx}:{ck.folded}")
        start_i, skip, pre, acc = ((ck.peer_idx, ck.folded, ck.pre_bytes, ck.acc)
                                   if ck is not None else (0, 0, 0, None))
        # fold-unit budget: sender units of this worker were consumed first
        b = _chunk_budget(d)
        base_units = nch[d] if d in srcs else 0
        fold_budget = None if b is None or b < base_units else b - base_units + 1
        cursor = (start_i, skip)
        units = 0
        complete = True
        for i, s in enumerate(order):
            for c in range(sent[s]):
                if receiver_pays:         # pull: the fetch charges, per chunk
                    ledger.charge_transfer(d, topo.crossing_level(s, d),
                                           parts_by_src[s][c][d].nbytes,
                                           dst=d, chunk=c,
                                           tenant=args.tenant)
                if i < start_i or (i == start_i and c < skip):
                    continue              # re-sent chunk already in the acc
                if fold_budget is not None and units >= fold_budget:
                    complete = False      # this worker's chunk fault matured
                    if abort_receiver is None:
                        abort_receiver = (d, "killed by fault injection "
                                             f"(after chunk {b})")
                    break
                acc = _fold_chunks(args, ledger, d, acc, parts_by_src[s][c][d],
                                   c)
                pre += parts_by_src[s][c][d].nbytes
                units += 1
                cursor = (i, c + 1)
            else:
                if not eos_sent[s]:       # sender died mid-stream: the
                    complete = False      # receiver blocks here, then aborts
                    break
                continue
            break
        if complete and fold_budget is not None and units >= fold_budget:
            # the fault matures at the very next primitive — the end-of-stream
            # rendezvous — exactly where the threaded worker would die
            complete = False
            if abort_receiver is None:
                abort_receiver = (d, "killed by fault injection "
                                     f"(after chunk {b})")
        if rc is not None:
            rc.store.save_stream(sid, d, "global", cursor[0], cursor[1], pre,
                                 acc)
        if complete:
            out[d] = acc if acc is not None else Msgs.empty()

    if abort_receiver is not None:
        _abort(abort_receiver[0], abort_receiver[1], "global")
    if casualty is not None:
        _abort(casualty, "killed by fault injection "
                         f"(after chunk {_chunk_budget(casualty)})", "global")

    ledger.end_stream()                   # the end-of-stream rendezvous
    ledger.advance_epoch()                # residual non-streamed charges
    if rc is not None:
        cluster.end_shuffle(sid)          # symmetric with the threaded driver
    after = ledger.snapshot()
    if manager is not None:
        for w in participants:
            manager.record_end(w, sid, args.template_id, attempt=attempt,
                               tenant=args.tenant)
    return ShuffleResult(
        bufs=out,
        decisions=list(plan.decisions),
        stats=ledger.delta(before, after),
        observed=aggregate_observed([observed]),
        cached=True,
        vectorized=True,
        streamed=True,
        engine="vectorized",
    )
