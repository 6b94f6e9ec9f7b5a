"""Shuffle templates (paper §3.2/§4) and the driver that executes instantiated plans.

A template is a pair of per-worker programs — *sender* and *receiver* — written
against the Table-2 primitives on a :class:`WorkerContext`.  `$`-parameters (neighbor
discovery, sampling rate, EFF/COST estimation) are instantiated from the topology and
runtime sampling when the plan runs.  The five templates below are the paper's
Table 3; their LoC (counted by ``template_loc``) reproduces that table.

Execution semantics follow the paper: primitives are synchronous, senders and
receivers may arrive at different times, and a worker that appears in both ``srcs``
and ``dsts`` runs the sender program first, then the receiver program.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable

import numpy as np

from .adaptive import compute_eff_cost
from .messages import Msgs
from .primitives import (EndOfStream, LocalCluster, ShuffleAborted, ShuffleArgs,
                         WorkerContext)
from .skew import local_skew_stats, owner_merge_plan, scatter_part_fn


@dataclasses.dataclass(frozen=True)
class ShuffleTemplate:
    template_id: str
    sender: Callable[[WorkerContext, Msgs], None]
    receiver: Callable[[WorkerContext], Msgs]
    mode: str                    # "push" | "pull" | "push/pull"
    description: str = ""
    rebalanceable: bool = True
    # ^ hot-key scattering (core/skew.py) is positional: it is only sound for
    #   templates that assign each message its *final* destination in a single
    #   PART over the full destination set.  A template that re-partitions
    #   messages en route (two_level's phase-3 PART inside a group) would
    #   re-scatter by position within a different buffer and strand rows whose
    #   new slot falls outside that stage's fan-out.
    stream_sender: Callable[[WorkerContext, Msgs], None] | None = None
    stream_receiver: Callable[[WorkerContext], Msgs] | None = None
    # ^ the chunk-pipelined rewrites of the same programs, driven by the
    #   shuffle's ChunkPlan.  A template whose exchange structure cannot be
    #   chunked without changing semantics (bruck's log-step rounds re-block
    #   messages between sends; two_level re-partitions en route) leaves them
    #   unset and always runs the barrier model — `streamable` is the
    #   streaming analogue of `rebalanceable`.

    @property
    def streamable(self) -> bool:
        return self.stream_sender is not None and self.stream_receiver is not None

    def loc(self) -> int:
        return template_loc(self.sender) + template_loc(self.receiver)


def template_loc(fn: Callable) -> int:
    """Non-blank, non-comment, non-docstring lines of a template body (Table 3)."""
    src = inspect.getsource(fn)
    lines = src.splitlines()[1:]                      # drop the def line
    n, in_doc = 0, False
    for ln in lines:
        s = ln.strip()
        if not s or s.startswith("#"):
            continue
        if s.startswith('"""') or s.startswith("'''"):
            in_doc = not in_doc if not (s.endswith(('"""', "'''")) and len(s) > 3) else in_doc
            continue
        if in_doc:
            continue
        n += 1
    return n


# ---------------------------------------------------------------------------
# Vanilla shuffling (push and pull) — Table 3 row 1
# ---------------------------------------------------------------------------

def _vanilla_push_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    parts = ctx.PART(bufs, ctx.args.dsts)
    for d in ctx.args.dsts:
        ctx.SEND(d, parts[d])


def _push_receiver(ctx: WorkerContext) -> Msgs:
    got = [ctx.RECV(s) for s in ctx.args.srcs]
    return ctx.COMB(got)


def _vanilla_pull_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    ctx.PART(bufs, ctx.args.dsts, publish=True)


def _pull_receiver(ctx: WorkerContext) -> Msgs:
    got = [ctx.FETCH(s) for s in ctx.args.srcs]
    return ctx.COMB(got)


# ---------------------------------------------------------------------------
# Coordinated shuffling [21] — ring-paired pulls to maximize NUMA bandwidth
# ---------------------------------------------------------------------------

def _coordinated_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    ctx.PART(bufs, ctx.args.dsts, publish=True)


def _coordinated_receiver(ctx: WorkerContext) -> Msgs:
    ring = list(ctx.args.srcs)
    i = ring.index(ctx.wid)
    got = []
    for t in range(len(ring)):                 # rotate: every step pairs one
        src = ring[(i - t) % len(ring)]        # sender with one receiver, so no
        got.append(ctx.FETCH(src))             # worker is ever the incast hot-spot
    return ctx.COMB(got)


# ---------------------------------------------------------------------------
# Bruck all-to-all [38] — log-step exchange, never blocked on a single process
# ---------------------------------------------------------------------------

def _bruck_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    ring, me = list(ctx.args.srcs), ctx.args.srcs.index(ctx.wid)
    n = len(ring)
    parts = ctx.PART(bufs, ctx.args.dsts)
    blocks = {j: parts[ring[(me + j) % n]] for j in range(n)}   # relative indexing
    k, step = 0, 1
    while step < n:
        peer_to, peer_from = ring[(me + step) % n], ring[(me - step) % n]
        js = [j for j in range(n) if j & step]
        for j in js:
            ctx.SEND(peer_to, blocks.pop(j, Msgs.empty()))
            blocks[j] = Msgs.empty()
        for j in js:
            got = ctx.RECV(peer_from)
            blocks[j - step] = Msgs.concat([blocks.get(j - step, Msgs.empty()), got])
        k, step = k + 1, step * 2
    ctx.SEND(ctx.wid, ctx.COMB(blocks[0]))     # deposit own result (local, free)


def _bruck_receiver(ctx: WorkerContext) -> Msgs:
    return ctx.RECV(ctx.wid)


# ---------------------------------------------------------------------------
# Two-level exchange [27] — group workers; merge per-group flows (serverless)
# ---------------------------------------------------------------------------

def _two_level_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    workers = list(ctx.args.srcs)
    q = int(round(len(workers) ** 0.5))
    assert q * q == len(workers), "two_level requires a square worker grid"
    me = workers.index(ctx.wid)
    g, i = divmod(me, q)
    parts = ctx.PART(bufs, ctx.args.dsts)
    # phase 1 (intra-group): member j aggregates everything destined to group j
    for j in range(q):
        block = Msgs.concat([parts[ctx.args.dsts[d]] for d in range(len(workers))
                             if d // q == j])
        ctx.SEND(workers[g * q + j], block)
    mine = ctx.COMB([ctx.RECV(workers[g * q + j]) for j in range(q)])
    # phase 2 (inter-group): one merged flow per group pair, (g, i) <-> (i, g)
    ctx.SEND(workers[i * q + g], mine)
    blk = ctx.COMB(ctx.RECV(workers[i * q + g]))
    # phase 3 (intra-group): fan out to the final member
    fin = ctx.PART(blk, ctx.args.dsts)
    for j in range(q):
        ctx.SEND(workers[g * q + j], fin[workers[g * q + j]])
    ctx.SEND(ctx.wid, ctx.COMB([ctx.RECV(workers[g * q + j]) for j in range(q)]))


def _two_level_receiver(ctx: WorkerContext) -> Msgs:
    return ctx.RECV(ctx.wid)


# ---------------------------------------------------------------------------
# Network-aware shuffling (Figure 3) — adaptive hierarchical shuffle
# ---------------------------------------------------------------------------

def _eff_cost_compute(ctx: WorkerContext, level: str):
    """Build the ``$COMPUTE_EFF_COST`` closure the sampling server runs.

    Under ``balance="auto"`` the verdict couples to the ledger's observed
    per-destination recv-byte imbalance: the closure executes while every
    stage participant is blocked in the rendezvous (the ledger is quiescent),
    so the hot-destination tail factor it reads is deterministic.
    """
    a = ctx.args

    def compute(samples, sizes, lv=level):
        recv_imb = (ctx.cluster.ledger.recv_imbalance(a.dsts)
                    if a.balance == "auto" else 1.0)
        return compute_eff_cost(
            ctx.topology, lv, samples,
            group_bytes=sum(sizes) // max(1, ctx.topology.num_workers
                                          // ctx.topology.level(lv).group_size),
            group_size=ctx.topology.level(lv).group_size,
            combiner=a.comb_fn, recv_imbalance=recv_imb)

    return compute


def _network_aware_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    a = ctx.args
    bufs = ctx.COMB(bufs)                                          # local combine
    for level in ctx.local_level_names():                          # server, rack, ...
        restored = ctx.RESUME(level)                               # recovery replay?
        if restored is not None:
            bufs = restored
            continue
        nbrs, ec = ctx.PLAN_STAGE(level)                           # compiled-plan hit?
        if ec is None:                                             # miss: instantiate
            nbrs = ctx.FIND_NBRS(level, a.srcs)                    # $FIND_NBRS_PER_*
            samp = ctx.SAMP(bufs, a.rate, fallback=True)           # $RATE
            ec = ctx.GATHER_SAMPLES(                               # $COMPUTE_EFF_COST
                level, samp, bufs.nbytes,
                compute=_eff_cost_compute(ctx, level))
        ctx.decisions.append((level, ec))
        if ec.beneficial and len(nbrs) > 1:
            parts = ctx.PART(bufs, nbrs)
            for n in nbrs:
                if n != ctx.wid:
                    ctx.SEND(n, parts[n])
            got = [parts[ctx.wid]] + [ctx.RECV(n) for n in nbrs if n != ctx.wid]
            pre = sum(g.nbytes for g in got)
            bufs = ctx.COMB(got)
            ctx.OBSERVE(level, pre, bufs.nbytes)                   # drift signal
        bufs = ctx.CKPT(level, bufs)                               # stage complete
    parts = ctx.PART(bufs, a.dsts)                                 # global shuffle
    for d in a.dsts:
        ctx.SEND(d, parts[d])


# ---------------------------------------------------------------------------
# Streaming (chunk-pipelined) program rewrites — see repro_torch.core.streaming
# ---------------------------------------------------------------------------

def _local_stream(own_chunks: list[Msgs]):
    """Iterator-shaped stream over this worker's own (local, free) partitions."""
    it = iter(list(own_chunks) + [EndOfStream(len(own_chunks))])
    return lambda: next(it)


def _recv_stream(ctx: WorkerContext, src: int):
    return lambda: ctx.RECV_CHUNK(src)


def _fetch_stream(ctx: WorkerContext, src: int):
    state = {"c": 0}

    def nxt():
        got = ctx.FETCH_CHUNK(src, state["c"])
        if not isinstance(got, EndOfStream):
            state["c"] += 1
        return got

    return nxt


def _stream_fold(ctx: WorkerContext, streams, tag: str, *,
                 count_units: bool = False) -> tuple[int, Msgs]:
    """Fold ordered chunk streams into a running accumulator.

    ``streams`` is an ordered list of ``next()`` callables, each yielding
    ``Msgs`` chunks then :class:`EndOfStream` — ordered exactly as the barrier
    receiver concatenates its sources, which (with the combiner's sequential
    fold) is what keeps the accumulator byte-identical to the barrier output.
    Every completed fold checkpoints the accumulator (chunk-granular recovery);
    on a retry the fold resumes from the checkpointed cursor and re-sent
    chunks before it are drained and discarded.  Returns ``(pre_bytes, acc)``
    where ``pre_bytes`` is the total folded input (the OBSERVE numerator).
    """
    ck = ctx.RESUME_STREAM(tag)
    start_i, skip, pre, acc = ((ck.peer_idx, ck.folded, ck.pre_bytes, ck.acc)
                               if ck is not None else (0, 0, 0, None))
    for i, nxt in enumerate(streams):
        if i < start_i:
            folded = None                  # fully folded on a prior attempt
        else:
            folded = skip if i == start_i else 0
        c = 0
        while True:
            got = nxt()
            if isinstance(got, EndOfStream):
                break
            if folded is None or c < folded:
                c += 1                     # re-sent chunk already in the acc
                continue
            acc = ctx.COMB_INC(acc, got, chunk=c)
            pre += got.nbytes
            c += 1
            if count_units:
                ctx.chunks_done += 1
            ctx.CKPT_STREAM(tag, i, c, pre, acc)
    return pre, (acc if acc is not None else Msgs.empty())


def _chunked_send(ctx: WorkerContext, bufs: Msgs, *, publish: bool = False,
                  count_units: bool = False) -> None:
    """The streamed global send: fixed-budget chunks, then end-of-stream."""
    dsts = ctx.args.dsts
    cp = ctx.chunk_plan
    nch = cp.nchunks(bufs)
    for c in range(nch):
        piece = cp.chunk(bufs, c)
        if publish:
            ctx.PART(piece, dsts, publish=True, chunk=c)
        else:
            parts = ctx.PART(piece, dsts)
            for d in dsts:
                ctx.SEND(d, parts[d], chunk=c)
        if count_units:
            ctx.chunks_done += 1
    if publish:
        ctx.PUBLISH_EOS(nch)
    else:
        for d in dsts:
            ctx.SEND_EOS(d, nch)


def _streaming_push_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    _chunked_send(ctx, bufs, count_units=True)


def _streaming_push_receiver(ctx: WorkerContext) -> Msgs:
    streams = [_recv_stream(ctx, s) for s in ctx.args.srcs]
    _, out = _stream_fold(ctx, streams, "global", count_units=True)
    return out


def _streaming_pull_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    _chunked_send(ctx, bufs, publish=True, count_units=True)


def _streaming_pull_receiver(ctx: WorkerContext) -> Msgs:
    streams = [_fetch_stream(ctx, s) for s in ctx.args.srcs]
    _, out = _stream_fold(ctx, streams, "global", count_units=True)
    return out


def _streaming_coordinated_receiver(ctx: WorkerContext) -> Msgs:
    ring = list(ctx.args.srcs)
    i = ring.index(ctx.wid)
    order = [ring[(i - t) % len(ring)] for t in range(len(ring))]
    streams = [_fetch_stream(ctx, s) for s in order]
    _, out = _stream_fold(ctx, streams, "global", count_units=True)
    return out


def _streaming_local_exchange(ctx: WorkerContext, bufs: Msgs, nbrs: list[int],
                              level: str) -> tuple[int, Msgs]:
    """One hierarchical stage as a chunked sub-epoch: chunk-partition to the
    neighbor group, fold own partitions then each neighbor's stream — the
    same source order the barrier stage concatenates in."""
    cp = ctx.chunk_plan
    nch = cp.nchunks(bufs)
    own: list[Msgs] = []
    for c in range(nch):
        parts = ctx.PART(cp.chunk(bufs, c), nbrs)
        for n in nbrs:
            if n != ctx.wid:
                ctx.SEND(n, parts[n], chunk=c)
        own.append(parts[ctx.wid])
    for n in nbrs:
        if n != ctx.wid:
            ctx.SEND_EOS(n, nch)
    streams = [_local_stream(own)] + [_recv_stream(ctx, n)
                                      for n in nbrs if n != ctx.wid]
    return _stream_fold(ctx, streams, level)


def _streaming_network_aware_sender(ctx: WorkerContext, bufs: Msgs) -> None:
    a = ctx.args
    bufs = ctx.COMB(bufs)                                          # local combine
    for level in ctx.local_level_names():
        restored = ctx.RESUME(level)
        if restored is not None:
            bufs = restored
            continue
        nbrs, ec = ctx.PLAN_STAGE(level)
        if ec is None:
            nbrs = ctx.FIND_NBRS(level, a.srcs)
            samp = ctx.SAMP(bufs, a.rate, fallback=True)
            ec = ctx.GATHER_SAMPLES(level, samp, bufs.nbytes,
                                    compute=_eff_cost_compute(ctx, level))
        ctx.decisions.append((level, ec))
        if ec.beneficial:
            if len(nbrs) > 1:
                pre, merged = _streaming_local_exchange(ctx, bufs, nbrs, level)
                ctx.OBSERVE(level, pre, merged.nbytes)
                bufs = merged
            # per-stage end-of-stream: closes this stage's pipelined sub-epoch;
            # every stage participant joins (even one alone in its group), so
            # the rendezvous fills exactly like the barrier stage's would
            ctx.STREAM_EOS(level, ctx._stage_participants(
                ctx.topology.level_index(level)))
        bufs = ctx.CKPT(level, bufs)
    _chunked_send(ctx, bufs, count_units=True)                     # global stream


TEMPLATES: dict[str, ShuffleTemplate] = {}


def register_template(t: ShuffleTemplate) -> ShuffleTemplate:
    TEMPLATES[t.template_id] = t
    return t


register_template(ShuffleTemplate(
    "vanilla_push", _vanilla_push_sender, _push_receiver, "push",
    "Send messages from sources to destinations.",
    stream_sender=_streaming_push_sender,
    stream_receiver=_streaming_push_receiver))
register_template(ShuffleTemplate(
    "vanilla_pull", _vanilla_pull_sender, _pull_receiver, "pull",
    "Receivers fetch partitioned messages from sources.",
    stream_sender=_streaming_pull_sender,
    stream_receiver=_streaming_pull_receiver))
register_template(ShuffleTemplate(
    "coordinated", _coordinated_sender, _coordinated_receiver, "pull",
    "Optimize shuffle bandwidth on NUMA nodes [21].",
    stream_sender=_streaming_pull_sender,
    stream_receiver=_streaming_coordinated_receiver))
register_template(ShuffleTemplate(
    "bruck", _bruck_sender, _bruck_receiver, "push",
    "Schedule flows to avoid single-process bottleneck [38]."))
register_template(ShuffleTemplate(
    "two_level", _two_level_sender, _two_level_receiver, "push",
    "Group small shuffles to reduce cost in the cloud [27].",
    rebalanceable=False))        # re-partitions en route; see ShuffleTemplate
register_template(ShuffleTemplate(
    "network_aware", _network_aware_sender, _push_receiver, "push/pull",
    "Adaptively shuffle data at data center scale (Figure 3).",
    stream_sender=_streaming_network_aware_sender,
    stream_receiver=_streaming_push_receiver))


# ---------------------------------------------------------------------------
# Plan driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShuffleResult:
    bufs: dict[int, Msgs]                 # per-destination received (and combined) data
    decisions: list                       # (level, EffCost) from adaptive templates
    stats: dict                           # ledger snapshot delta for this shuffle
    observed: dict = dataclasses.field(default_factory=dict)
    # ^ level -> measured reduction ratio (drift input for the plan cache)
    cached: bool = False                  # executed from a CompiledPlan?
    vectorized: bool = False              # executed on the batched data plane?
    repaired: bool = False                # plan came from resilience.repair?
    attempts: int = 1                     # execution attempts (>1 => recovered)
    recovery: dict | None = None          # restart/resume/speculation details
    streamed: bool = False                # ran as chunk-pipelined sub-epochs?
    engine: str = "threaded"              # which executor produced the bytes
    fallback_reason: str | None = None    # why the *requested* engine declined
    # ^ None when the requested engine ran; otherwise its decline code (e.g.
    #   "unsupported_combiner", "streamed_replay", "grid_mismatch") — see
    #   torchplan.decline_reason and vectorized.vectorize_decline.  Always the
    #   shuffle's OWN code, including for members of a batched dispatch that
    #   individually declined.  The full chain lives in the service's
    #   per-shuffle report (cluster.explain).
    batched: bool = False                 # member of one vmapped batch dispatch?


def aggregate_observed(per_worker: list[list[tuple]]) -> dict[str, float]:
    """Pool (level, pre_bytes, post_bytes) records into per-level reduction ratios."""
    pre: dict[str, int] = {}
    post: dict[str, int] = {}
    for records in per_worker:
        for level, p, q in records:
            pre[level] = pre.get(level, 0) + p
            post[level] = post.get(level, 0) + q
    return {lv: post[lv] / pre[lv] for lv in pre if pre[lv] > 0}


def skew_instantiate(ctx: WorkerContext, bufs_w: Msgs, template: ShuffleTemplate):
    """Skew-aware instantiation step (runs before the template's programs).

    With ``balance="auto"`` every participant contributes a heavy-hitter
    sketch + exact load vector to the skew rendezvous
    (:meth:`WorkerContext.GATHER_SKEW`); the broadcast
    :class:`~repro_torch.core.skew.SkewDecision` is recorded under the
    ``"rebalance"`` decision kind.  A cached run replays the plan's frozen
    decision instead — no sketching, no rendezvous.  When the decision
    triggered, the worker's effective partFunc becomes the hot-key-scattering
    wrapper, so every PART the template issues splits hot keys across their
    share destinations.
    """
    args = ctx.args
    if args.plan is not None:
        dec = args.plan.skew
    elif (args.balance == "auto" and args.comb_fn is not None
          and len(args.dsts) > 1 and template.rebalanceable):
        stats = local_skew_stats(
            bufs_w if ctx.wid in args.srcs else Msgs.empty(),
            args.part_fn, len(args.dsts))
        dec = ctx.GATHER_SKEW(stats)
        ctx.decisions.append(("rebalance", dec))
    else:
        dec = None
    if dec is not None and dec.triggered:
        ctx.part_fn = scatter_part_fn(args.part_fn, dec)
    return dec


def owner_merge(ctx: WorkerContext, out: Msgs, decision) -> Msgs:
    """The final stage of a rebalanced shuffle: every destination forwards the
    (already combined) rows of hot keys it holds for *other* owners; each
    owner combines its own rows with its sharers' contributions.  One row per
    (hot key, sharer) moves — negligible bytes against the imbalance removed.
    Deterministic send/receive order (sorted owners, sorted sharers) keeps the
    output byte-identical to the vectorized replay.
    """
    merge = owner_merge_plan(decision, ctx.args.part_fn, ctx.args.dsts)
    wid = ctx.wid
    for owner, (owned_keys, sharers) in merge.items():
        if owner == wid or wid not in sharers:
            continue
        mask = np.isin(out.keys, owned_keys)
        rows = out.take(np.nonzero(mask)[0])
        out = out.take(np.nonzero(~mask)[0])
        ctx.SEND(owner, rows)
    if wid in merge:
        _, sharers = merge[wid]
        got = [ctx.RECV(s) for s in sharers]
        out = ctx.COMB([out] + got)
    return out


def run_shuffle(
    cluster: LocalCluster,
    args: ShuffleArgs,
    bufs: dict[int, Msgs],
    manager=None,
) -> ShuffleResult:
    """Execute one shuffle invocation across the cluster; returns per-dst buffers.

    Mirrors §3.3: each worker's shuffle call records start/end with the manager (the
    template/plan cache lives there too); sender+receiver programs run per worker.
    When ``args.plan`` carries a CompiledPlan, adaptive templates replay its frozen
    decisions instead of re-instantiating (see :mod:`repro_torch.core.plancache`).

    When ``args.stream`` carries a ChunkPlan and the template is streamable,
    this is the *streaming driver*: workers run the template's chunk-pipelined
    program rewrites, and the global barrier is replaced by the end-of-stream
    rendezvous that closes the pipelined epoch.  A skew-rebalanced run falls
    back to the barrier programs uniformly (every participant sees the same
    broadcast decision): the hot-key scatter is positional over the *whole*
    buffer and the owner-merge is a barrier-shaped stage, so chunk slicing
    would change where scattered rows land.
    """
    template = (manager.get_template(args.template_id, wid=None) if manager
                else TEMPLATES[args.template_id])
    participants = sorted(set(args.srcs) | set(args.dsts))
    rc = args.recovery
    attempt = rc.attempt if rc is not None else 0
    speculated = rc.speculated if rc is not None else frozenset()
    served = (frozenset(getattr(rc, "store_served", ()) or ())
              if rc is not None else frozenset())
    if served:
        # store-served pure senders run nothing at all on this attempt (their
        # partitions are read back from the shuffle store), so they record no
        # start/end/stage — the journal evidence that they did not re-execute
        participants = [w for w in participants
                        if w in args.dsts or w not in served]
    may_stream = args.stream is not None and template.streamable
    before = cluster.ledger.snapshot()

    def worker_fn(wid: int):
        if manager is not None:
            manager.record_start(wid, args.shuffle_id, args.template_id,
                                 attempt=attempt, tenant=args.tenant)
        delay = cluster.worker_delays.get(wid, 0.0)
        if delay and wid not in speculated:
            # a speculated straggler's work races a backup copy on a healthy
            # peer; the backup wins, so the injected delay never materializes
            time.sleep(delay)
        ctx = WorkerContext(cluster, wid, args)
        out = None
        try:
            skew_dec = skew_instantiate(ctx, bufs.get(wid, Msgs.empty()),
                                        template)
            streamed = may_stream and not (skew_dec is not None
                                           and skew_dec.triggered)
            sender = template.stream_sender if streamed else template.sender
            receiver = template.stream_receiver if streamed else template.receiver
            if wid in args.srcs and wid not in served:
                sender(ctx, bufs.get(wid, Msgs.empty()))
            if wid in args.dsts:
                out = receiver(ctx)
                if skew_dec is not None and skew_dec.triggered:
                    out = owner_merge(ctx, out, skew_dec)
            if streamed:
                # end-of-stream rendezvous: the lightweight replacement for
                # the global barrier — closes the pipelined epoch
                ctx.STREAM_EOS("global", len(participants))
        except ShuffleAborted:
            # exited without delivering: peers blocked on this worker must not
            # wait out their RPC timeout for data that will never come
            cluster.mark_unreachable(args.shuffle_id, wid)
            raise
        if manager is not None:
            manager.record_end(wid, args.shuffle_id, args.template_id,
                               attempt=attempt, tenant=args.tenant)
        return (out, ctx.decisions, ctx.observed, streamed)

    try:
        with cluster.obs.tracer.span(
                "exec", shuffle_id=args.shuffle_id, tenant=args.tenant,
                engine="threaded", template=args.template_id,
                cached=args.plan is not None, attempt=attempt):
            raw = cluster.run_workers(participants, worker_fn,
                                      abort_event=cluster.abort_event(args.shuffle_id))
    except BaseException:
        cluster.end_shuffle(args.shuffle_id, aborted=True,
                            participants=participants)
        raise
    if args.storage is not None and args.storage.persist:
        # write-behind barrier: spill charges land before the after-snapshot
        args.storage.store.flush(args.shuffle_id)
    cluster.ledger.advance_epoch()        # any non-streamed residue is a barrier
    cluster.end_shuffle(args.shuffle_id)  # free per-invocation control state
    after = cluster.ledger.snapshot()
    stats = cluster.ledger.delta(before, after)
    out_bufs = {w: r[0] for w, r in raw.items() if r is not None and r[0] is not None}
    if args.plan is not None:
        # replayed runs report the plan's frozen verdicts: on a recovery attempt
        # no single worker re-walks every level, so per-worker lists are partial
        decisions = list(args.plan.decisions)
    else:
        # longest list wins: a dst-only participant records just the rebalance
        # verdict, while srcs record rebalance + every hierarchy level
        decisions = max((r[1] for r in raw.values() if r is not None),
                        key=len, default=[])
    observed = aggregate_observed([r[2] for r in raw.values() if r is not None])
    streamed = any(r[3] for r in raw.values() if r is not None)
    return ShuffleResult(bufs=out_bufs, decisions=decisions, stats=stats,
                         observed=observed, cached=args.plan is not None,
                         streamed=streamed)
