"""Chunk-pipelined shuffle execution: the ChunkPlan and the continuous-ingest
stream session.

The barrier execution model runs a shuffle as one synchronized exchange: every
sender partitions and ships its whole buffer, every receiver blocks until all
of it arrived, then combines.  The streaming model decomposes the same exchange
into **chunked sub-epochs**: senders PART/SEND fixed-budget chunks while
receivers RECV and incrementally combine each chunk into a running
accumulator, and a lightweight end-of-stream rendezvous
(:meth:`~repro_torch.core.primitives.WorkerContext.STREAM_EOS`) replaces the global
barrier.  Modelled time then reflects sender/receiver overlap — the ledger
charges chunk-tagged transfers and combines into pipelined lanes and closes
the streamed epoch under ``max(X, C) + min(X, C)/nchunks`` instead of the BSP
sum ``X + C`` (see :class:`repro_torch.core.primitives.CostLedger`).

Byte-identity contract: a streamed shuffle produces *byte-identical* output to
the barrier path.  Three structural facts carry it, for any chunk size:

* partitioning is stable, so the concatenation of a buffer's chunk partitions
  equals the partition of the whole buffer, destination by destination;
* receivers fold streams in the same source order the barrier receiver
  concatenates in, and chunks within a stream arrive FIFO;
* the combiner's segment reduction is a sequential left fold
  (:class:`repro_torch.core.messages.Combiner`), so incrementally combining the
  accumulator with each arriving chunk is an exact continuation of the one
  fold the barrier combine performs.

This module holds the two pieces that are not worker programs: the
:class:`ChunkPlan` (the chunking policy, frozen into
:class:`~repro_torch.core.plancache.CompiledPlan` and keyed into the stats
signature) and the :class:`StreamSession` ``feed()``/``drain()`` API for
open-ended sources, where the total input is unknown up front and a barrier
would never close.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterator, Sequence

from .messages import Combiner, Msgs, PartFn, partition
from .tenancy import DEFAULT_TENANT

# Default per-chunk byte budget.  64 KiB keeps several chunks in flight for
# the bench/test workloads without drowning the simulated cluster in messages.
DEFAULT_CHUNK_BYTES = 64 * 1024
# Sender window: how many un-folded chunks the policy allows in flight.
# :class:`StreamSession` *enforces* it as backpressure — ``feed()`` never
# leaves more than this many chunks transferred-but-unfolded; excess chunks
# are spilled into the fold before the producer may continue.
DEFAULT_MAX_INFLIGHT = 4


def _log2_bucket(n: int) -> int:
    return int(n).bit_length()


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """The chunking policy of a streamed shuffle: fixed byte budget per chunk.

    Frozen into a :class:`~repro_torch.core.plancache.CompiledPlan` when the plan is
    compiled from a streamed run, so cached replays (threaded or vectorized)
    chunk exactly like the run the plan froze.  :meth:`signature` contributes
    the policy to the stats signature — plans never alias across streaming
    on/off or across chunk-budget buckets (byte-identity makes within-bucket
    aliasing safe: any chunking of the same data produces the same bytes).
    """

    chunk_bytes: int = DEFAULT_CHUNK_BYTES
    max_inflight: int = DEFAULT_MAX_INFLIGHT

    def __post_init__(self):
        if self.chunk_bytes < 1:
            raise ValueError(f"chunk_bytes must be >= 1: {self.chunk_bytes}")
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1: {self.max_inflight}")

    def rows_per_chunk(self, width: int) -> int:
        """Rows fitting the byte budget at this payload width (>= 1: a chunk
        always makes progress even when one row exceeds the budget)."""
        return max(1, self.chunk_bytes // (8 + 8 * max(1, width)))

    def nchunks(self, msgs: Msgs) -> int:
        """Chunks needed for ``msgs``.  An empty buffer still yields one
        (empty) chunk so the stream carries the payload width end to end —
        exactly like the empty partitions the barrier path ships."""
        rows = self.rows_per_chunk(msgs.width)
        return max(1, -(-msgs.n // rows))

    def chunk(self, msgs: Msgs, c: int) -> Msgs:
        """Chunk ``c``: rows ``[c*R, (c+1)*R)`` in buffer order (zero-copy
        views; the last chunk is ragged)."""
        rows = self.rows_per_chunk(msgs.width)
        return Msgs(msgs.keys[c * rows:(c + 1) * rows],
                    msgs.vals[c * rows:(c + 1) * rows])

    def chunks(self, msgs: Msgs) -> Iterator[Msgs]:
        for c in range(self.nchunks(msgs)):
            yield self.chunk(msgs, c)

    def signature(self) -> tuple:
        """Stats-signature component: streaming on, chunk-budget bucket, window."""
        return ("stream", _log2_bucket(self.chunk_bytes), self.max_inflight)


# ---------------------------------------------------------------------------
# Continuous ingest: feed()/drain()
# ---------------------------------------------------------------------------

class StreamSession:
    """An open-ended streamed shuffle: feed source buffers as they arrive,
    drain the combined per-destination accumulators when the source ends.

    This is the native path for continuous-ingest workloads the barrier model
    has no answer for: the total input is unbounded, so there is no point at
    which a barrier could close, yet the per-destination state stays bounded —
    every ``feed()`` is partitioned and *incrementally combined* into the
    running accumulators, and the ledger charges it as chunked sub-epochs of
    one long streamed exchange (``drain()`` is the end-of-stream that closes
    it).

    Determinism: feeds are folded in arrival order (sources in sorted order
    within each feed), so a session's drained output equals a one-shot
    streamed shuffle of the concatenated feeds fed in the same order.

    **Backpressure.**  The :class:`ChunkPlan`'s ``max_inflight`` is *enforced*,
    not merely modelled: a transferred chunk sits in the inflight window until
    it is folded, and ``feed()`` refuses to run ahead — the moment the window
    is full, the producer is held while the oldest inflight chunks are spilled
    into the destination fold (the synchronous analogue of blocking on the
    receiver).  ``inflight`` never exceeds ``max_inflight``;
    ``backpressure_stalls`` counts how often the producer was held.

    Obtained via :meth:`repro_torch.core.service.TenantClient.open_stream` (or the
    single-tenant facade's ``TeShuService.open_stream``).
    """

    def __init__(self, cluster, manager, template, shuffle_id: int,
                 srcs: Sequence[int], dsts: Sequence[int], part_fn: PartFn,
                 comb_fn: Combiner | None, chunk_plan: ChunkPlan,
                 tenant: str = DEFAULT_TENANT, storage=None):
        self.cluster = cluster
        self.storage = storage
        # ^ storage.StorageContext when the storage knob is "spill"/"durable":
        #   a full window spills its oldest chunk to the shuffle store instead
        #   of folding early, so feed() can exceed aggregate memory while the
        #   drained folds stay bitwise-identical (restores replay the exact
        #   arrival order the fold contract requires).
        self.manager = manager
        self.template = template
        self.shuffle_id = shuffle_id
        self.srcs = tuple(srcs)
        self.dsts = tuple(dsts)
        self.part_fn = part_fn
        self.comb_fn = comb_fn
        self.chunk_plan = chunk_plan
        self.tenant = tenant
        # pull templates charge transfers to the receiver (it pays the wait)
        self.receiver_pays = template.mode == "pull"
        self.acc: dict[int, Msgs | None] = {d: None for d in self.dsts}
        self.chunks_fed = 0
        self.rows_fed = 0
        self.closed = False
        # inflight window: (chunk, src, parts) transferred but not yet folded,
        # oldest first
        self._inflight: collections.deque[tuple[int, int, dict[int, Msgs]]] = \
            collections.deque()
        # chunks spilled to the store, in fold (arrival) order: always a
        # contiguous prefix of the chunk sequence, strictly older than
        # anything still in the window
        self._spilled: list[tuple[int, int]] = []
        self.spilled_chunks = 0
        self.backpressure_stalls = 0
        self.max_inflight_observed = 0
        self._participants = sorted(set(self.srcs) | set(self.dsts))
        self._before = cluster.ledger.snapshot()
        if manager is not None:
            for w in self._participants:
                manager.record_start(w, shuffle_id, template.template_id,
                                     tenant=tenant)

    @property
    def inflight(self) -> int:
        """Chunks transferred but not yet folded (bounded by ``max_inflight``)."""
        return len(self._inflight)

    def _fold(self, dst: int, part: Msgs, chunk: int) -> None:
        acc = self.acc[dst]
        batch = part if acc is None else Msgs.concat([acc, part])
        if self.comb_fn is None:
            self.acc[dst] = batch
            return
        self.cluster.ledger.charge_combine(dst, part.nbytes, chunk=chunk,
                                           tenant=self.tenant)
        self.acc[dst] = self.comb_fn(batch)

    def _fold_oldest(self) -> None:
        c, _src, parts = self._inflight.popleft()
        for d in self.dsts:
            self._fold(d, parts[d], c)

    def _spill_oldest(self) -> bool:
        """Move the window's oldest chunk to the shuffle store.

        Returns ``False`` when the put was declined (tenant quota) — the
        caller then falls back to the fold-early backpressure path, so a
        quota'd stream degrades to pre-storage behavior instead of failing.
        """
        c, src, parts = self._inflight[0]
        st = self.storage
        if not st.store.put_parts(st.tenant, self.shuffle_id, "stream", src,
                                  parts, chunk=c):
            return False
        self._inflight.popleft()
        self._spilled.append((c, src))
        self.spilled_chunks += 1
        return True

    def feed(self, bufs: dict[int, Msgs]) -> int:
        """Ingest one batch of source buffers; returns the chunks streamed.

        Each source's buffer is cut into :class:`ChunkPlan` chunks; every
        chunk is partitioned, its transfers charged to the pipelined lanes,
        and its partitions enter the inflight window.  When the window would
        exceed ``max_inflight`` the producer stalls: the oldest chunks are
        folded into the destination accumulators (in exact arrival order, so
        the drained bytes never depend on the window size) until the new
        chunk fits.
        """
        if self.closed:
            raise RuntimeError("stream session already drained")
        obs = self.cluster.obs
        sp = obs.tracer.span(
            "stream_feed", shuffle_id=self.shuffle_id, tenant=self.tenant,
        ) if obs.tracer.enabled else None
        stalls_before = self.backpressure_stalls
        spilled_before = self.spilled_chunks
        ledger = self.cluster.ledger
        topo = self.cluster.topology
        fed = 0
        for w in sorted(bufs):
            if w not in self.srcs:
                raise ValueError(f"worker {w} is not a source of this stream")
            for piece in self.chunk_plan.chunks(bufs[w]):
                c = self.chunks_fed
                parts = partition(piece, list(self.dsts), self.part_fn)
                for d in self.dsts:
                    payer = d if self.receiver_pays else w
                    ledger.charge_transfer(payer, topo.crossing_level(w, d),
                                           parts[d].nbytes, dst=d, chunk=c,
                                           tenant=self.tenant)
                # spill BEFORE appending: the window never holds more than
                # max_inflight chunks, even transiently (a comb_fn running
                # during the spill observes the invariant too)
                if len(self._inflight) >= self.chunk_plan.max_inflight:
                    if self.storage is None or not self._spill_oldest():
                        self.backpressure_stalls += 1
                        while len(self._inflight) >= self.chunk_plan.max_inflight:
                            self._fold_oldest()
                self._inflight.append((c, w, parts))
                self.max_inflight_observed = max(self.max_inflight_observed,
                                                 len(self._inflight))
                self.chunks_fed += 1
                self.rows_fed += piece.n
                fed += 1
        stalled = self.backpressure_stalls - stalls_before
        spilled = self.spilled_chunks - spilled_before
        obs.metrics.counter(
            "teshu_stream_chunks_total",
            "Chunks streamed through StreamSession.feed()").inc(
                fed, tenant=self.tenant)
        if spilled:
            obs.metrics.counter(
                "teshu_storage_spilled_chunks_total",
                "Inflight chunks spilled to the shuffle store instead of "
                "folding early").inc(spilled, tenant=self.tenant)
        if stalled:
            obs.metrics.counter(
                "teshu_stream_backpressure_stalls_total",
                "feed() producer stalls (inflight window full)").inc(
                    stalled, tenant=self.tenant)
        if sp is not None:
            sp.end(chunks=fed, stalls=stalled, spilled=spilled,
                   inflight=len(self._inflight))
        return fed

    def drain(self) -> dict:
        """End-of-stream: close the streamed epoch and return the result.

        Returns ``{"bufs": per-dst Msgs, "stats": ledger delta, "chunks": n,
        "rows": n, "spilled": n}``.  The session cannot be fed afterwards.
        """
        if self.closed:
            raise RuntimeError("stream session already drained")
        tracer = self.cluster.obs.tracer
        sp = tracer.span(
            "stream_drain", shuffle_id=self.shuffle_id, tenant=self.tenant,
        ) if tracer.enabled else None
        self.closed = True
        st = self.storage
        if st is not None and self._spilled:
            # spilled chunks are strictly older than anything still in the
            # window: restoring and folding them first replays the exact
            # arrival order, so the folds are bitwise-identical to a session
            # that never spilled
            rsp = tracer.span(
                "spill", shuffle_id=self.shuffle_id, tenant=self.tenant,
                phase="restore") if tracer.enabled else None
            for c, src in self._spilled:
                for d in self.dsts:
                    blk = st.store.get_block(st.tenant, self.shuffle_id,
                                             "stream", src, d, chunk=c)
                    self._fold(d, blk if blk is not None else Msgs.empty(), c)
            if rsp is not None:
                rsp.end(chunks=len(self._spilled))
        while self._inflight:                 # flush the window
            self._fold_oldest()
        self.cluster.ledger.end_stream()
        if st is not None:
            # deterministic spill charges: drain whatever the write-behind
            # thread has not flushed yet before taking the after-snapshot
            st.store.flush(self.shuffle_id)
        after = self.cluster.ledger.snapshot()
        if self.manager is not None:
            for w in self._participants:
                self.manager.record_end(w, self.shuffle_id,
                                        self.template.template_id,
                                        tenant=self.tenant)
        width = max((m.width for m in self.acc.values() if m is not None),
                    default=1)
        bufs = {d: (m if m is not None else Msgs.empty(width))
                for d, m in self.acc.items()}
        if st is not None:
            st.store.drop(st.tenant, self.shuffle_id)
        if sp is not None:
            sp.end(chunks=self.chunks_fed, rows=self.rows_fed,
                   stalls=self.backpressure_stalls,
                   spilled=self.spilled_chunks)
        return {"bufs": bufs,
                "stats": self.cluster.ledger.delta(self._before, after),
                "chunks": self.chunks_fed, "rows": self.rows_fed,
                "spilled": self.spilled_chunks}
