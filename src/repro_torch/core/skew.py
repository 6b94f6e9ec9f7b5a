"""Workload-skew statistics: heavy-hitter sketches and hot-key rebalancing.

Partition-aware sampling (:mod:`repro_torch.core.sampling`) estimates one scalar — the
combiner's reduction ratio.  A Zipf-skewed key distribution breaks a different
invariant: hash partitioning sends every message of the hottest key to one
destination, so the shuffle's completion time is gated on a single receiver no
matter how good the combine decision was.  This module makes that skew a
first-class sampled statistic and gives instantiation a lever to act on it.

Per worker, one O(n) pass produces a :class:`LocalSkewStats`:

* a **Misra–Gries heavy-hitter sketch** (:class:`HeavyHitterSketch`) of the
  worker's keys — bounded memory (``capacity`` counters), with the classic
  guarantee that any key whose true count exceeds ``total / capacity`` is
  present and undercounted by at most ``total / capacity``.  Within the scanned
  group the counts are exact, so the estimate stays unbiased the same way the
  sampled reduction ratio r̂ does;
* the **exact per-destination load vector** under the shuffle's own partition
  function (one ``bincount`` over the base slot assignment).

Unlike the r̂ estimator — which must ship raw message tuples, making the
sampling *rate* the cost lever — a sketch ships ``O(capacity)`` counters no
matter how much data it scanned, so the default scans everything and only the
local pass costs CPU.  Workers ship their stats to the skew rendezvous
(``WorkerContext.GATHER_SKEW``), where sketches are merged (a Misra–Gries
merge keeps the error bound) and :func:`plan_rebalance` decides:

* if the estimated ``max / mean`` destination load is within
  ``threshold`` — no rebalance; the plan records the estimate anyway so the
  plan cache can detect load drift on replays;
* otherwise, each hot key (count ≥ ``HOT_KEY_FRACTION`` of the mean
  destination load) is **split** across the currently least-loaded
  destinations — enough shares that each carries at most
  ``SPLIT_TARGET_FRACTION`` of the mean — and a final **owner-merge** stage
  forwards every share's combined rows to the key's original owner, which
  combines once more.  The merge moves one combined row per (key, sharer),
  so its traffic is negligible next to the imbalance it removes.

The split is *positional*: a partition function maps keys to slots, so two
messages with the same hot key can only reach different destinations if the
assignment also depends on the message's position in the buffer
(:func:`scatter_part_fn` cycles each hot key's occurrences through its share
slots).  That keeps the scatter a pure function of the buffer — identical on
the threaded reference executor and the batched replay, which is what lets
rebalanced :class:`~repro_torch.core.plancache.CompiledPlan`\\ s keep the
byte-identical vectorized contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .messages import Msgs, PartFn

# A key is "hot" when its estimated count reaches this fraction of the mean
# per-destination load; splits size shares to at most SPLIT_TARGET_FRACTION of
# the mean, so post-rebalance no single key dominates any destination.
HOT_KEY_FRACTION = 0.25
SPLIT_TARGET_FRACTION = 0.25
# max/mean estimated destination load above which instantiation rebalances.
DEFAULT_SKEW_THRESHOLD = 1.5
# Misra-Gries counters per sketch.  Detection is guaranteed for keys heavier
# than total/capacity; with <= 64 destinations the hot threshold
# (HOT_KEY_FRACTION * total/ndst) sits well above that floor.
DEFAULT_SKETCH_CAPACITY = 256
# Adaptive capacity bounds (see adaptive_sketch_capacity).
MIN_SKETCH_CAPACITY = 64
MAX_SKETCH_CAPACITY = 4096


def adaptive_sketch_capacity(max_key: int, ndst: int) -> int:
    """Size a sketch from the observed key-space bucket instead of a constant.

    Two guarantees drive the bounds:

    * **detection floor** — a key is "hot" at ``HOT_KEY_FRACTION * total/ndst``
      messages; Misra–Gries guarantees presence for keys above
      ``total/capacity``, so ``capacity >= ndst / HOT_KEY_FRACTION`` keeps
      every hot key detectable no matter how many destinations the shuffle
      fans out to (the static 256 silently lost this above 64 destinations);
    * **error scaling** — the undercount bound is (at worst) proportional to
      the mass the compression discards, which grows with the number of
      distinct keys.  Scaling capacity with the square root of the key
      universe (the log2 bucket the stats signature already computes) keeps
      the bound useful for giant key spaces without overpaying on small ones:
      a universe that fits the capacity outright is summarized *exactly*.

    The merge bound is unaffected: merged sketches take the larger capacity
    and add error bounds, so pooling workers with different observed key
    ranges keeps the classic Misra–Gries guarantee over the pooled stream.
    """
    detect_floor = int(np.ceil(ndst / HOT_KEY_FRACTION))
    universe_bits = max(0, int(max_key).bit_length())
    sqrt_universe = 1 << ((universe_bits + 1) // 2)
    return min(MAX_SKETCH_CAPACITY,
               max(MIN_SKETCH_CAPACITY, detect_floor, sqrt_universe))


class HeavyHitterSketch:
    """Misra–Gries summary of a key stream: ``capacity`` (key, count) pairs.

    ``counts[k]`` undercounts the true frequency by at most ``error_bound``
    (= the largest count discarded by compression), and every key with true
    count > ``total / capacity`` is guaranteed present.  Built vectorized
    (exact unique counts, then compressed), which is the standard equivalent
    of streaming Misra–Gries for an in-memory batch.
    """

    __slots__ = ("capacity", "counts", "total", "error_bound")

    def __init__(self, capacity: int = DEFAULT_SKETCH_CAPACITY,
                 counts: dict[int, int] | None = None, total: int = 0,
                 error_bound: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self.counts = dict(counts or {})
        self.total = int(total)
        self.error_bound = int(error_bound)

    # ---- construction --------------------------------------------------------
    @staticmethod
    def from_keys(keys: np.ndarray,
                  capacity: int = DEFAULT_SKETCH_CAPACITY) -> "HeavyHitterSketch":
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return HeavyHitterSketch(capacity)
        uniq, cnt = np.unique(keys, return_counts=True)
        sk = HeavyHitterSketch(capacity, total=int(keys.size))
        sk._compress(uniq, cnt)
        return sk

    def _compress(self, uniq: np.ndarray, cnt: np.ndarray) -> None:
        """Keep the ``capacity`` heaviest keys; subtract the weight of the
        heaviest *discarded* key from the survivors (the Misra–Gries decrement,
        so stored counts remain under-estimates with a known bound)."""
        if uniq.size <= self.capacity:
            self.counts = {int(k): int(c) for k, c in zip(uniq, cnt)}
            return
        order = np.lexsort((uniq, -cnt))          # by count desc, key asc (ties)
        kept, dropped = order[:self.capacity], order[self.capacity]
        dec = int(cnt[dropped])
        self.error_bound += dec
        self.counts = {int(uniq[i]): int(cnt[i]) - dec
                       for i in kept if int(cnt[i]) > dec}

    # ---- merge ---------------------------------------------------------------
    def merge(self, other: "HeavyHitterSketch") -> "HeavyHitterSketch":
        """Pool two sketches (the skew rendezvous' reduction).  Summed counts,
        re-compressed to ``capacity``; error bounds add, preserving the
        guarantee over the pooled stream."""
        merged: dict[int, int] = dict(self.counts)
        for k, c in other.counts.items():
            merged[k] = merged.get(k, 0) + c
        out = HeavyHitterSketch(max(self.capacity, other.capacity),
                                total=self.total + other.total,
                                error_bound=self.error_bound + other.error_bound)
        if merged:
            uniq = np.fromiter(merged.keys(), dtype=np.int64, count=len(merged))
            cnt = np.fromiter(merged.values(), dtype=np.int64, count=len(merged))
            out._compress(uniq, cnt)
        return out

    # ---- queries -------------------------------------------------------------
    def top(self, k: int | None = None) -> list[tuple[int, int]]:
        """(key, count) pairs, heaviest first, deterministic tie order."""
        items = sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return items if k is None else items[:k]

    @property
    def nbytes(self) -> int:
        # 8B key + 8B count per counter: what the skew rendezvous ships.
        return 16 * len(self.counts)

    def __len__(self) -> int:
        return len(self.counts)


@dataclasses.dataclass(frozen=True)
class LocalSkewStats:
    """One worker's contribution to the skew rendezvous."""

    sketch: HeavyHitterSketch
    slot_loads: tuple[int, ...]     # exact message counts per destination slot
    total: int                      # messages scanned

    @property
    def nbytes(self) -> int:
        return self.sketch.nbytes + 8 * len(self.slot_loads)


def local_skew_stats(msgs: Msgs, part_fn: PartFn, ndst: int,
                     capacity: int | None = None) -> LocalSkewStats:
    """The per-worker O(n) pass: sketch + exact base-assignment load vector.

    ``capacity=None`` sizes the sketch adaptively from this worker's observed
    key range and the fan-out (:func:`adaptive_sketch_capacity`)."""
    if msgs.n == 0:
        return LocalSkewStats(
            HeavyHitterSketch(capacity if capacity is not None
                              else adaptive_sketch_capacity(0, ndst)),
            (0,) * ndst, 0)
    if capacity is None:
        capacity = adaptive_sketch_capacity(int(msgs.keys.max()), ndst)
    slots = part_fn.assign(msgs.keys, ndst)
    loads = np.bincount(slots, minlength=ndst)
    return LocalSkewStats(HeavyHitterSketch.from_keys(msgs.keys, capacity),
                          tuple(int(x) for x in loads), msgs.n)


def merge_skew_stats(stats: list[LocalSkewStats]) -> tuple[HeavyHitterSketch, np.ndarray]:
    """Pool all workers' stats: merged sketch + summed exact slot loads."""
    if not stats:
        return HeavyHitterSketch(), np.zeros(0, dtype=np.int64)
    sketch = stats[0].sketch
    loads = np.asarray(stats[0].slot_loads, dtype=np.int64)
    for s in stats[1:]:
        sketch = sketch.merge(s.sketch)
        loads = loads + np.asarray(s.slot_loads, dtype=np.int64)
    return sketch, loads


def imbalance(loads: np.ndarray) -> float:
    """max/mean of a load vector; 1.0 is perfectly balanced (or empty)."""
    loads = np.asarray(loads, dtype=np.float64)
    if loads.size == 0 or loads.sum() <= 0:
        return 1.0
    return float(loads.max() / loads.mean())


# ---------------------------------------------------------------------------
# The rebalance decision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SkewDecision:
    """The frozen verdict of skew-aware instantiation (the ``"rebalance"``
    decision kind in ``ShuffleResult.decisions``).

    ``splits`` maps each hot key to the tuple of destination *slots* its
    messages cycle through (slot = index into the shuffle's ``dsts``, the same
    space partition functions assign into).  Empty ``splits`` means the
    estimated imbalance stayed under ``threshold`` — the estimate itself is
    still kept for load-drift detection.  The merged ``sketch`` is frozen so
    plan repair can re-derive the splits against a different destination set
    (e.g. after a worker is excised) without re-sampling.
    """

    ndst: int
    threshold: float
    est_imbalance: float            # max/mean estimated loads, before rebalance
    est_balanced_imbalance: float   # ... after the planned splits
    top_share: float                # heaviest key's share of scanned messages
    splits: tuple[tuple[int, tuple[int, ...]], ...]
    sketch: HeavyHitterSketch

    @property
    def triggered(self) -> bool:
        return bool(self.splits)

    @property
    def beneficial(self) -> bool:
        # duck-type EffCost for decision-list consumers (bench reporting)
        return self.triggered

    def split_keys(self) -> np.ndarray:
        return np.asarray([k for k, _ in self.splits], dtype=np.int64)


def estimate_slot_loads(sketch: HeavyHitterSketch, part_fn: PartFn,
                        ndst: int) -> np.ndarray:
    """Per-slot load estimate from a sketch alone (no exact bincount in hand —
    the plan-repair path, where the destination set changed after freezing).
    Sketched keys are assigned exactly; the residual mass is spread uniformly
    (it is the long tail, which hashing spreads by construction)."""
    loads = np.zeros(ndst, dtype=np.float64)
    residual = max(0, sketch.total - sum(sketch.counts.values()))
    loads += residual / max(1, ndst)
    if sketch.counts:
        keys = np.fromiter(sketch.counts.keys(), dtype=np.int64,
                           count=len(sketch.counts))
        cnts = np.fromiter(sketch.counts.values(), dtype=np.float64,
                           count=len(sketch.counts))
        np.add.at(loads, part_fn.assign(keys, ndst), cnts)
    return loads


def plan_rebalance(sketch: HeavyHitterSketch, slot_loads: np.ndarray,
                   part_fn: PartFn, ndst: int, *,
                   threshold: float = DEFAULT_SKEW_THRESHOLD) -> SkewDecision:
    """Decide which hot keys to split, and across which slots.

    Greedy water-filling: hot keys (heaviest first) are pulled out of their
    owner slot and split into ``ceil(count / (SPLIT_TARGET_FRACTION * mean))``
    shares placed on the currently least-loaded slots, so the estimated
    post-rebalance imbalance approaches 1.  Fully deterministic (stable sorts,
    index tie-breaks): every participant of the rendezvous — and every replay
    of the frozen plan — derives the same scatter.
    """
    slot_loads = np.asarray(slot_loads, dtype=np.float64)
    total = float(slot_loads.sum())
    est_imb = imbalance(slot_loads)
    top = sketch.top(1)
    top_share = (top[0][1] / sketch.total) if top and sketch.total else 0.0
    no_op = SkewDecision(ndst=ndst, threshold=threshold, est_imbalance=est_imb,
                         est_balanced_imbalance=est_imb, top_share=top_share,
                         splits=(), sketch=sketch)
    if ndst < 2 or total <= 0 or est_imb <= threshold:
        return no_op
    mean = total / ndst
    hot = [(k, c) for k, c in sketch.top() if c >= HOT_KEY_FRACTION * mean]
    if not hot:
        return no_op
    loads = slot_loads.copy()
    hot_keys = np.asarray([k for k, _ in hot], dtype=np.int64)
    owners = part_fn.assign(hot_keys, ndst)
    splits: list[tuple[int, tuple[int, ...]]] = []
    for (k, c), owner in zip(hot, owners):
        loads[owner] -= min(c, loads[owner])     # sketch may undercount
        m = int(np.ceil(c / max(1.0, SPLIT_TARGET_FRACTION * mean)))
        m = max(2, min(ndst, m))
        share = np.argsort(loads, kind="stable")[:m]   # least-loaded, index ties
        loads[share] += c / m
        splits.append((int(k), tuple(sorted(int(s) for s in share))))
    return SkewDecision(ndst=ndst, threshold=threshold, est_imbalance=est_imb,
                        est_balanced_imbalance=imbalance(loads),
                        top_share=top_share,
                        splits=tuple(sorted(splits)), sketch=sketch)


# ---------------------------------------------------------------------------
# Acting on the decision: scatter + owner merge
# ---------------------------------------------------------------------------

def scatter_part_fn(base: PartFn, decision: SkewDecision) -> PartFn:
    """Wrap ``base`` so each hot key's messages cycle through its share slots.

    Only assignments into the decision's own slot space (``ndst ==
    decision.ndst``) are scattered; any other width (an adaptive template's
    *local* exchange over a neighbor group) passes through untouched.  The
    cycle position is the occurrence index within the assigned buffer, so the
    wrapped function stays a pure function of ``keys`` — deterministic across
    executors and replays.
    """
    if not decision.triggered:
        return base
    split_keys = decision.split_keys()                  # sorted by key
    shares = {k: np.asarray(s, dtype=np.int64) for k, s in decision.splits}

    def assign(keys: np.ndarray, ndst: int) -> np.ndarray:
        slots = base.assign(keys, ndst)
        if ndst != decision.ndst:
            return slots
        hot = np.nonzero(np.isin(keys, split_keys))[0]  # one pass over the buffer
        if not hot.size:
            return slots
        slots = np.array(slots, copy=True)
        # group the hot positions by key (stable: buffer order survives within
        # each key, which is what defines the cycle position), then cycle each
        # key's occurrences through its share slots
        order = hot[np.argsort(keys[hot], kind="stable")]
        bounds = np.searchsorted(keys[order], split_keys)
        for i, k in enumerate(split_keys):
            lo = bounds[i]
            hi = bounds[i + 1] if i + 1 < split_keys.size else order.size
            if lo < hi:
                share = shares[int(k)]
                slots[order[lo:hi]] = share[np.arange(hi - lo) % share.size]
        return slots

    return PartFn(f"{base.name}+skew", assign)


def scatter_tables(decision: SkewDecision) -> tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """The scatter as dense arrays for a traced replay: sorted hot keys
    ``[H]`` (int64), a zero-padded share-slot table ``[H, S]`` (int32, rows
    aligned with the hot keys), and per-key share counts ``[H]`` (int32).
    A hot row's destination is ``share[key_row, occurrence % count]`` — the
    same occurrence cycle :func:`scatter_part_fn` applies positionally."""
    keys = decision.split_keys()
    shares = [np.asarray(s, dtype=np.int32) for _, s in decision.splits]
    width = max((s.size for s in shares), default=1)
    table = np.zeros((keys.size, width), np.int32)
    counts = np.zeros((keys.size,), np.int32)
    for i, s in enumerate(shares):
        table[i, :s.size] = s
        counts[i] = s.size
    return keys, table, counts


def owner_merge_plan(decision: SkewDecision, part_fn: PartFn,
                     dsts: tuple[int, ...]) -> dict[int, tuple[np.ndarray, tuple[int, ...]]]:
    """owner wid -> (owned hot keys, sharer wids) for the final merge stage.

    The owner of a hot key is its *base* destination (what ``part_fn`` alone
    would pick); sharers are every other destination the key was scattered to.
    Sorted, so the threaded executor's SEND/RECV order and the vectorized
    replay's concat order agree row for row.
    """
    if not decision.triggered:
        return {}
    keys = decision.split_keys()
    owner_slots = part_fn.assign(keys, len(dsts))
    by_owner: dict[int, tuple[list[int], set[int]]] = {}
    for (k, share), os in zip(decision.splits, owner_slots):
        owner = dsts[int(os)]
        ks, sharers = by_owner.setdefault(owner, ([], set()))
        ks.append(k)
        sharers.update(dsts[s] for s in share)
    return {o: (np.asarray(sorted(ks), dtype=np.int64),
                tuple(sorted(sharers - {o})))
            for o, (ks, sharers) in sorted(by_owner.items())}
