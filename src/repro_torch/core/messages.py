"""Message batches, partition functions and combiners — the data model of a shuffle.

A shuffle moves *messages*: ``(key, value)`` records batched as flat arrays.  The key
identifies the logical destination (a vertex id, a reduce key, an expert id); the value
is an arbitrary fixed-width payload.  ``partFunc`` maps keys to destination workers;
``combFunc`` is a commutative+associative reduction applied to values sharing a key.

Everything here is NumPy (the local simulated-cluster backend); the device
analogues of PART/COMB live in :mod:`repro_torch.kernels` (CUDA).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

# ---------------------------------------------------------------------------
# Deterministic 64-bit mixing hash (splitmix64) — identical in numpy and torch.
# ---------------------------------------------------------------------------

_SPLITMIX_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = np.uint64(0x94D049BB133111EB)
_SPLITMIX_INC = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized splitmix64; uniform over uint64 for any integer input."""
    seed_term = np.uint64((int(seed) * 0x9E3779B97F4A7C15 + 0x9E3779B97F4A7C15)
                          & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + seed_term
        z = (z ^ (z >> np.uint64(30))) * _SPLITMIX_C1
        z = (z ^ (z >> np.uint64(27))) * _SPLITMIX_C2
        return z ^ (z >> np.uint64(31))


# ---------------------------------------------------------------------------
# Message batches
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Msgs:
    """A batch of (key, value) messages. ``vals`` is ``[n, d]`` (d = payload width)."""

    keys: np.ndarray   # int64 [n]
    vals: np.ndarray   # float64 [n, d]

    def __post_init__(self) -> None:
        self.keys = np.asarray(self.keys, dtype=np.int64)
        self.vals = np.asarray(self.vals, dtype=np.float64)
        if self.vals.ndim == 1:
            self.vals = self.vals[:, None]
        if self.keys.shape[0] != self.vals.shape[0]:
            raise ValueError(f"keys/vals length mismatch: {self.keys.shape} {self.vals.shape}")

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def width(self) -> int:
        return int(self.vals.shape[1])

    @property
    def nbytes(self) -> int:
        # 8B key + 8B per payload column — the wire format the cost model charges.
        return self.n * (8 + 8 * self.width)

    @staticmethod
    def empty(width: int = 1) -> "Msgs":
        return Msgs(np.empty((0,), np.int64), np.empty((0, width), np.float64))

    @staticmethod
    def concat(batches: list["Msgs"]) -> "Msgs":
        present = [b for b in batches if b is not None]
        nonempty = [b for b in present if b.n > 0]
        if not nonempty:
            # An all-empty concat must still carry the payload width of its
            # inputs: collapsing to width 1 breaks byte accounting (nbytes
            # charges per column) and makes the result un-concatenable with
            # the real batches that arrive later.
            return Msgs.empty(max((b.width for b in present), default=1))
        return Msgs(np.concatenate([b.keys for b in nonempty]),
                    np.concatenate([b.vals for b in nonempty]))

    def take(self, idx: np.ndarray) -> "Msgs":
        return Msgs(self.keys[idx], self.vals[idx])

    def copy(self) -> "Msgs":
        """Deep copy — hand a shuffle its own buffers without aliasing yours."""
        return Msgs(self.keys.copy(), self.vals.copy())


# ---------------------------------------------------------------------------
# Combiners (combFunc): commutative + associative reductions over equal keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Combiner:
    """Named so both backends (numpy here, torch/CUDA in kernels) agree on semantics."""

    name: str
    binary: Callable[[np.ndarray, np.ndarray], np.ndarray]
    ufunc: np.ufunc
    order_sensitive: bool = False
    # ^ does the reduction *tree shape* change the result bits?  Float addition
    #   does (rounding differs by association), so SUM must reduce as an
    #   explicit sequential left fold.  min/max return their first operand on
    #   ties, so any order-preserving tree — including reduceat's pairwise
    #   blocks — yields the leftmost element bit-for-bit and can keep the
    #   fast reduceat path.

    def __call__(self, msgs: Msgs) -> Msgs:
        """Combine all messages sharing a key into one message.

        Stable sort by key, then a reduction over each key's rows that is
        *decomposable across arbitrary buffer boundaries*: reducing a
        concatenation equals reducing its pieces in order.  That property is
        what lets the streaming executor combine chunk-by-chunk into a
        running accumulator and stay *byte-identical* to the one-shot barrier
        combine (the accumulator row sorts stably ahead of newly arrived rows
        of the same key, so each incremental combine is an exact continuation
        of the reduction).

        Order-insensitive combiners (min/max) use ``reduceat``.  For
        ``order_sensitive`` ones (SUM) — where ``reduceat``'s pairwise tree
        would make the result depend on segment length — the segment is
        seeded with its first row and the rest fold in element order via
        ``ufunc.at`` (unbuffered, applied in sequence): an explicit
        sequential left fold.
        """
        if msgs.n == 0:
            return msgs
        order = np.argsort(msgs.keys, kind="stable")
        keys = msgs.keys[order]
        vals = msgs.vals[order]
        uniq, starts = np.unique(keys, return_index=True)
        if not self.order_sensitive:
            return Msgs(uniq, self.ufunc.reduceat(vals, starts, axis=0))
        out = vals[starts].copy()          # fold seed: first row of each segment
        if keys.size > uniq.size:
            rest = np.ones(keys.size, dtype=bool)
            rest[starts] = False
            seg = np.searchsorted(uniq, keys[rest])
            self.ufunc.at(out, seg, vals[rest])
        return Msgs(uniq, out)


SUM = Combiner("sum", lambda a, b: a + b, np.add, order_sensitive=True)
MIN = Combiner("min", np.minimum, np.minimum)
MAX = Combiner("max", np.maximum, np.maximum)

COMBINERS = {c.name: c for c in (SUM, MIN, MAX)}


# ---------------------------------------------------------------------------
# Partition functions (partFunc): key -> destination slot
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartFn:
    """``assign(keys, ndst)`` returns the destination *slot* (0..ndst-1) per message."""

    name: str
    assign: Callable[[np.ndarray, int], np.ndarray]


def _hash_assign(keys: np.ndarray, ndst: int) -> np.ndarray:
    return (splitmix64(keys) % np.uint64(ndst)).astype(np.int64)


def _range_assign_factory(key_space: int) -> Callable[[np.ndarray, int], np.ndarray]:
    def assign(keys: np.ndarray, ndst: int) -> np.ndarray:
        per = -(-key_space // ndst)
        return np.minimum(keys // per, ndst - 1).astype(np.int64)
    return assign


HASH_PART = PartFn("hash", _hash_assign)   # the paper's default partFunc


def range_part(key_space: int) -> PartFn:
    return PartFn(f"range[{key_space}]", _range_assign_factory(key_space))


def partition(msgs: Msgs, dsts: list[int], part_fn: PartFn) -> dict[int, Msgs]:
    """PART: split ``msgs`` by destination worker id (the paper's Table-2 primitive).

    Fully batched: one stable argsort, one gather of keys/vals each, then
    ``np.split`` into contiguous per-destination views — no per-destination
    fancy-index copies (the old path re-gathered once per destination, which
    made PART O(n · ndst) memory traffic on the data plane's hottest loop).
    """
    if msgs.n == 0:
        return {d: Msgs.empty(max(1, msgs.width)) for d in dsts}
    slot = part_fn.assign(msgs.keys, len(dsts))
    order = np.argsort(slot, kind="stable")
    keys_sorted = msgs.keys[order]
    vals_sorted = msgs.vals[order]
    bounds = np.searchsorted(slot[order], np.arange(len(dsts) + 1))
    key_chunks = np.split(keys_sorted, bounds[1:-1])
    val_chunks = np.split(vals_sorted, bounds[1:-1])
    return {d: Msgs(key_chunks[i], val_chunks[i]) for i, d in enumerate(dsts)}
