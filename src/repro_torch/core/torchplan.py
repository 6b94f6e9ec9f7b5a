"""Plan replay on a torch device: a CompiledPlan as whole-tensor operations.

The port's counterpart of ``repro.core.jaxplan`` and the executor that the
service tries first on a cache hit (``executor="torch"``).  The threaded
path (:mod:`repro_torch.core.templates`) is the reference semantics; the
vectorized path (:mod:`repro_torch.core.vectorized`) replays a cached plan
as batched numpy.  This module replays the same frozen
:class:`~repro_torch.core.plancache.CompiledPlan` with torch tensors on the
replay's device (the card, unless the caller asked for the CPU).

Lowering model (the numpy half, carried over unchanged)
-------------------------------------------------------

:func:`lower_plan` extracts dense ``[levels, nworkers]`` routing tables from
the plan (group sizes, slot maps, fold ranks, the global receive order), so
template differences are data, not control flow.  ``bruck``'s log-round
piece routing is simulated symbolically at lower time (:func:`_bruck_sim`);
``two_level`` runs its own three-phase program.  The ledger replay
(:func:`_charge_bruck`, :func:`_charge_two_level` and the per-level charges
in :func:`_run_lowered`) re-issues the reference executors' exact
:class:`~repro_torch.core.primitives.CostLedger` charge sequence, so bytes
and modelled costs are identical across all executors.

The device half
---------------

All source buffers are stacked into flat tensors -- ``keys [N]`` int64,
``vals [N, d]`` float64, ``owner [N]`` -- and every primitive becomes a
whole-tensor operation:

* **PART** assigns each row a destination slot with the plan's partFunc
  (:func:`_slot_of`: splitmix64 hash or range, bit-for-bit in int64) and
  moves rows by one stable sort on a ``(destination, fold-rank)`` composite
  key, which reproduces the receiver's concat order exactly.
* **COMB** (:func:`_combine`) stable-sorts each owner's rows by key and
  folds equal-key rows with the ordered segmented fold kernel
  (:func:`repro_torch.kernels.ops.segmented_fold`): a float64 left fold in
  element order, bit-identical to :class:`~repro_torch.core.messages
  .Combiner`.  Combined-away rows are marked dead; row capacity stays ``N``.

The reference's ``lax.scan`` over levels is a Python loop over the ``L``
levels here.  The reference's trace cache (an LRU of jit instances) has no
counterpart: torch runs eagerly and traces nothing, so there is nothing to
cache or evict.

Skew-rebalanced plans freeze the hot-key scatter into the replay as static
tables (:func:`repro_torch.core.skew.scatter_tables`): :func:`_skew_slot`
gives each hot row its share slot from its occurrence index among
same-(owner, key) rows, the positional cycle of
:func:`~repro_torch.core.skew.scatter_part_fn`, and the final owner merge
replays Python-side, as in the vectorized executor.

Batched dispatch (:func:`prepare_batch`): same-signature submissions (same
spec, shapes and routing tables; the admission batcher groups them) run as
ONE program over the members' rows laid end to end.  A member index is the
most significant part of every sort key, so each member's rows stay in their
own block and come out in the order its solo run gives; the flow counts get
a leading member axis.  Each member's replay then consumes its slice and
charges its own tenant's ledger lanes exactly as a serial run would, with
the epoch barrier deferred until the whole batch settles.

The kernel plane: a SUM replay on the card re-folds its payloads with the
PART and COMB kernels (:func:`kernel_global_stage`, float32 accumulation);
routing, key sets and ledger charges always come from the exact program.
:func:`set_kernel_plane` overrides the default (on when the replay's device
is CUDA).  Skew-scattered replays keep exact payloads: the plane routes by
the base partFunc and would undo the scatter.

Decline conditions (the service falls back to the vectorized executor,
which may fall back to threaded) are the reference's call-time and
plan-shape codes, the skew ones included (``skew_shape_mismatch``,
``skew_group_collision``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..kernels import ops as kernel_ops
from .messages import Msgs
from .plancache import CompiledPlan, attach_lowering, get_lowering
from .primitives import LocalCluster, ShuffleArgs
from .skew import scatter_tables
from .templates import ShuffleResult, aggregate_observed
from .vectorized import VECTORIZABLE, owner_merge

# Every built-in template lowers: the four regular replays share the level
# loop of _replay_impl; bruck rides the same program behind a lower-time
# routing simulation; two_level runs its own three-phase program.
TORCH_TEMPLATES = frozenset(VECTORIZABLE | {"bruck", "two_level"})

_RANGE_NAME = re.compile(r"^range\[(\d+)\]$")
_TORCH_COMBINERS = ("sum", "min", "max")

# Sentinel attached to a plan whose lowering was attempted and refused, so
# repeated calls don't re-derive the refusal.
_DECLINED = object()


class _PlanSpec(NamedTuple):
    """Static half of the replay: the program's shape decisions."""

    template: str
    comb: str | None          # combiner name, or None (concat only)
    part: tuple               # ("hash",) | ("range", key_space)
    initial_comb: bool        # network_aware combines locally before stage 0
    ns: int                   # len(srcs)
    ndst: int                 # len(dsts)
    skew: bool                # frozen hot-key scatter at the global stage


@dataclasses.dataclass(frozen=True)
class TorchLowering:
    """Routing tables extracted once per CompiledPlan (template differences
    become data): frozen onto the plan via plancache.attach_lowering."""

    src_pos: dict[int, int]          # wid -> position in srcs
    dst_pos: dict[int, int]          # wid -> position in dsts
    gsize: np.ndarray                # [L, ns] int32: worker's group size per level
    slot_map: np.ndarray             # [L, ns, ns] int32: (worker, slot) -> src pos
    rank_map: np.ndarray             # [L, ns, ns] int32: (sender, receiver) -> fold rank
    active: np.ndarray               # [L] bool: level beneficial?
    global_rank: np.ndarray          # [ns, ndst] int32: (sender, dst) -> fold rank
    levels_staged: tuple             # per level: ((wid, peers), ...) in srcs order
    bruck_flows: tuple | None = None
    # ^ per src position: per round (peer wid, ((origin pos, dst pos), ...)) --
    #   the symbolic piece simulation's wire flows, replayed by the ledger
    skew_hot: np.ndarray | None = None    # [H] int64 sorted hot keys
    skew_share: np.ndarray | None = None  # [H, S] int32 padded share slots
    skew_len: np.ndarray | None = None    # [H] int32 share counts


def _part_spec(part_fn) -> tuple | None:
    """Tensor-replicable partFuncs: the paper's hash default and range."""
    if part_fn.name == "hash":
        return ("hash",)
    m = _RANGE_NAME.match(part_fn.name)
    if m is not None:
        return ("range", int(m.group(1)))
    return None


def _bruck_sim(ns: int):
    """Symbolic bruck rounds over piece lists.

    A piece is (origin position, destination position): an origin's whole
    partition for one destination, which the algorithm moves whole and never
    splits.  Invariant: ``blocks[me][j]`` holds pieces destined for ring
    position ``(me + j) % ns``.  Returns the per-round flows (who sends which
    pieces to whom) and the final arrival order of origins per destination.
    """
    blocks = [[[(me, (me + j) % ns)] for j in range(ns)] for me in range(ns)]
    rounds = []
    step = 1
    while step < ns:
        js = [j for j in range(ns) if j & step]
        sent = {}
        flows = []
        for me in range(ns):
            pieces = []
            for j in js:
                pieces.extend(blocks[me][j])
                sent[(me, j)] = blocks[me][j]
                blocks[me][j] = []
            flows.append(((me + step) % ns, tuple(pieces)))
        for me in range(ns):
            peer_from = (me - step) % ns
            for j in js:
                blocks[me][j - step] = blocks[me][j - step] + sent[(peer_from, j)]
        rounds.append(flows)
        step *= 2
    arrival = [[o for (o, _d) in blocks[me][0]] for me in range(ns)]
    return rounds, arrival


def _is_square(ns: int) -> bool:
    q = int(round(ns ** 0.5))
    return q * q == ns


def lower_plan(plan: CompiledPlan) -> TorchLowering | None:
    """Extract the dense routing tables; None when the plan shape is not
    lowerable (unsupported template, ring/grid mismatch, unfreezable
    scatter)."""
    if plan_decline(plan) is not None:
        return None
    srcs, dsts = list(plan.srcs), list(plan.dsts)
    ns, ndst = len(srcs), len(dsts)
    src_pos = {w: i for i, w in enumerate(srcs)}
    dst_pos = {d: i for i, d in enumerate(dsts)}
    irregular = plan.template_id in ("bruck", "two_level")
    nlv = 0 if irregular else len(plan.levels)
    gsize = np.ones((nlv, ns), np.int32)
    slot_map = np.tile(np.arange(ns, dtype=np.int32), (nlv, ns, 1))
    rank_map = np.zeros((nlv, ns, ns), np.int32)
    active = np.zeros((nlv,), bool)
    levels_staged = []
    for li in range(nlv):
        ld = plan.levels[li]
        active[li] = ld.eff_cost.beneficial
        staged = []
        for w in srcs:
            nbrs = list(ld.nbrs.get(w, (w,)))
            wp = src_pos[w]
            gsize[li, wp] = len(nbrs)
            for s, n in enumerate(nbrs):
                slot_map[li, wp, s] = src_pos[n]
            # receiver w folds [own partition] + [peers in group order]:
            # rank 0 for itself, pos+1 before its own position, pos after
            pos_w = nbrs.index(w)
            for pos_s, s in enumerate(nbrs):
                sp = src_pos[s]
                if s == w:
                    rank_map[li, sp, wp] = 0
                else:
                    rank_map[li, sp, wp] = pos_s + 1 if pos_s < pos_w else pos_s
            if len(nbrs) > 1:
                staged.append((w, tuple(n for n in nbrs if n != w)))
        levels_staged.append(tuple(staged))
    global_rank = np.zeros((ns, ndst), np.int32)
    bruck_flows = None
    if plan.template_id == "coordinated":
        # fetch_order[d][t] = srcs[(idx(d) - t) % n]  =>  rank(s at d) = idx(d) - idx(s) mod n
        for d in dsts:
            for s in srcs:
                global_rank[src_pos[s], dst_pos[d]] = \
                    (src_pos[d] - src_pos[s]) % ns
    elif plan.template_id == "bruck":
        rounds, arrival = _bruck_sim(ns)
        for me in range(ns):
            dp = dst_pos[srcs[me]]
            for rank, origin in enumerate(arrival[me]):
                global_rank[origin, dp] = rank
        bruck_flows = tuple(
            tuple((srcs[flows[me][0]],
                   tuple((o, dst_pos[srcs[dr]]) for o, dr in flows[me][1]))
                  for flows in rounds)
            for me in range(ns))
    else:
        # push / pull / network_aware / two_level fold arrivals in srcs order
        # (two_level's fold orders live inside its own program)
        global_rank[:] = np.arange(ns, dtype=np.int32)[:, None]
    skew_hot = skew_share = skew_len = None
    if plan.skew is not None and plan.skew.triggered:
        skew_hot, skew_share, skew_len = scatter_tables(plan.skew)
    return TorchLowering(
        src_pos=src_pos, dst_pos=dst_pos, gsize=gsize, slot_map=slot_map,
        rank_map=rank_map, active=active, global_rank=global_rank,
        levels_staged=tuple(levels_staged), bruck_flows=bruck_flows,
        skew_hot=skew_hot, skew_share=skew_share, skew_len=skew_len)


# ---------------------------------------------------------------------------
# The device programs
# ---------------------------------------------------------------------------

def _i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_SPLITMIX_INC = _i64(0x9E3779B97F4A7C15)
_SPLITMIX_C1 = _i64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = _i64(0x94D049BB133111EB)


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits: torch's ``>>`` is arithmetic and
    has no uint64 form on every device, so mask off the copied sign bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _splitmix64(keys: torch.Tensor) -> torch.Tensor:
    """Bit-exact int64 mirror of messages.splitmix64 (seed 0): the same
    64-bit words, held as int64 (additions and products wrap the same)."""
    z = keys + _SPLITMIX_INC
    z = (z ^ _srl(z, 30)) * _SPLITMIX_C1
    z = (z ^ _srl(z, 27)) * _SPLITMIX_C2
    return z ^ _srl(z, 31)


def _umod(z: torch.Tensor, n) -> torch.Tensor:
    """``z mod n`` with ``z``'s int64 bits read as uint64 (``n`` > 0):
    ``z = 2 * (z >>> 1) + (z & 1)``, and both halves are non-negative."""
    return (_srl(z, 1) % n * 2 + (z & 1)) % n


def _slot_of(part: tuple, keys: torch.Tensor, ndst) -> torch.Tensor:
    """Per-row destination slot with a per-row (or scalar) slot count
    (PartFn.assign), as int64."""
    g = torch.as_tensor(ndst, dtype=torch.int64, device=keys.device)
    if part[0] == "hash":
        return _umod(_splitmix64(keys), g)
    per = (part[1] + g - 1) // g                       # ceil, like -(-ks // n)
    return torch.minimum(torch.div(keys, per, rounding_mode="floor"), g - 1)


def _sort_perm(ck: torch.Tensor) -> torch.Tensor:
    return torch.sort(ck, stable=True).indices


def _major(member, key: torch.Tensor, span: int) -> torch.Tensor:
    """``key`` (each value below ``span``) under the batch's member index as
    the most significant part; ``member`` None (a solo run) leaves it."""
    return key if member is None else member * span + key


def _count(index: torch.Tensor, weight: torch.Tensor, size: int,
           member=None, nb: int = 1) -> torch.Tensor:
    """Integer histogram ``out[member[i], index[i]] += weight[i]`` (a
    flattened count matrix per member, ``[nb, size]``).  ``scatter_add_``:
    integer sums are exact in any order, and on CUDA it is one atomic pass,
    where an accumulating ``index_put_`` sorts its indices first."""
    out = torch.zeros(nb * size, dtype=torch.int64, device=index.device)
    out.scatter_add_(0, _major(member, index, size), weight.to(torch.int64))
    return out.view(nb, size)


def _skew_slot(keys, owner, alive, base_slot, ns: int, hot_keys, share_slots,
               share_len, member=None):
    """The frozen hot-key scatter: scatter_part_fn's occurrence cycle as a
    whole-tensor op.  The cycle position of a hot row is its occurrence
    index among same-(owner, key) alive rows in tensor order -- tensor order
    per owner IS that worker's buffer order, the byte-order invariant the
    sorts maintain -- computed with one stable (member, owner, key) sort
    (dead rows keyed (ns, 0)) and a segment-relative position."""
    n = keys.shape[0]
    pos = torch.arange(n, device=keys.device)
    so = _major(member, torch.where(alive, torch.clamp(owner, max=ns - 1), ns),
                ns + 1)
    perm = _sort_perm(torch.where(alive, keys, 0))
    perm = perm[_sort_perm(so[perm])]
    sk, sso = keys[perm], so[perm]
    prev_same = (sso == torch.roll(sso, 1)) & (sk == torch.roll(sk, 1))
    prev_same[:1] = False
    seg_start = torch.cummax(torch.where(prev_same, 0, pos), 0).values
    occ = torch.empty_like(pos)
    occ[perm] = pos - seg_start
    hp = torch.searchsorted(hot_keys, keys)
    hpc = torch.clamp(hp, max=hot_keys.shape[0] - 1)
    is_hot = (hot_keys[hpc] == keys) & alive
    share = share_slots[hpc, occ % torch.clamp(share_len[hpc], min=1)]
    return torch.where(is_hot, share, base_slot)


def _combine(comb: str, keys, vals, owner, alive, participate, sentinel: int,
             member=None):
    """Per-owner equal-key fold, bit-identical to messages.Combiner.

    Stable lexsort by (member, owner, key) -- non-participating rows keep
    their relative order (their sort key is constant and owners never mix
    participation) -- then the ordered segmented fold over rows: each
    segment is seeded with its first row and the rest fold in element order,
    which is numpy's ``ufunc.at`` contract exactly.  Non-segment-end rows
    die (every later sort sends dead rows to the end of their member's
    block via the alive mask).
    """
    folds = participate & alive
    ckey = torch.where(folds, keys, 0)
    perm = _sort_perm(ckey)
    so = _major(member, torch.where(alive, owner, sentinel), sentinel + 1)
    perm = perm[_sort_perm(so[perm])]
    keys, vals, owner, alive, folds, so = (
        keys[perm], vals[perm], owner[perm], alive[perm], folds[perm],
        so[perm])
    # so tells apart owners and members; it differs from owner only on dead
    # rows, which never fold and never precede an alive row of their member
    prev_same = (so == torch.roll(so, 1)) & (keys == torch.roll(keys, 1))
    prev_same[:1] = False
    is_start = ~(prev_same & folds)
    folded = kernel_ops.segmented_fold(comb, is_start, vals)
    seg_end = torch.cat([is_start[1:], is_start.new_ones(1)])
    return keys, folded, owner, alive & seg_end


def _replay_impl(spec: _PlanSpec, keys, vals, owner,
                 gsize, slot_map, rank_map, active, global_rank,
                 hot_keys=None, share_slots=None, share_len=None, *,
                 member=None, nb: int = 1):
    """The level-loop replay shared by the four regular templates and (with
    zero levels plus a simulated global_rank) bruck.  ``active`` is host
    data (one bool per level); the other tables are tensors on the device.
    ``member [N]`` (sorted) lays ``nb`` members' runs end to end; the flow
    counts then carry a leading ``[nb]`` axis."""
    ns, ndst = spec.ns, spec.ndst
    n = keys.shape[0]
    alive = torch.ones((n,), dtype=torch.bool, device=keys.device)
    if spec.initial_comb:
        keys, vals, owner, alive = _combine(
            spec.comb, keys, vals, owner, alive, alive, ns, member)

    lvl_moved, lvl_pre, lvl_post = [], [], []
    for li in range(len(active)):
        g_l, slot_l, rank_l = gsize[li], slot_map[li], rank_map[li]
        act = bool(active[li])
        oc = torch.clamp(owner, max=ns - 1)
        g = g_l[oc]
        part_row = alive & (g > 1) if act else torch.zeros_like(alive)
        slot = _slot_of(spec.part, keys, torch.clamp(g, min=1))
        new_owner = torch.where(part_row, slot_l[oc, slot], owner)
        noc = torch.clamp(new_owner, max=ns - 1)
        rank = torch.where(part_row, rank_l[oc, noc], 0)
        moved = _count(oc * ns + noc, part_row, ns * ns, member,
                       nb).view(nb, ns, ns)
        # the exchange: one stable sort by (member, receiver, fold rank);
        # within a (sender -> receiver) flow rows keep buffer order = the
        # stable argsort inside messages.partition
        sort_owner = torch.where(alive, new_owner, ns)
        perm = _sort_perm(_major(member, sort_owner * (ns + 1) + rank,
                                 (ns + 1) ** 2))
        keys2, vals2 = keys[perm], vals[perm]
        owner2, alive2 = new_owner[perm], alive[perm]
        staged_owner = (g_l[torch.clamp(owner2, max=ns - 1)] > 1) & act
        if spec.comb is not None:
            keys2, vals2, owner2, alive2 = _combine(
                spec.comb, keys2, vals2, owner2, alive2,
                staged_owner & alive2, ns, member)
        post_row = alive2 & (g_l[torch.clamp(owner2, max=ns - 1)] > 1) & act
        post = _count(torch.clamp(owner2, max=ns - 1), post_row, ns, member,
                      nb)
        keys, vals, owner, alive = keys2, vals2, owner2, alive2
        lvl_moved.append(moved)
        lvl_pre.append(moved.sum(1))
        lvl_post.append(post)

    # ---- global exchange: every alive row repartitions over the dsts ----
    oc = torch.clamp(owner, max=ns - 1)
    slot = _slot_of(spec.part, keys, ndst)
    if spec.skew:
        slot = _skew_slot(keys, owner, alive, slot, ns, hot_keys,
                          share_slots, share_len, member)
    new_owner = torch.where(alive, slot, ndst)
    sc = torch.clamp(slot, max=ndst - 1)
    gmoved = _count(oc * ndst + sc, alive, ns * ndst, member,
                    nb).view(nb, ns, ndst)
    rank = torch.where(alive, global_rank[oc, sc], 0)
    perm = _sort_perm(_major(member, new_owner * (ns + 1) + rank,
                             (ndst + 1) * (ns + 1)))
    keys, vals = keys[perm], vals[perm]
    owner, alive = new_owner[perm], alive[perm]
    if spec.comb is not None:
        keys, vals, owner, alive = _combine(
            spec.comb, keys, vals, owner, alive, alive, ndst, member)

    def stack(mats, shape):         # per level [nb, ...] -> [nb, L, ...]
        if mats:
            return torch.stack(mats, 1)
        return torch.zeros((nb, 0, *shape), dtype=torch.int64,
                           device=keys.device)

    return (keys, vals, owner, alive, stack(lvl_moved, (ns, ns)),
            stack(lvl_pre, (ns,)), stack(lvl_post, (ns,)), gmoved)


def _two_level_impl(spec: _PlanSpec, keys, vals, owner, *, member=None,
                    nb: int = 1):
    """two_level's three-phase replay on a square src==dst grid.

    Every row's final slot ``d`` (a pure function of its key) determines all
    three hops: phase 1 sends it within the row group to member ``d // q``,
    phase 2 hands whole blocks to the transpose partner -- a pure owner
    relabel, since blocks move unsplit (and, combined, already hold unique
    keys, so the threaded re-COMB is an order-preserving identity) -- and
    phase 3 delivers within the destination group.  Each exchange is one
    stable sort on the grid's exact mailbox concat order: (receiver, sender
    member index, slot), under the batch's member index.  Returns the phase
    flow counts the ledger replays, each with a leading ``[nb]`` axis.
    """
    ns = spec.ns
    q = int(round(ns ** 0.5))
    n = keys.shape[0]
    alive = torch.ones((n,), dtype=torch.bool, device=keys.device)

    # phase 1: (g0, i0) routes each row toward its final slot's group column
    d = _slot_of(spec.part, keys, ns)
    w1 = (owner // q) * q + d // q
    rank1 = (owner % q) * ns + d
    gmoved_init = _count(owner * ns + d, alive, ns * ns, member,
                         nb).view(nb, ns, ns)
    perm = _sort_perm(_major(member, w1 * (q * ns) + rank1, ns * q * ns))
    keys, vals, owner, alive = keys[perm], vals[perm], w1[perm], alive[perm]
    if spec.comb is not None:
        keys, vals, owner, alive = _combine(
            spec.comb, keys, vals, owner, alive, alive, ns, member)
    post1 = _count(torch.clamp(owner, max=ns - 1), alive, ns, member, nb)

    # phase 2: (g, i) hands its whole block to the transpose partner (i, g)
    owner = (owner % q) * q + owner // q

    # phase 3: final partition within the destination group
    d = _slot_of(spec.part, keys, ns)
    rank3 = owner % q
    p3moved = _count(torch.clamp(owner, max=ns - 1) * ns + d, alive,
                     ns * ns, member, nb).view(nb, ns, ns)
    so = torch.where(alive, d, ns)
    perm = _sort_perm(_major(member, so * q + rank3, (ns + 1) * q))
    keys, vals, alive = keys[perm], vals[perm], alive[perm]
    owner = d[perm]
    if spec.comb is not None:
        keys, vals, owner, alive = _combine(
            spec.comb, keys, vals, owner, alive, alive, ns, member)
    return keys, vals, owner, alive, gmoved_init, post1, p3moved


def _run_program(spec: _PlanSpec, low: TorchLowering, keys, vals, owner,
                 device: torch.device, member=None, nb: int = 1):
    """Run the plan's program on ``device``; tensors in, tensors out.  A
    solo run (``member`` None) returns its flow counts without the member
    axis; a batched one keeps it."""
    if spec.template == "two_level":
        out = _two_level_impl(spec, keys, vals, owner, member=member, nb=nb)
    else:
        def dev(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        skew = (dev(low.skew_hot), dev(low.skew_share),
                dev(low.skew_len)) if spec.skew else ()
        out = _replay_impl(spec, keys, vals, owner, dev(low.gsize),
                           dev(low.slot_map), dev(low.rank_map), low.active,
                           dev(low.global_rank), *skew, member=member, nb=nb)
    if member is None:
        out = (*out[:4], *(c[0] for c in out[4:]))
    return out


# ---------------------------------------------------------------------------
# The kernel plane (default-on on CUDA, mirrors vectorized.set_comb_backend)
# ---------------------------------------------------------------------------

_KERNEL_PLANE: bool | None = None      # None = auto: on when the device is CUDA


def kernel_plane_enabled(device) -> bool:
    """Whether SUM replays on ``device`` route payloads through the PART and
    COMB kernels: an explicit set_kernel_plane() override, else auto --
    enabled exactly when the replay runs on a CUDA device."""
    if _KERNEL_PLANE is not None:
        return _KERNEL_PLANE
    return torch.device(device).type == "cuda"


def set_kernel_plane(enabled: bool | None) -> bool | None:
    """Route SUM replays' global PART/COMB through the kernels:
    :func:`repro_torch.kernels.partition.partition_permute` moves rows to
    their destination-major positions and
    :func:`repro_torch.kernels.combine.segment_combine` sums the per-
    (destination, key) segments.

    Default is *auto* (``None``): on when the replay's device is CUDA.  The
    kernels accumulate in float32, so the payload plane trades the bit-exact
    float64 contract for kernel throughput -- ``set_kernel_plane(False)`` is
    the opt-out that restores exact payloads (routing decisions, output key
    sets and all ledger charges always come from the exact program either
    way).  Returns the previous setting (``True``/``False``/``None``).
    """
    global _KERNEL_PLANE
    prev = _KERNEL_PLANE
    _KERNEL_PLANE = None if enabled is None else bool(enabled)
    return prev


def kernel_global_stage(part_fn, keys: torch.Tensor, vals: torch.Tensor,
                        ndst: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The fused global exchange+fold of a SUM replay on the PART and COMB
    kernels.

    SUM's per-(destination, key) totals are invariant under the hierarchy's
    pre-combines, so the whole replay collapses to one PART + one COMB over
    the stacked inputs (``keys [N]``, ``vals [N, d]`` on the replay's
    device): PART moves every row to its destination-major position (a
    permutation, so the kernel's no-atomics path), then COMB sums the
    contiguous (destination, key) segments.  The segment ids are compacted
    to the (destination, key) pairs present -- the reference numbers them
    ``ndst x unique keys``, nearly all empty -- which leaves each
    destination's result unchanged.  Returns ``[(keys, vals), ...]`` per
    destination with keys ascending, as numpy (int64, float64).
    """
    part = _part_spec(part_fn)
    if part is None:
        raise ValueError(f"partFunc {part_fn.name!r} has no tensor form")
    n = keys.shape[0]
    slot = _slot_of(part, keys, ndst)              # the plan's real partFunc
    order = _sort_perm(keys)
    order = order[_sort_perm(slot[order])]         # destination-major, key asc
    s_keys, s_slot = keys[order], slot[order]
    head = torch.ones((n,), dtype=torch.bool, device=keys.device)
    head[1:] = (s_keys[1:] != s_keys[:-1]) | (s_slot[1:] != s_slot[:-1])
    seg = torch.cumsum(head, 0) - 1                # compacted (dst, key) id
    num_seg = int(seg[-1]) + 1 if n else 0
    pos = torch.empty((n,), dtype=torch.int32, device=keys.device)
    pos[order] = torch.arange(n, dtype=torch.int32, device=keys.device)
    routed = kernel_ops.part(pos, vals.to(torch.float32).contiguous(),
                             num_out=n, unique_slots=True)
    folded = kernel_ops.combine(seg.to(torch.int32), routed,
                                num_segments=num_seg)
    seg_keys = s_keys[head].cpu().numpy()
    counts = torch.bincount(s_slot[head], minlength=ndst).cpu().numpy()
    dense = folded.to(torch.float64).cpu().numpy()
    bounds = np.cumsum(counts)[:-1]
    return list(zip(np.split(seg_keys, bounds), np.split(dense, bounds)))


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

def _call_decline(cluster: LocalCluster, args: ShuffleArgs,
                  bufs: dict[int, Msgs]) -> str | None:
    """Call-time decline cause (cluster/arg state the plan can't know), or
    ``None`` when the invocation itself is lowerable.  Reason codes are
    machine-checkable and surface through ``ShuffleResult.fallback_reason``
    / ``cluster.explain()``."""
    if args.plan is None:
        return "no_plan"
    if args.template_id not in TORCH_TEMPLATES:
        return "template_not_lowerable"
    if args.stream is not None:
        return "streamed_replay"
    if args.recovery is not None:
        return "recovery_context"
    if args.storage is not None and args.storage.persist:
        # durable persistence writes PART blocks through the shuffle store;
        # the device program has no store hook, so it would silently skip the
        # durability contract -- fall back to the (byte-identical) vectorized
        # executor, which persists
        return "storage_persist"
    if (cluster.failed_workers or cluster.worker_delays
            or cluster.fault_injections):
        return "cluster_fault_state"
    if args.comb_fn is not None and args.comb_fn.name not in _TORCH_COMBINERS:
        return "unsupported_combiner"
    if _part_spec(args.part_fn) is None:
        return "unsupported_part_fn"
    widths = {m.width for m in bufs.values() if m.n}
    if len(widths) > 1:
        return "mixed_widths"
    if sum(m.n for m in bufs.values()) == 0:
        return "empty_workload"
    return None


def plan_decline(plan: CompiledPlan) -> str | None:
    """Plan-shape decline cause (mirrors :func:`lower_plan`'s refusals), or
    ``None`` when the plan shape is lowerable."""
    if plan.template_id not in TORCH_TEMPLATES:
        return "template_not_lowerable"
    srcs, dsts = list(plan.srcs), list(plan.dsts)
    if plan.template_id == "coordinated" and any(d not in srcs for d in dsts):
        return "ring_mismatch"
    if plan.template_id == "bruck" and set(srcs) != set(dsts):
        return "ring_mismatch"              # the ring IS the destination set
    if plan.template_id == "two_level" and (
            tuple(srcs) != tuple(dsts) or not _is_square(len(srcs))):
        return "grid_mismatch"              # needs a square src==dst grid
    if plan.skew is not None and plan.skew.triggered:
        if plan.template_id == "two_level":
            # phase-3 re-partition would need fresh occurrence indices; the
            # registry marks two_level non-rebalanceable, so only a
            # hand-built plan can get here
            return "skew_shape_mismatch"
        if plan.skew.ndst != len(dsts):
            return "skew_shape_mismatch"    # scatter aimed at another width
        for ld in plan.levels:
            if not ld.eff_cost.beneficial:
                continue
            for w in srcs:
                if len(ld.nbrs.get(w, (w,))) == plan.skew.ndst:
                    # a level-local exchange the scattered partFunc would
                    # also rewrite -- occurrence state the replay can't freeze
                    return "skew_group_collision"
    src_set = set(srcs)
    if plan.template_id not in ("bruck", "two_level"):
        for ld in plan.levels:
            for w in srcs:
                if any(n not in src_set for n in ld.nbrs.get(w, (w,))):
                    return "routing_off_srcs"   # a repaired plan routing off-srcs
    return None


def decline_reason(cluster: LocalCluster, args: ShuffleArgs,
                   bufs: dict[int, Msgs]) -> str | None:
    """Why :func:`try_run_torch` would decline this invocation (``None``
    when it would run): the call-time cause if any, else the plan-shape
    cause."""
    reason = _call_decline(cluster, args, bufs)
    if reason is not None:
        return reason
    return plan_decline(args.plan)


def _spec_of(args: ShuffleArgs) -> _PlanSpec:
    plan = args.plan
    return _PlanSpec(
        template=args.template_id,
        comb=args.comb_fn.name if args.comb_fn is not None else None,
        part=_part_spec(args.part_fn),
        initial_comb=(args.template_id == "network_aware"
                      and args.comb_fn is not None),
        ns=len(args.srcs), ndst=len(args.dsts),
        skew=bool(plan is not None and plan.skew is not None
                  and plan.skew.triggered))


def _attached_lowering(cluster, args) -> "TorchLowering | None":
    """The plan's lowering, deriving and attaching on first use."""
    plan = args.plan
    low = get_lowering(plan)
    if low is None:
        tracer = cluster.obs.tracer
        if tracer.enabled:
            with tracer.span("lower", shuffle_id=args.shuffle_id,
                             tenant=args.tenant,
                             template=args.template_id) as sp:
                low = lower_plan(plan)
                sp.set(declined=low is None)
        else:
            low = lower_plan(plan)
        attach_lowering(plan, _DECLINED if low is None else low)
    return None if low is _DECLINED else low


def try_run_torch(cluster: LocalCluster, args: ShuffleArgs,
                  bufs: dict[int, Msgs], manager=None, *,
                  device) -> ShuffleResult | None:
    """Replay ``args.plan`` with tensors on ``device``; None = declined (the
    service falls back to the vectorized executor).  A member of a batched
    dispatch consumes its slice of the batch's run instead."""
    if _call_decline(cluster, args, bufs) is not None:
        return None
    low = _attached_lowering(cluster, args)
    if low is None:
        return None
    slot = _BATCH_SLOTS.get(id(bufs))
    if slot is not None and slot.plan is not args.plan:
        slot = None                       # re-planned since the batch probe
    if slot is not None:
        _BATCH_SLOTS.pop(id(bufs), None)
    device = torch.device(device)
    tracer = cluster.obs.tracer
    if not tracer.enabled:
        return _run_lowered(cluster, args, bufs, low, manager, device,
                            batch_slot=slot)
    with tracer.span("exec", shuffle_id=args.shuffle_id, tenant=args.tenant,
                     engine="torch", template=args.template_id,
                     device=str(device)):
        return _run_lowered(cluster, args, bufs, low, manager, device,
                            batch_slot=slot)


# ---------------------------------------------------------------------------
# Batched dispatch: one program over same-signature submissions
# ---------------------------------------------------------------------------

class _BatchHandle:
    """One batched run covering ``size`` same-signature submissions.  The
    shared epoch barrier closes once every member has either consumed its
    slice or been abandoned (declined solo / invalidated mid-batch)."""

    def __init__(self, size: int):
        self.size = size
        self.pending = size
        self.consumed = 0
        self.closed = False

    def member_done(self, ledger) -> None:
        self.consumed += 1
        self._settle(ledger)

    def abandon(self, ledger) -> None:
        self._settle(ledger)

    def _settle(self, ledger) -> None:
        self.pending -= 1
        if self.pending <= 0 and not self.closed:
            self.closed = True
            if self.consumed:
                ledger.advance_epoch()


@dataclasses.dataclass
class _BatchSlot:
    handle: _BatchHandle
    plan: object                     # the probed CompiledPlan (identity check)
    outputs: tuple                   # (keys per dst, vals per dst, counts)
    inputs: tuple                    # the member's (keys, vals) on the device


# Pending batch slices, keyed by id() of the submission's buffer dict -- the
# one object that flows unchanged from admission through client.shuffle to
# try_run_torch, so a member is matched without widening any call signature.
_BATCH_SLOTS: dict[int, _BatchSlot] = {}


def batch_signature(cluster: LocalCluster, args: ShuffleArgs,
                    bufs: dict[int, Msgs]):
    """Hashable grouping key for batched dispatch, or None when this
    submission would not replay here.  Submissions agreeing on the key
    share one program AND identical routing tables, so one batched run
    replays all of them."""
    if decline_reason(cluster, args, bufs) is not None:
        return None
    low = _attached_lowering(cluster, args)
    if low is None:
        return None
    width = next((m.width for m in bufs.values() if m.n), 1)
    nrows = sum(bufs.get(w, Msgs.empty(width)).n for w in args.srcs)
    skew_sig = None if low.skew_hot is None else (
        low.skew_hot.tobytes(), low.skew_share.tobytes(),
        low.skew_len.tobytes())
    return (_spec_of(args), tuple(args.srcs), tuple(args.dsts), nrows, width,
            low.gsize.tobytes(), low.slot_map.tobytes(),
            low.rank_map.tobytes(), low.active.tobytes(),
            low.global_rank.tobytes(), low.bruck_flows, skew_sig)


def _stacked(members, low: TorchLowering, width: int):
    """The sources of ``members`` (``(args, bufs)`` pairs) stacked end to
    end in one copy: (keys, vals, owner) as numpy."""
    per_w = [(w, b.get(w, Msgs.empty(width))) for a, b in members
             for w in a.srcs]
    keys = np.concatenate([m.keys for _, m in per_w])
    vals = np.concatenate([np.ascontiguousarray(m.vals) for _, m in per_w])
    owner = np.concatenate([np.full(m.n, low.src_pos[w], np.int64)
                            for w, m in per_w])
    return keys, vals, owner


def prepare_batch(cluster: LocalCluster, members, *,
                  device) -> "_BatchHandle | None":
    """Run ONE program for ``members`` -- a list of ``(args, bufs)`` sharing
    :func:`batch_signature` -- with their rows laid end to end on
    ``device``, and register each member's output slice for consumption by
    its own replay, which charges its own tenant's ledger lanes exactly as a
    serial run would."""
    if len(members) < 2:
        return None
    args0, bufs0 = members[0]
    low = get_lowering(args0.plan)
    if low is None or low is _DECLINED:
        return None
    device = torch.device(device)
    spec = _spec_of(args0)
    nb = len(members)
    width = next((m.width for m in bufs0.values() if m.n), 1)
    with record_function("teshu.h2d"):
        keys, vals, owner = (torch.from_numpy(a).to(device)
                             for a in _stacked(members, low, width))
        n = keys.shape[0] // nb              # the signature fixes the rows
        member = torch.arange(nb, device=device).repeat_interleave(n)
    with record_function("teshu.program"):
        out = _run_program(spec, low, keys, vals, owner, device, member, nb)
        counts = [c.cpu().numpy() for c in out[4:]]
    with record_function("teshu.d2h"):
        out_keys, out_vals = _split_by_owner(*out[:4], spec.ndst, member, nb)
    handle = _BatchHandle(nb)
    ndst = spec.ndst
    for i, (a, b) in enumerate(members):
        _BATCH_SLOTS[id(b)] = _BatchSlot(
            handle=handle, plan=a.plan,
            outputs=(out_keys[i * ndst:(i + 1) * ndst],
                     out_vals[i * ndst:(i + 1) * ndst],
                     [c[i] for c in counts]),
            inputs=(keys[i * n:(i + 1) * n], vals[i * n:(i + 1) * n]))
    return handle


def finish_batches(handles, ledger) -> None:
    """Abandon any slice left unconsumed (its member declined solo or was
    re-planned mid-batch) so the shared epoch barrier still closes."""
    live = {id(h) for h in handles}
    stale = [k for k, slot in _BATCH_SLOTS.items() if id(slot.handle) in live]
    for k in stale:
        _BATCH_SLOTS.pop(k).handle.abandon(ledger)


# ---------------------------------------------------------------------------
# Ledger replay of the irregular templates
# ---------------------------------------------------------------------------

def _charge_bruck(ledger, topo, args, low, gmoved, rowb: int) -> None:
    """bruck's wire flows from the lower-time simulation: per worker, one
    batched charge per round (totals per (worker, level, peer) are what the
    epoch folds, and the threaded sender's per-piece SENDs sum to exactly
    these), then the final self-delivery combine."""
    srcs, dsts = list(args.srcs), list(args.dsts)
    for me, w in enumerate(srcs):
        for peer, pieces in low.bruck_flows[me]:
            if not pieces:
                continue
            nbytes = sum(int(gmoved[o, dp]) for o, dp in pieces) * rowb
            ledger.charge_transfer(w, topo.crossing_level(w, peer), nbytes,
                                   dst=peer, tenant=args.tenant)
    if args.comb_fn is not None:
        for d in dsts:
            dp = low.dst_pos[d]
            ledger.charge_combine(d, int(gmoved[:, dp].sum()) * rowb,
                                  tenant=args.tenant)


def _charge_two_level(ledger, topo, args, low, gmoved_init, post1, p3moved,
                      rowb: int) -> None:
    """two_level's three phases from the program's flow counts, all in the
    one replay epoch (self-sends are free -- crossing_level(w, w) < 0 --
    exactly like the threaded mailbox path)."""
    srcs = list(args.srcs)
    ns, q = len(srcs), int(round(len(srcs) ** 0.5))
    comb = args.comb_fn is not None
    # rows sender p holds for destination-group column j after phase 1
    groupsum = np.zeros((ns, q), np.int64)
    for p in range(ns):
        for d in range(ns):
            groupsum[p, d // q] += int(gmoved_init[p, d])
    for p, w in enumerate(srcs):
        g = p // q
        peers = [srcs[g * q + j] for j in range(q)]
        ledger.charge_transfers(
            w,
            np.fromiter((topo.crossing_level(w, n) for n in peers),
                        dtype=np.int64, count=q),
            groupsum[p] * rowb,
            dsts=np.asarray(peers, dtype=np.int64), tenant=args.tenant)
    if comb:
        for p, w in enumerate(srcs):
            g, j = divmod(p, q)
            pre = int(sum(groupsum[g * q + i, j] for i in range(q))) * rowb
            ledger.charge_combine(w, pre, tenant=args.tenant)
    transpose = [(p % q) * q + p // q for p in range(ns)]
    for p, w in enumerate(srcs):
        partner = srcs[transpose[p]]
        ledger.charge_transfer(w, topo.crossing_level(w, partner),
                               int(post1[p]) * rowb, dst=partner,
                               tenant=args.tenant)
    if comb:
        for p, w in enumerate(srcs):
            # the received (possibly own) block is re-COMBed whole
            ledger.charge_combine(w, int(post1[transpose[p]]) * rowb,
                                  tenant=args.tenant)
    for p, w in enumerate(srcs):
        g = p // q
        peers = [srcs[g * q + j] for j in range(q)]
        ledger.charge_transfers(
            w,
            np.fromiter((topo.crossing_level(w, n) for n in peers),
                        dtype=np.int64, count=q),
            np.fromiter((int(p3moved[p, g * q + j]) * rowb for j in range(q)),
                        dtype=np.int64, count=q),
            dsts=np.asarray(peers, dtype=np.int64), tenant=args.tenant)
    if comb:
        for p, w in enumerate(srcs):
            ledger.charge_combine(w, int(p3moved[:, p].sum()) * rowb,
                                  tenant=args.tenant)


def _split_by_owner(keys, vals, owner, alive, ndst: int, member=None,
                    nb: int = 1):
    """Alive rows per (member, destination position), in physical order, as
    numpy: ``nb * ndst`` arrays each of keys and of vals, member-major."""
    idx = torch.nonzero(alive).squeeze(1)
    own = _major(None if member is None else member[idx], owner[idx], ndst)
    idx = idx[_sort_perm(own)]
    counts = torch.bincount(own, minlength=nb * ndst).cpu().numpy()
    bounds = np.cumsum(counts)[:-1]
    return (np.split(keys[idx].cpu().numpy(), bounds),
            np.split(vals[idx].cpu().numpy(), bounds))


def _run_lowered(cluster, args: ShuffleArgs, bufs: dict[int, Msgs],
                 low: TorchLowering, manager, device: torch.device,
                 batch_slot: "_BatchSlot | None" = None) -> ShuffleResult:
    plan = args.plan
    topo = cluster.topology
    ledger = cluster.ledger
    srcs, dsts = list(args.srcs), list(args.dsts)
    participants = sorted(set(srcs) | set(dsts))
    width = next((m.width for m in bufs.values() if m.n), 1)
    rowb = 8 + 8 * width                  # the wire format Msgs.nbytes charges
    spec = _spec_of(args)

    if manager is not None:
        manager.get_template(args.template_id, wid=None)
        for w in participants:
            manager.record_start(w, args.shuffle_id, args.template_id,
                                 tenant=args.tenant)
    before = ledger.snapshot()
    observed: list[tuple] = []

    # ---- the device data plane --------------------------------------------
    # (record_function ranges name the phases in a torch.profiler trace)
    per_w = [bufs.get(w, Msgs.empty(width)) for w in srcs]
    if batch_slot is not None:
        # this member's slice of the batch's run
        out_keys, out_vals, counts = batch_slot.outputs
        keys, vals = batch_slot.inputs
    else:
        with record_function("teshu.h2d"):
            keys, vals, owner = (torch.from_numpy(a).to(device)
                                 for a in _stacked([(args, bufs)], low, width))
        tracer = cluster.obs.tracer
        replay_sp = tracer.span(
            "device_replay", shuffle_id=args.shuffle_id, tenant=args.tenant,
            rows=int(keys.shape[0]), device=str(device),
        ) if tracer.enabled else None
        with record_function("teshu.program"):
            out = _run_program(spec, low, keys, vals, owner, device)
            counts = [a.cpu().numpy() for a in out[4:]]
        if replay_sp is not None:
            replay_sp.end()
        with record_function("teshu.d2h"):
            out_keys, out_vals = _split_by_owner(*out[:4], len(dsts))

    # ---- ledger replay: the reference executors' exact charge sequence ----
    if spec.template == "two_level":
        gmoved_init, post1, p3moved = counts
        _charge_two_level(ledger, topo, args, low, gmoved_init, post1,
                          p3moved, rowb)
    else:
        lvl_moved, lvl_pre, lvl_post, gmoved = counts
        if spec.initial_comb:
            for w, m in zip(srcs, per_w):  # network_aware local pre-combine
                ledger.charge_combine(w, m.nbytes, tenant=args.tenant)
        for li, ld in enumerate(plan.levels if spec.template != "bruck" else ()):
            if not ld.eff_cost.beneficial:
                continue
            if batch_slot is None:
                ledger.advance_epoch()    # the stage barrier (PLAN_STAGE)
            staged = low.levels_staged[li]
            for w, peers in staged:
                wp = low.src_pos[w]
                ledger.charge_transfers(
                    w,
                    np.fromiter((topo.crossing_level(w, n) for n in peers),
                                dtype=np.int64, count=len(peers)),
                    np.fromiter(
                        (int(lvl_moved[li, wp, low.src_pos[n]]) * rowb
                         for n in peers), dtype=np.int64, count=len(peers)),
                    dsts=np.asarray(peers, dtype=np.int64), tenant=args.tenant)
            for w, _peers in staged:
                pre = int(lvl_pre[li, low.src_pos[w]]) * rowb
                post = int(lvl_post[li, low.src_pos[w]]) * rowb
                if args.comb_fn is not None:
                    ledger.charge_combine(w, pre, tenant=args.tenant)
                observed.append((ld.level, pre, post))

        if spec.template == "bruck":
            _charge_bruck(ledger, topo, args, low, gmoved, rowb)
        else:
            if spec.template in ("vanilla_push", "network_aware"):
                for w in srcs:            # push: the sender pays
                    wp = low.src_pos[w]
                    ledger.charge_transfers(
                        w,
                        np.fromiter((topo.crossing_level(w, d) for d in dsts),
                                    dtype=np.int64, count=len(dsts)),
                        gmoved[wp].astype(np.int64) * rowb,
                        dsts=np.asarray(dsts, dtype=np.int64),
                        tenant=args.tenant)
                fetch_order = {d: srcs for d in dsts}
                charge_receiver = False
            elif spec.template == "vanilla_pull":
                fetch_order = {d: srcs for d in dsts}
                charge_receiver = True
            else:                         # coordinated: ring order, receiver pays
                n = len(srcs)
                fetch_order = {d: [srcs[(srcs.index(d) - t) % n]
                                   for t in range(n)] for d in dsts}
                charge_receiver = True
            for d in dsts:
                dp = low.dst_pos[d]
                order = fetch_order[d]
                if charge_receiver:
                    ledger.charge_transfers(
                        d,
                        np.fromiter((topo.crossing_level(s, d) for s in order),
                                    dtype=np.int64, count=len(order)),
                        np.fromiter((int(gmoved[low.src_pos[s], dp]) * rowb
                                     for s in order), dtype=np.int64,
                                    count=len(order)),
                        dsts=np.full(len(order), d, dtype=np.int64),
                        tenant=args.tenant)
                if args.comb_fn is not None:
                    ledger.charge_combine(d, int(gmoved[:, dp].sum()) * rowb,
                                          tenant=args.tenant)

    out_bufs: dict[int, Msgs] = {
        d: Msgs(out_keys[low.dst_pos[d]],
                out_vals[low.dst_pos[d]].reshape(-1, width)) for d in dsts}
    if (kernel_plane_enabled(device) and spec.comb == "sum" and not spec.skew
            and spec.template not in ("bruck", "two_level")):
        # the kernel plane (default-on on CUDA): same routing and key sets,
        # payloads re-folded on the PART/COMB kernels (float32 accumulation
        # -- see set_kernel_plane)
        with record_function("teshu.kernel_plane"):
            per_dst = kernel_global_stage(args.part_fn, keys, vals, len(dsts))
        for d, (kk, vv) in zip(dsts, per_dst):
            out_bufs[d] = Msgs(kk, vv.reshape(-1, width))
    if spec.skew:
        # the owner-merge stage: scattered hot rows travel back to their base
        # destination -- Python-side, mirroring the vectorized replay exactly
        with record_function("teshu.owner_merge"):
            owner_merge(ledger, topo, args, plan.skew, out_bufs)
    if batch_slot is None:
        ledger.advance_epoch()            # shuffle completion is a barrier
    else:
        batch_slot.handle.member_done(ledger)   # the batch settles as one
    after = ledger.snapshot()
    if manager is not None:
        for w in participants:
            manager.record_end(w, args.shuffle_id, args.template_id,
                               tenant=args.tenant)
    return ShuffleResult(
        bufs=out_bufs,
        decisions=list(plan.decisions),
        stats=ledger.delta(before, after),
        observed=aggregate_observed([observed]),
        cached=True,
        vectorized=False,
        engine="torch",
        batched=batch_slot is not None,
    )
