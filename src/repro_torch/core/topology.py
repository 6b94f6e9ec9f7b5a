"""Network topology model: the `$`-parameters TeShu instantiates templates with.

The paper's data-center hierarchy (worker < server < rack < global) is modeled as an
ordered list of :class:`Level` boundaries, innermost first.  Each level carries the
bandwidth a single worker sees when crossing that boundary, a base latency, and the
combine (compute) throughput available at that level.  Oversubscription is expressed
directly: an oversubscription ratio of ``k:1`` at the rack level means the per-worker
inter-rack bandwidth is ``intra_rack_bw / k``.

Two constructors are provided:

* :func:`datacenter` — the paper's testbed shape (workers per server, servers per
  rack, racks), used by the graph-analytics reproduction and the benchmarks.
* :func:`from_mesh_axes` — maps a TPU mesh (``pod``/``data``/``model`` axes) onto the
  same abstraction so LM integrations (MoE dispatch, gradient sync) share one cost
  model.  ICI vs DCN asymmetry plays the role of oversubscription.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

# Hardware constants for the TPU target (per chip / per link).
TPU_PEAK_FLOPS_BF16 = 197e12      # FLOP/s
TPU_HBM_BW = 819e9                # bytes/s
TPU_ICI_BW_PER_LINK = 50e9        # bytes/s per link
TPU_DCN_BW_PER_CHIP = 6.25e9      # bytes/s per chip across pods (typical 50 Gb/s NIC share)


@dataclasses.dataclass(frozen=True)
class Level:
    """One boundary of the hierarchy, innermost (cheapest to cross) first."""

    name: str                    # e.g. "server", "rack", "global" / "model", "data", "pod"
    group_size: int              # number of workers inside one group at this level
    bw_bytes_per_s: float        # per-worker bandwidth when crossing this boundary
    latency_s: float = 10e-6
    combine_bytes_per_s: float = 8e9   # throughput of COMB executed at this level

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bw_bytes_per_s

    def combine_time(self, nbytes: float) -> float:
        return nbytes / self.combine_bytes_per_s


@dataclasses.dataclass(frozen=True)
class NetworkTopology:
    """Ordered hierarchy of levels; ``levels[-1]`` is the global boundary."""

    levels: tuple[Level, ...]

    # ---- shape --------------------------------------------------------------
    @property
    def num_workers(self) -> int:
        return self.levels[-1].group_size

    def level(self, name: str) -> Level:
        for lv in self.levels:
            if lv.name == name:
                return lv
        raise KeyError(name)

    def level_index(self, name: str) -> int:
        for i, lv in enumerate(self.levels):
            if lv.name == name:
                return i
        raise KeyError(name)

    # ---- placement ----------------------------------------------------------
    def coords(self, wid: int) -> tuple[int, ...]:
        """Group index of ``wid`` at every level (innermost first)."""
        return tuple(wid // lv.group_size for lv in self.levels)

    def shared_level(self, a: int, b: int) -> int:
        """Index of the innermost level whose group contains both workers.

        ``0`` means same innermost group (e.g. same server); ``len(levels)-1`` means
        they only share the global level.  ``-1`` for a == b (no network crossed).
        """
        if a == b:
            return -1
        for i, lv in enumerate(self.levels):
            if a // lv.group_size == b // lv.group_size:
                return i
        return len(self.levels) - 1

    def crossing_level(self, a: int, b: int) -> int:
        """Index of the boundary a message from ``a`` to ``b`` must cross.

        Same server -> crosses level 0 (the server boundary's internal links);
        same rack, different server -> crosses level 1; etc.  ``-1`` for local.
        """
        return self.shared_level(a, b)

    def neighbors(self, wid: int, peers: Sequence[int], level_name: str) -> list[int]:
        """Peers (incl. ``wid``) sharing ``wid``'s group at ``level_name``.

        This is the paper's ``$FIND_NBRS_PER_SERVER`` / ``$FIND_NBRS_PER_RACK``.
        """
        lv = self.level(level_name)
        g = wid // lv.group_size
        return [p for p in peers if p // lv.group_size == g]

    # ---- cost model ---------------------------------------------------------
    def cost_per_byte_above(self, level_idx: int) -> float:
        """Seconds per byte summed over all boundaries *outside* ``level_idx``.

        Used by ``$COMPUTE_EFF_COST``: a byte removed before stage ``level_idx+1``
        saves transfer time on every remaining boundary it would have crossed.
        """
        return sum(1.0 / lv.bw_bytes_per_s for lv in self.levels[level_idx + 1:])

    def transfer_time(self, level_idx: int, nbytes: float) -> float:
        return self.levels[level_idx].transfer_time(nbytes)

    def fingerprint(self) -> tuple:
        """Hashable identity for plan caching (template instantiation key)."""
        return tuple(dataclasses.astuple(lv) for lv in self.levels)

    # ---- elastic resizing ----------------------------------------------------
    def with_workers(self, n: int) -> "NetworkTopology":
        """A copy of this topology whose global worker set has ``n`` workers.

        Only the outermost level's ``group_size`` changes: worker ids are
        dense, coordinates are floor divisions, so inner-level group
        membership of every existing worker is untouched and the new workers
        slot into the (possibly partial) trailing groups.  The fingerprint
        differs only in its last tuple — exactly what plan repair's
        changed-level analysis expects from a grown or shrunk cluster.
        """
        if n < 1:
            raise ValueError(f"worker count must be >= 1: {n}")
        last = dataclasses.replace(self.levels[-1], group_size=n)
        return NetworkTopology(levels=self.levels[:-1] + (last,))

    def grow(self, groups: int = 1, level: str | None = None
             ) -> "NetworkTopology":
        """Add ``groups`` whole groups of burst workers at ``level``.

        ``level`` names the boundary whose group granularity the new workers
        arrive in (a whole server, a whole rack); default is the innermost
        level.  The outermost level cannot be the grow granularity — its one
        group *is* the cluster.
        """
        if groups < 1:
            raise ValueError(f"groups must be >= 1: {groups}")
        lv = self.levels[0] if level is None else self.level(level)
        if lv.name == self.levels[-1].name:
            raise ValueError(
                f"cannot grow at the outermost level {lv.name!r}")
        return self.with_workers(self.num_workers + groups * lv.group_size)

    def shrink(self, workers: int) -> "NetworkTopology":
        """Remove the ``workers`` highest-numbered workers (drain-in)."""
        if workers < 1 or workers >= self.num_workers:
            raise ValueError(
                f"can remove 1..{self.num_workers - 1} workers: {workers}")
        return self.with_workers(self.num_workers - workers)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def datacenter(
    workers_per_server: int,
    servers_per_rack: int,
    racks: int,
    *,
    intra_server_bw: float = 12.5e9,      # shared-memory / loopback, ~100 Gbps
    intra_rack_bw: float = 1.25e9,        # 10 Gbps NIC, paper testbed
    oversubscription: float = 1.0,        # inter-rack bw = intra_rack_bw / ratio
    combine_bytes_per_s: float = 8e9,
) -> NetworkTopology:
    """The paper's leaf-spine testbed: servers under ToR switches under a spine."""
    n = workers_per_server * servers_per_rack * racks
    return NetworkTopology(levels=(
        Level("server", workers_per_server, intra_server_bw, 2e-6, combine_bytes_per_s),
        Level("rack", workers_per_server * servers_per_rack, intra_rack_bw, 10e-6,
              combine_bytes_per_s),
        Level("global", n, intra_rack_bw / oversubscription, 20e-6, combine_bytes_per_s),
    ))


def fat_tree(
    workers_per_server: int,
    servers_per_edge: int,
    edges_per_pod: int,
    pods: int,
    *,
    intra_server_bw: float = 12.5e9,
    edge_bw: float = 1.25e9,              # server NIC under the edge (ToR) switch
    edge_oversubscription: float = 4.0,   # edge uplinks : host ports
    core_oversubscription: float = 4.0,   # core links : aggregated edge uplinks
    combine_bytes_per_s: float = 8e9,
) -> NetworkTopology:
    """An oversubscribed fat-tree: server < edge (ToR) < pod (agg) < core.

    Deeper than the paper's testbed, shaped like a Clos data center where
    oversubscription compounds: crossing the edge layer divides per-worker
    bandwidth by ``edge_oversubscription``, and crossing the core divides it
    again by ``core_oversubscription``.  Adaptive templates see four boundaries,
    so three local-combine decisions get exercised per shuffle — the scenario
    where one plan instantiation is most expensive and caching pays most.
    """
    per_edge = workers_per_server * servers_per_edge
    per_pod = per_edge * edges_per_pod
    n = per_pod * pods
    agg_bw = edge_bw / edge_oversubscription
    core_bw = agg_bw / core_oversubscription
    return NetworkTopology(levels=(
        Level("server", workers_per_server, intra_server_bw, 2e-6,
              combine_bytes_per_s),
        Level("edge", per_edge, edge_bw, 10e-6, combine_bytes_per_s),
        Level("pod", per_pod, agg_bw, 20e-6, combine_bytes_per_s),
        Level("core", n, core_bw, 30e-6, combine_bytes_per_s),
    ))


def multipod_dcn(
    chips_per_host: int,
    hosts_per_pod: int,
    pods: int,
    *,
    ici_bw: float = TPU_ICI_BW_PER_LINK,
    host_bw: float = TPU_ICI_BW_PER_LINK / 2,
    dcn_bw: float = TPU_DCN_BW_PER_CHIP,
    combine_bytes_per_s: float = TPU_HBM_BW,
) -> NetworkTopology:
    """Multi-pod TPU DCN: host (ICI) < pod (reduced ICI) < dcn (inter-pod NICs).

    The accelerator-era analogue of the paper's oversubscribed leaf-spine: ICI
    inside a pod is orders of magnitude faster than the data-center network
    between pods, so cross-pod shuffles (MoE expert dispatch, cross-pod gradient
    sync) are exactly the regime where hierarchical combining wins.  Unlike
    :func:`from_mesh_axes` (which mirrors a specific jax mesh), this models the
    physical machine room: chips within a host, hosts within a pod, pods across
    the DCN.
    """
    per_pod = chips_per_host * hosts_per_pod
    n = per_pod * pods
    return NetworkTopology(levels=(
        Level("host", chips_per_host, ici_bw, 1e-6, combine_bytes_per_s),
        Level("pod", per_pod, host_bw, 5e-6, combine_bytes_per_s),
        Level("dcn", n, dcn_bw, 50e-6, combine_bytes_per_s),
    ))


def from_mesh_axes(
    axis_sizes: dict[str, int],
    *,
    ici_bw: float = TPU_ICI_BW_PER_LINK,
    dcn_bw: float = TPU_DCN_BW_PER_CHIP,
) -> NetworkTopology:
    """Map a TPU mesh onto the hierarchy: `model` (fast TP axis) < `data` < `pod`.

    The `pod` boundary is the DCN — the oversubscribed link of the TPU world.
    """
    model = axis_sizes.get("model", 1)
    data = axis_sizes.get("data", 1)
    pod = axis_sizes.get("pod", 1)
    levels = [
        Level("model", model, ici_bw, 1e-6, TPU_HBM_BW),
        Level("data", model * data, ici_bw / 2, 2e-6, TPU_HBM_BW),
    ]
    if pod > 1:
        levels.append(Level("pod", model * data * pod, dcn_bw, 50e-6, TPU_HBM_BW))
    return NetworkTopology(levels=tuple(levels))


def degrade_links(topo: NetworkTopology, level_name: str, failed_fraction: float) -> NetworkTopology:
    """Model link failures (paper §5.2): surviving links carry the load, so the
    effective per-worker bandwidth at that boundary drops proportionally."""
    if not 0.0 <= failed_fraction < 1.0:
        raise ValueError(f"failed_fraction must be in [0,1): {failed_fraction}")
    new_levels = []
    for lv in topo.levels:
        if lv.name == level_name:
            lv = dataclasses.replace(lv, bw_bytes_per_s=lv.bw_bytes_per_s * (1 - failed_fraction))
        new_levels.append(lv)
    return NetworkTopology(levels=tuple(new_levels))


def roofline_times(flops: float, hbm_bytes: float, coll_bytes: float, chips: int) -> dict:
    """The three roofline terms (seconds) for a compiled step on `chips` chips."""
    return {
        "compute_s": flops / (chips * TPU_PEAK_FLOPS_BF16),
        "memory_s": hbm_bytes / (chips * TPU_HBM_BW),
        "collective_s": coll_bytes / (chips * TPU_ICI_BW_PER_LINK),
    }


def dominant_term(terms: dict) -> str:
    keys = ("compute_s", "memory_s", "collective_s")
    return max(keys, key=lambda k: terms[k])


def roofline_fraction(terms: dict) -> float:
    """Fraction of the step bounded by the dominant term (useful-time / total if the
    three terms overlapped perfectly; the score we hillclimb)."""
    total = max(terms[k] for k in ("compute_s", "memory_s", "collective_s"))
    if total == 0:
        return 1.0
    return terms["compute_s"] / total if total else 1.0


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def align_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
