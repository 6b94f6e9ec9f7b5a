"""A Pregel-style vertex-message engine whose shuffle layer IS TeShu.

This is the paper's evaluation vehicle (§5: an open-source Pregel running PageRank
and SSSP over large graphs).  Vertices are hash-partitioned across workers with the
shuffle's own ``partFunc`` — so a message's destination worker and its sampling group
are derived from the same consistent hash, exactly the Figure-4 setup.

Per superstep: **compute** (vertex programs emit messages), **combine+shuffle**
(one TeShu ``shuffle`` invocation; the template decides whether/where to combine),
**deliver** (combined messages become next superstep's inbox).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import (HASH_PART, Combiner, Msgs, TeShuService)
from repro_torch.core.messages import splitmix64


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Graph:
    num_vertices: int
    src: np.ndarray        # int64 [E]
    dst: np.ndarray        # int64 [E]

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices).astype(np.int64)


def rmat_graph(num_vertices: int, num_edges: int, *, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """R-MAT generator — the standard power-law synthetic used for web/social graphs
    (UK-Web / Friendster stand-ins at container scale)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(2, num_vertices))))
    d = 1.0 - a - b - c
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for _ in range(scale):
        src_bit = rng.random(num_edges) >= (a + b)              # quadrant row
        p_dst1 = np.where(src_bit, d / (c + d), b / (a + b))    # quadrant column
        dst_bit = rng.random(num_edges) < p_dst1
        src = (src << 1) | src_bit.astype(np.int64)
        dst = (dst << 1) | dst_bit.astype(np.int64)
    src %= num_vertices
    dst %= num_vertices
    keep = src != dst
    return Graph(num_vertices, src[keep], dst[keep])


# ---------------------------------------------------------------------------
# Vertex programs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """Gather-apply-scatter vertex semantics, vectorized per worker shard."""

    name: str
    combiner: Combiner
    init: Callable[[np.ndarray, Graph], np.ndarray]          # vertex ids -> state
    # (state, combined inbox vals aligned to local vertices, superstep, graph) -> state
    apply: Callable[[np.ndarray, np.ndarray, int, Graph], np.ndarray]
    # (local vertex ids, state, local edges (src,dst), outdeg) -> Msgs keyed by dst vertex
    scatter: Callable[[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray], Msgs]
    inbox_default: float = 0.0
    max_supersteps: int = 10


class PregelEngine:
    def __init__(self, graph: Graph, service: TeShuService, *,
                 template_id: str = "vanilla_push", rate: float = 0.01):
        self.graph = graph
        self.svc = service
        self.template_id = template_id
        self.rate = rate
        self.nw = service.topology.num_workers
        self.workers = list(range(self.nw))
        # Vertex placement = the shuffle's partFunc — consistent with SAMP groups.
        self.v_owner = HASH_PART.assign(np.arange(graph.num_vertices, dtype=np.int64),
                                        self.nw)
        self.local_vertices = [np.nonzero(self.v_owner == w)[0].astype(np.int64)
                               for w in self.workers]
        # Edges live with their source vertex (scatter is source-local).
        e_owner = self.v_owner[graph.src]
        self.local_edges = [(graph.src[e_owner == w], graph.dst[e_owner == w])
                            for w in self.workers]
        self.outdeg = graph.out_degree()
        self.decisions: list = []

    def run(self, program: VertexProgram, *, supersteps: int | None = None) -> np.ndarray:
        """Run to completion; returns the global vertex state array."""
        steps = supersteps or program.max_supersteps
        state = [program.init(lv, self.graph) for lv in self.local_vertices]
        inbox: dict[int, Msgs] = {w: Msgs.empty() for w in self.workers}

        def deliver_and_apply(w: int, step: int) -> None:
            lv = self.local_vertices[w]
            vals = np.full((lv.shape[0],), program.inbox_default, dtype=np.float64)
            ib = inbox[w]
            if ib.n:
                pos = _index_of(ib.keys, lv)
                vals[pos] = ib.vals[:, 0]
            state[w] = program.apply(state[w], vals, step, self.graph)

        for step in range(steps):
            out_bufs: dict[int, Msgs] = {}
            for w in self.workers:
                deliver_and_apply(w, step)
                es, ed = self.local_edges[w]
                out_bufs[w] = program.scatter(self.local_vertices[w], state[w],
                                              es, ed, self.outdeg)
            res = self.svc.shuffle(
                self.template_id, out_bufs, self.workers, self.workers,
                part_fn=HASH_PART, comb_fn=program.combiner, rate=self.rate,
                seed=step)
            self.decisions.append(res.decisions)
            inbox = {w: res.bufs.get(w, Msgs.empty()) for w in self.workers}
        for w in self.workers:               # last round of messages lands in state
            deliver_and_apply(w, steps)
        final = np.zeros(self.graph.num_vertices, dtype=np.float64)
        for w in self.workers:
            final[self.local_vertices[w]] = state[w]
        return final


def _index_of(keys: np.ndarray, universe: np.ndarray) -> np.ndarray:
    """Positions of ``keys`` inside sorted-unique ``universe`` (vertices are unique)."""
    order = np.argsort(universe)
    pos = np.searchsorted(universe[order], keys)
    return order[pos]
