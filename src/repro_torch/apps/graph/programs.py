"""PageRank and SSSP vertex programs (the paper's §5 workloads)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import MIN, SUM, Msgs

from .engine import Graph, VertexProgram, _index_of

_DAMPING = 0.85
_INF = np.float64(1e30)


# ---------------------------------------------------------------------------
# PageRank: combiner = SUM of rank contributions per destination vertex
# ---------------------------------------------------------------------------

def _pr_init(lv: np.ndarray, g: Graph) -> np.ndarray:
    return np.full(lv.shape[0], 1.0 / g.num_vertices, dtype=np.float64)


def _pr_apply(state: np.ndarray, inbox: np.ndarray, step: int, g: Graph) -> np.ndarray:
    if step == 0:                        # nothing received yet; keep the uniform init
        return state
    return (1.0 - _DAMPING) / g.num_vertices + _DAMPING * inbox


def _pr_scatter(lv: np.ndarray, state: np.ndarray, es: np.ndarray, ed: np.ndarray,
                outdeg: np.ndarray) -> Msgs:
    if es.shape[0] == 0:
        return Msgs.empty()
    local_idx = _index_of(es, lv)
    contrib = state[local_idx] / np.maximum(1, outdeg[es])
    return Msgs(ed, contrib)


def PageRank(supersteps: int = 10) -> VertexProgram:
    return VertexProgram(
        name="pagerank", combiner=SUM, init=_pr_init, apply=_pr_apply,
        scatter=_pr_scatter, inbox_default=0.0, max_supersteps=supersteps)


# ---------------------------------------------------------------------------
# SSSP: combiner = MIN of tentative distances per destination vertex
# ---------------------------------------------------------------------------

def _sssp_init_factory(source: int):
    def init(lv: np.ndarray, g: Graph) -> np.ndarray:
        st = np.full(lv.shape[0], _INF, dtype=np.float64)
        st[lv == source] = 0.0
        return st
    return init


def _sssp_apply(state: np.ndarray, inbox: np.ndarray, step: int, g: Graph) -> np.ndarray:
    return np.minimum(state, inbox)


def _sssp_scatter(lv: np.ndarray, state: np.ndarray, es: np.ndarray, ed: np.ndarray,
                  outdeg: np.ndarray) -> Msgs:
    if es.shape[0] == 0:
        return Msgs.empty()
    local_idx = _index_of(es, lv)
    dist = state[local_idx]
    active = dist < _INF                 # only settled frontiers relax edges
    return Msgs(ed[active], dist[active] + 1.0)


def SSSP(source: int = 0, supersteps: int = 10) -> VertexProgram:
    return VertexProgram(
        name="sssp", combiner=MIN, init=_sssp_init_factory(source),
        apply=_sssp_apply, scatter=_sssp_scatter, inbox_default=_INF,
        max_supersteps=supersteps)
