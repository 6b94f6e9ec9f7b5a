"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes exactly what its CUDA kernel computes, with stock
tensor operations.  The wrappers in :mod:`.partition`, :mod:`.combine` and
:mod:`.fold` run these only for tensors that lie on the CPU; on the card the
kernels run and ``chip_smoke.py`` holds them against these on the same inputs.
"""
from __future__ import annotations

import torch

FOLD_OPS = ("sum", "min", "max")


def partition_permute_ref(slots: torch.Tensor, vals: torch.Tensor, *,
                          num_out: int) -> torch.Tensor:
    """PART: scatter rows of ``vals [n, d]`` into ``[num_out, d]`` by
    ``slots [n]``; slots outside ``[0, num_out)`` are dropped, colliding
    slots sum.  Accumulates in float32, returns the input dtype."""
    ok = (slots >= 0) & (slots < num_out)
    out = torch.zeros((num_out, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, slots[ok].long(), vals[ok].float())
    return out.to(vals.dtype)


def segment_combine_ref(seg_ids: torch.Tensor, vals: torch.Tensor, *,
                        num_segments: int) -> torch.Tensor:
    """COMB for +: per-segment row sums ``[num_segments, d]``; ids outside
    ``[0, num_segments)`` (the -1 drop id) are dropped.  Accumulates in
    float32, returns the input dtype."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, seg_ids[ok].long(), vals[ok].float())
    return out.to(vals.dtype)


def fold_step(op: str, acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One left-fold step ``op(acc, v)`` with numpy's semantics: NaN
    propagates from either side, and on a tie (``0.0`` against ``-0.0``) the
    later operand ``v`` wins, as ``np.minimum`` / ``np.maximum`` give it."""
    if op == "sum":
        return acc + v
    if op == "min":
        return torch.where((acc < v) | acc.isnan(), acc, v)
    if op == "max":
        return torch.where((acc > v) | acc.isnan(), acc, v)
    raise ValueError(f"unknown fold op {op!r} (ops: {FOLD_OPS})")


def segmented_fold_ref(op: str, is_start: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """Ordered segmented left fold: row ``r`` of the result holds
    ``op``-fold of its segment's rows up to and including ``r``, folded
    strictly in row order (the segment's first row is the seed).  A segment
    begins at every ``is_start`` row, and at row 0.

    The loop runs over the position inside a segment: step ``p`` folds every
    row at position ``p`` onto the result of position ``p - 1`` at once, so
    it takes as many vectorised steps as the longest segment has rows."""
    n = vals.shape[0]
    out = vals.clone()
    if n == 0:
        return out
    idx = torch.arange(n, device=vals.device)
    start = is_start.clone()
    start[0] = True
    seg_start = torch.cummax(torch.where(start, idx, 0), 0).values
    pos = idx - seg_start
    order = torch.sort(pos, stable=True).indices
    bounds = torch.bincount(pos).cumsum(0).tolist()
    for p in range(1, len(bounds)):
        rows = order[bounds[p - 1]:bounds[p]]
        out[rows] = fold_step(op, out[rows - 1], vals[rows])
    return out
