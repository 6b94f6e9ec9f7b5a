"""Grouped matmul on the card: ``gmm`` (source: ``csrc/gmm.cu``), and its
companion ``route_and_pad``.

``gmm(x, w, tile_group_ids, block_n=...)`` multiplies row tile ``i`` of
``x [n, d]`` (rows ``[i * block_n, (i + 1) * block_n)``) by
``w[tile_group_ids[i]]``, ``w [G, d, f]``: the MoE expert FFN once the
tokens are sorted by expert and each expert's rows padded to a multiple of
``block_n``.  The math is float32; the result has x's dtype.  Any order of
group ids is allowed (repeated ids, groups with no tile).  ``block_n`` is
any positive multiple of 16; the reference's ``block_d`` and ``block_f`` are
TPU tiling and have no counterpart.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.gmm_ref`); a meta tensor is checked as a
CUDA one is and gets an empty meta result of the kernel's shape and dtype.
Any other device, dtype or layout raises.  On a CUDA or a meta tensor the
call's work (:func:`.work.gmm_work`) goes to the active counters
(:data:`.work.COUNTERS`): on the card the groups its ids use, read only
while a counter is active; on meta, whose ids hold no values, the groups
of the layout the caller states (``group_tiles``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, work
from .ref import gmm_ref

DEFAULT_BLOCK_N = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    f = _build.library("gmm").teshu_gmm
    if f.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        f.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, ctypes.c_int, p]
        f.restype = ctypes.c_int
    return f


def gmm(x: torch.Tensor, w: torch.Tensor, tile_group_ids: torch.Tensor, *,
        block_n: int = DEFAULT_BLOCK_N, group_tiles: int | None = None
        ) -> torch.Tensor:
    """``[n, d] x [G, d, f] -> [n, f]``, row tile ``i`` times
    ``w[tile_group_ids[i]]``.  ``group_tiles``: the caller's statement that
    the ids are that many tiles of each group in turn, which meta ids,
    holding no values, need."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm wants x [n, d] and w [G, d, f]: "
                         f"{tuple(x.shape)} {tuple(w.shape)}")
    n, d = x.shape
    groups, _, f = w.shape
    if block_n <= 0 or block_n % 16:
        raise ValueError(f"block_n must be a positive multiple of 16: "
                         f"{block_n}")
    if n % block_n or tile_group_ids.shape != (n // block_n,):
        raise ValueError(f"need n = {n} a multiple of block_n = {block_n} "
                         f"and one group id per tile: ids "
                         f"{tuple(tile_group_ids.shape)}")
    if tile_group_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"group ids must be int32 or int64: "
                        f"{tile_group_ids.dtype}")
    if not x.device == w.device == tile_group_ids.device:
        raise ValueError(f"x on {x.device}, w on {w.device}, ids on "
                         f"{tile_group_ids.device}")
    if x.device.type == "cpu":
        return gmm_ref(x, w, tile_group_ids, block_n=block_n,
                       group_tiles=group_tiles)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"gmm runs on cuda, cpu or meta tensors, not "
                         f"{x.device}")
    _build.refuse_autograd("gmm", x, w)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gmm wants float32 or bfloat16 x and w of one "
                        f"dtype: {x.dtype} {w.dtype}")
    if d == 0 or f == 0 or groups == 0:
        raise ValueError(f"gmm wants d, f and G > 0: {tuple(w.shape)}")
    if x.dtype == torch.bfloat16 and (d % 8 or f % 8):
        raise ValueError(f"bfloat16 gmm wants d and f multiples of 8 "
                         f"(16-byte rows): d={d} f={f}")
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gmm wants contiguous, 16-byte aligned x and w")
    if x.device.type == "meta" and (
            group_tiles is None or groups * group_tiles != n // block_n):
        raise ValueError(f"meta group ids hold no values: state their "
                         f"layout (group_tiles {group_tiles} for {groups} "
                         f"groups, {n // block_n} ids)")
    out = torch.empty((n, f), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    if work.COUNTERS:
        used = groups if x.device.type == "meta" else \
            work.distinct(tile_group_ids)
        work.report("gmm", *work.gmm_work(n, d, f, used, x.element_size(),
                                          w.element_size()),
                    (tuple(x.shape), tuple(w.shape)))
    if x.device.type == "meta":
        return out
    ids = tile_group_ids.to(torch.int32).contiguous()
    _build.check(_fn()(x.data_ptr(), w.data_ptr(), ids.data_ptr(),
                       out.data_ptr(), n, d, f, groups, block_n,
                       _DTYPES[x.dtype], _build.stream_of(x)), "gmm")
    gmm.launches += 1
    return out


gmm.launches = 0


def positions_in_group(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(order, pos)``: the stable order of ``ids [n]`` by value, and for
    each entry of that order its rank among the entries of equal id (so
    ``pos[j]`` counts the earlier entries, in input order, of
    ``ids[order[j]]``)."""
    order = torch.sort(ids, stable=True).indices
    sorted_ids = ids[order]
    pos = torch.arange(ids.shape[0], device=ids.device) \
        - torch.searchsorted(sorted_ids, sorted_ids, side="left")
    return order, pos


def route_and_pad(expert_ids: torch.Tensor, num_experts: int,
                  block_n: int = DEFAULT_BLOCK_N, *, capacity_tiles: int):
    """Sort rows by expert with per-expert padding, as the reference's
    ``route_and_pad`` (``src/repro/kernels/gmm.py``): returns
    ``(rows [E * cap] int32, tile_group_ids [E * capacity_tiles] int32,
    valid [E * cap] bool)`` with ``cap = capacity_tiles * block_n``.  Slot
    ``e * cap + p`` holds the ``p``-th row (in input order) routed to expert
    ``e``, or ``n`` (the padding row) where there is none; rows past an
    expert's capacity are dropped."""
    if expert_ids.dim() != 1:
        raise ValueError(f"expert ids must be [n]: {tuple(expert_ids.shape)}")
    n = expert_ids.shape[0]
    if n and not 0 <= int(expert_ids.min()) <= int(expert_ids.max()) \
            < num_experts:
        raise ValueError(f"expert ids must lie in [0, {num_experts})")
    cap = capacity_tiles * block_n
    dev = expert_ids.device
    order, pos = positions_in_group(expert_ids)
    sorted_eids = expert_ids[order].long()
    keep = pos < cap
    slot = torch.where(keep, sorted_eids * cap + pos, num_experts * cap)
    rows = torch.full((num_experts * cap + 1,), n, dtype=torch.int32,
                      device=dev)
    rows[slot] = order.to(torch.int32)        # the last slot: overflow
    rows = rows[:num_experts * cap]
    tile_group_ids = (torch.arange(num_experts * capacity_tiles, device=dev)
                      // capacity_tiles).to(torch.int32)
    return rows, tile_group_ids, rows < n
