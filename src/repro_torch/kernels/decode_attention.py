"""Decode attention on the card: ``decode_attention`` (source:
``csrc/decode_attention.cu``).

``decode_attention(q, k, v, valid_len)`` attends one new token per sequence,
``q [B, H, d]``, over a cache ``k, v [B, T, KVH, d]`` whose positions
``>= valid_len`` are masked; q head ``h`` reads kv head ``h // (H / KVH)``.
With a sliding ``window`` (> 0) the positions ``< valid_len - window`` are
masked too, and both kernels read only the window's tiles.  The math is
float32; the result has q's dtype.

The kernel is chosen by dtype and head width only.  bf16 q and cache at
head width 64 or 128, with at most 48 q heads per kv head, take
``decode_tma``: one launch whose grid depends on the shapes and the SM
count only, each block working out its share of the valid positions from
``valid_len`` on the device and the last block of each (batch, kv head)
merging the splits (:func:`split_plan` mirrors its rule).  ``valid_len`` is
a Python int (passed by value) or a 0-dim int32 tensor on q's device, which
the kernel reads: with a tensor the wrapper checks nothing on the host, and
a value outside ``[1, T]`` gives NaN rows.  Anything else takes
``decode_split`` (and ``decode_combine``), whose split plan is made on the
host from ``int(valid_len)``.

A CUDA tensor launches a kernel; a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); a meta tensor is
checked as a CUDA one is (but for the head widths and groups the built
library takes, which only the card's library answers) and gets an empty
meta result of the kernel's shape and dtype, with ``valid_len`` an int.
Any other device, dtype or layout raises.

``return_lse=True`` takes the log-sum-exp route, for a cache split into
blocks whose outputs are merged afterwards (``models.layers``, over
``model`` ranks that each hold a block of ``T``): the call returns ``(out,
lse)``, ``out`` float32 whatever q's dtype (a block's output is not rounded
before the merge) and ``lse [B, H]`` float32, the natural log of the sum of
``exp(scale q.k)`` over the positions the row attended.  Both kernels
write them.  There an int ``valid_len`` of 0 (a block with no valid row)
is taken: the result is zeros and ``-inf``, with no launch (the kernels
take ``1 <= valid_len <= T``).  :func:`block_window` gives a block its
valid rows and its own window, and :func:`merge_blocks` merges the blocks.

On a CUDA or a meta tensor the
call's work (:func:`.work.decode_work`) goes to the active counters
(:data:`.work.COUNTERS`; a ``valid_len`` tensor is read for it, on the
host, only while one is active).  The per-pair counters of ``decode_tma``
live in one zeroed buffer per device, which each launch leaves zeroed:
launches that share a device run in one stream's order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, work
from .ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                    # cache positions per tile (kTTile, kTile)
BLOCKS_PER_SM = 1            # decode_tma's grid: one block an SM holds
SPLIT_BLOCKS_PER_SM = 2      # decode_split's plan aims at this many


def _lib():
    lib = _build.library("decode_attention")
    f = lib.teshu_decode_attention
    if f.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64,
                      i64, i64, i32, i32, ctypes.c_float, p]
        f.restype = ctypes.c_int
        lib.teshu_decode_attention_fits.argtypes = [i64, i64, i32]
        lib.teshu_decode_attention_fits.restype = i32
        lib.teshu_decode_attention_tma.argtypes = [
            p, p, p, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, i64,
            ctypes.c_float, p]
        lib.teshu_decode_attention_tma.restype = ctypes.c_int
        lib.teshu_decode_attention_tma_fits.argtypes = [i64, i64]
        lib.teshu_decode_attention_tma_fits.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grid_splits(pairs: int, t_len: int, sms: int) -> int:
    """Blocks per (batch, kv head) pair in ``decode_tma``'s grid: enough
    for the ``pairs`` to give the card about ``BLOCKS_PER_SM`` blocks an
    SM, and no more than the ``T``-position cache has tiles."""
    return max(1, min(-(-t_len // TILE), int(BLOCKS_PER_SM * sms) // pairs))


def window_start(valid: int, window: int) -> int:
    """The first attended position: ``valid - window`` with a sliding
    window, else 0."""
    return max(0, valid - window) if window else 0


def split_plan(pairs: int, valid: int, t_len: int, sms: int, window: int = 0
               ) -> tuple[int, list[tuple[int, int]]]:
    """The Python mirror of ``decode_tma``'s in-kernel rule: (the grid's
    blocks per pair, the ``[first, end)`` positions of each working split).
    The attended positions are ``[lo, valid)`` (``lo`` from
    :func:`window_start`); the ``tiles`` 64-position tiles from ``lo``'s,
    ``f = lo // 64``, up to ``ceil(valid / 64)`` are cut into ``n =
    min(tiles, grid)`` runs, split ``s`` taking tiles ``f + [s tiles / n,
    (s + 1) tiles / n)``; blocks ``n ..`` of a pair have no work."""
    grid = grid_splits(pairs, t_len, sms)
    lo = window_start(valid, window)
    f = lo // TILE
    tiles = -(-valid // TILE) - f
    n = min(tiles, grid)
    return grid, [(max(lo, (f + s * tiles // n) * TILE),
                   min(valid, (f + (s + 1) * tiles // n) * TILE))
                  for s in range(n)]


def _split_plan_host(pairs: int, valid: int, sms: int,
                     window: int = 0) -> tuple[int, int]:
    """``decode_split``'s plan: (tiles per split, splits), enough splits to
    give the card about ``SPLIT_BLOCKS_PER_SM`` blocks per SM, every split
    starting below ``valid``; the tiles counted from the window's first."""
    tiles = -(-valid // TILE) - window_start(valid, window) // TILE
    want = max(1, -(-SPLIT_BLOCKS_PER_SM * sms // pairs))
    per = -(-tiles // min(tiles, want))
    return per, -(-tiles // per)


_COUNTERS: dict[int, torch.Tensor] = {}


def _counters(device: torch.device, pairs: int) -> torch.Tensor:
    """The per-pair counters of ``decode_tma`` on ``device``: one zeroed
    int32 buffer, grown (zeroed again) when a launch has more pairs."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    buf = _COUNTERS.get(index)
    if buf is None or buf.numel() < pairs:
        buf = torch.zeros(max(pairs, 1024), dtype=torch.int32, device=device)
        _COUNTERS[index] = buf
    return buf


def block_window(valid: int, offset: int, rows: int, window: int = 0
                 ) -> tuple[int, int]:
    """``(valid rows, window)`` of the cache block that holds positions
    ``[offset, offset + rows)`` of a cache whose first ``valid`` positions
    are valid, under a sliding ``window`` (0: none): the block's valid rows
    ``clamp(valid - offset, 0, rows)``, and the window to pass for them so
    that the block attends from the whole cache's first attended position
    ``valid - window``, which lies ``start = max(0, valid - window -
    offset)`` rows into the block: ``v_r - start`` (0 where the window
    starts at or before the block).  A block wholly left of the window, or
    past ``valid``, has no valid row: ``(0, 0)``."""
    v_r = min(max(valid - offset, 0), rows)
    start = max(0, valid - window - offset) if window else 0
    if start >= v_r:
        return 0, 0
    return v_r, (v_r - start if start else 0)


def merge_blocks(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Merge the blocks of one decode: ``outs [n, B, H, d]`` float32 (each
    block's output over its own rows) and ``lses [n, B, H]`` (their
    log-sum-exps; ``-inf`` for a block with no row) into ``[B, H, d]``
    float32: ``sum_i exp(lse_i - M) out_i / sum_i exp(lse_i - M)``, ``M``
    the largest ``lse_i``.  Elementwise ops in block order, the same
    result on every rank that merges the same blocks."""
    top = lses.amax(0)
    w = torch.exp(lses - top)
    return (w[..., None] * outs).sum(0) / w.sum(0)[..., None]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len, *, scale: float | None = None,
                     window: int = 0, return_lse: bool = False):
    """One-token attention of ``q [B, H, d]`` over ``k, v [B, T, KVH, d]``;
    ``return_lse``: ``(out float32, lse [B, H] float32)``."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode attention wants q [B, H, d] and k, v "
                         f"[B, T, KVH, d]: {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    kb, t, kvh, dk = k.shape
    if kb != b or dk != d or kvh == 0 or h % kvh:
        raise ValueError(f"q and the cache disagree: {tuple(q.shape)} "
                         f"{tuple(k.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    window = int(window)
    if not 0 <= window <= 1 << 30:
        raise ValueError(f"window must be 0 (none) or a width in [1, 2^30]: "
                         f"{window}")
    on_device = isinstance(valid_len, torch.Tensor) and valid_len.is_cuda
    if on_device:
        if valid_len.dim() != 0 or valid_len.dtype != torch.int32 \
                or valid_len.device != q.device:
            raise ValueError(f"a valid_len tensor must be 0-dim int32 on "
                             f"{q.device}: {valid_len.dtype} "
                             f"{tuple(valid_len.shape)} {valid_len.device}")
        valid = None
    else:
        valid = int(valid_len)
        if not (0 if return_lse else 1) <= valid <= t:
            raise ValueError(f"valid_len must lie in [1, T={t}]: {valid}")
    scale = (d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid, scale=scale, window=window,
                                    return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode attention runs on cuda, cpu or meta "
                         f"tensors, not {q.device}")
    _build.refuse_autograd("decode_attention", q, k, v)
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"decode attention wants float32/bfloat16 q and k, v "
                        f"of one such dtype: {q.dtype} {k.dtype} {v.dtype}")
    if valid == 0:                       # an empty block: nothing launched
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full((b, h), -torch.inf, device=q.device))
    if work.COUNTERS and b:
        work.report("decode_attention", *work.decode_work(
            b, h, kvh, d, work.host_int(valid_len) if valid is None else valid,
            q.element_size(), k.element_size(), window, lse=return_lse),
            (tuple(q.shape), tuple(k.shape)))
    if q.device.type == "meta":
        if b * kvh > 65535:
            raise ValueError(f"B * KVH = {b * kvh} exceeds the grid's 65535")
        if not all(x.is_contiguous() for x in (q, k, v)):
            raise ValueError("decode attention wants contiguous q, k and v")
        if return_lse:
            return (torch.empty(q.shape, dtype=torch.float32, device="meta"),
                    torch.empty((b, h), dtype=torch.float32, device="meta"))
        return torch.empty_like(q)
    g = h // kvh
    lib = _lib()
    bf16 = torch.bfloat16
    tma = (q.dtype == k.dtype == bf16
           and bool(lib.teshu_decode_attention_tma_fits(g, d)))
    if not tma and not lib.teshu_decode_attention_fits(g, d, _DTYPES[k.dtype]):
        raise ValueError(f"head width {d} (a multiple of 8 is needed) with "
                         f"{g} q heads per kv head exceeds one block")
    if b * kvh > 65535:
        raise ValueError(f"B * KVH = {b * kvh} exceeds the grid's 65535")
    for x in (q, k, v):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("decode attention wants contiguous, 16-byte "
                             "aligned q, k and v")
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else q.dtype)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b == 0:
        return (out, lse) if return_lse else out
    lse_ptr = None if lse is None else lse.data_ptr()
    pairs = b * kvh
    sms = _sm_count(q.device.index or 0)
    if tma:
        grid = grid_splits(pairs, t, sms)
        part_acc = part_ml = counters = None
        if grid > 1:
            part_acc = torch.empty((pairs, grid, g, d), dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty((pairs, grid, g, 2), dtype=torch.float32,
                                  device=q.device)
            counters = _counters(q.device, pairs)
        _build.check(lib.teshu_decode_attention_tma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if counters is None else counters.data_ptr(),
            valid_len.data_ptr() if on_device else None, lse_ptr,
            0 if on_device else valid, b, t, kvh, g, d, window, grid, scale,
            _build.stream_of(q)), "decode_attention")
        decode_attention.launches += 1
        return (out, lse) if return_lse else out
    if valid is None:                    # decode_split plans on the host
        valid = int(valid_len)
        if not 1 <= valid <= t:
            raise ValueError(f"valid_len must lie in [1, T={t}]: {valid}")
    per, splits = _split_plan_host(pairs, valid, sms, window)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((pairs, splits, g, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((pairs, splits, g, 2), dtype=torch.float32,
                              device=q.device)
    _build.check(lib.teshu_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(), lse_ptr,
        b, t, kvh, g, d, valid, window_start(valid, window), per, splits,
        _DTYPES[q.dtype], _DTYPES[k.dtype], scale, _build.stream_of(q)),
        "decode_attention")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
