"""COMB for + on the card: ``segment_combine`` (source: ``csrc/combine.cu``).

Sums the rows of ``vals [n, d]`` into ``[num_segments, d]`` by ``seg_ids
[n]``; ids outside ``[0, num_segments)`` (the -1 drop id) are dropped.  Any
id order is taken; sorted ids make the fewest reductions.  Accumulates in
float32 and returns the input dtype.  A row may be at most 36,864 bytes
wide (d 9,216 in float32).

The kernel (``csrc/combine.cu``) is one launch of persistent blocks that
take tiles of :func:`tile_rows` rows in order from a counter on the device
(the fold's: one per stream, left zeroed by every launch): a producer warp
stages each tile's ids and vals in a ring of shared memory by bulk copies,
and the consumer warps sum its runs of equal ids, joining the runs that
cross their chunks by a scan over the lanes, and add each run to the
output by vector reductions.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.segment_combine_ref`).  Any other device,
dtype or layout raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .fold import _stream_state
from .ref import segment_combine_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    f = _build.library("combine").teshu_segment_combine
    if f.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        f.argtypes = [p, p, p, p, p, i64, i64, i64, ctypes.c_int,
                      ctypes.c_int, p]
        f.restype = ctypes.c_int
    return f


@functools.lru_cache(maxsize=None)
def tile_rows(d: int, dtype: torch.dtype) -> int:
    """Rows of a tile of the kernel at width ``d`` (0: a row of ``d`` is too
    wide for a stage)."""
    f = _build.library("combine").teshu_segment_combine_tile_rows
    if f.argtypes is None:
        f.argtypes = [ctypes.c_int64, ctypes.c_int]
        f.restype = ctypes.c_int64
    return int(f(d, dtype.itemsize))


def segment_combine(seg_ids: torch.Tensor, vals: torch.Tensor, *,
                    num_segments: int) -> torch.Tensor:
    """Sum ``vals`` rows into ``num_segments`` buckets by ``seg_ids``."""
    if (vals.dim() != 2 or seg_ids.dim() != 1
            or seg_ids.shape[0] != vals.shape[0]):
        raise ValueError(f"COMB wants seg_ids [n] and vals [n, d]: "
                         f"{tuple(seg_ids.shape)} {tuple(vals.shape)}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0: {num_segments}")
    if seg_ids.device != vals.device:
        raise ValueError(f"seg_ids on {seg_ids.device}, vals on {vals.device}")
    if vals.device.type == "cpu":
        return segment_combine_ref(seg_ids, vals, num_segments=num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"COMB runs on cuda or cpu tensors, not {vals.device}")
    if seg_ids.dtype != torch.int32 or vals.dtype not in _DTYPES:
        raise TypeError(f"COMB wants int32 seg_ids and float32/bfloat16 vals: "
                        f"{seg_ids.dtype} {vals.dtype}")
    if not (seg_ids.is_contiguous() and vals.is_contiguous()):
        raise ValueError("COMB wants contiguous seg_ids and vals")
    n, d = vals.shape
    if n and d and tile_rows(d, vals.dtype) == 0:
        raise ValueError(f"COMB takes rows of at most 36,864 bytes: d {d} "
                         f"of {vals.dtype}")
    out = torch.empty((num_segments, d), dtype=vals.dtype, device=vals.device)
    acc = out if vals.dtype == torch.float32 else torch.empty(
        (num_segments, d), dtype=torch.float32, device=vals.device)
    stream = _build.stream_of(vals)
    counter, sms = _stream_state(vals.device, stream)
    _build.check(_fn()(seg_ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
                       acc.data_ptr(), counter.data_ptr(), n, d, num_segments,
                       _DTYPES[vals.dtype], sms, stream),
                 "segment_combine")
    segment_combine.launches += 1
    return out


segment_combine.launches = 0
