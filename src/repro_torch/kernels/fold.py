"""The ordered segmented fold on the card: ``segmented_fold`` (source:
``csrc/fold.cu``).

``segmented_fold(op, is_start, vals)`` folds float64 ``vals [n, d]`` with
``op`` in {"sum", "min", "max"} over segments that begin at every
``is_start`` row (and at row 0), strictly in row order: row ``r`` of the
result is the fold of its segment's rows up to ``r``.  MIN / MAX give
numpy's results (NaN propagates; on a tie the later row wins), so the fold
is bit-identical to :class:`repro_torch.core.messages.Combiner`.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.segmented_fold_ref`).  Any other device,
dtype or layout raises.

The kernel (``csrc/fold.cu``) is one launch of persistent blocks that take
tiles of rows in row order from a counter on the device: a producer warp
stages each tile's values in a ring of shared memory by bulk copies, the
consumer warps fold the segments that start in the tile in place, and the
producer stores the folded rows by bulk copies.  A segment that runs past
its tile is walked on by the block that owns its start while the producer
streams the next tiles ahead of its adds.  Every launch leaves the counter
zeroed for the next; each stream of a device has its own (two ``int64``,
zeroed once here), since launches on one stream never overlap and those on
two streams may.  ``out`` is placed at ``vals``' address modulo 16, the
layout both share in shared memory.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .ref import FOLD_OPS, segmented_fold_ref


def _fn():
    f = _build.library("fold").teshu_segmented_fold
    if f.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f.argtypes = [p, p, p, p, i64, i64, i32, i32, p]
        f.restype = ctypes.c_int
    return f


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}
_SMS: dict[int, int] = {}
_LOCK = threading.Lock()


def _stream_state(device: torch.device,
                  stream: int) -> tuple[torch.Tensor, int]:
    """The tile counter of ``stream``, the current stream of ``device``
    (zeroed once; every launch leaves it zeroed), and the device's
    multiprocessor count."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _LOCK:
        if (index, stream) not in _COUNTERS:   # zeroed on that stream
            _COUNTERS[index, stream] = torch.zeros(
                2, dtype=torch.int64, device=torch.device("cuda", index))
        if index not in _SMS:
            _SMS[index] = torch.cuda.get_device_properties(
                index).multi_processor_count
        return _COUNTERS[index, stream], _SMS[index]


def segmented_fold(op: str, is_start: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Ordered float64 left fold of ``vals`` over ``is_start`` segments."""
    if op not in FOLD_OPS:
        raise ValueError(f"unknown fold op {op!r} (ops: {FOLD_OPS})")
    if (vals.dim() != 2 or is_start.dim() != 1
            or is_start.shape[0] != vals.shape[0]):
        raise ValueError(f"fold wants is_start [n] and vals [n, d]: "
                         f"{tuple(is_start.shape)} {tuple(vals.shape)}")
    if is_start.device != vals.device:
        raise ValueError(f"is_start on {is_start.device}, vals on {vals.device}")
    if is_start.dtype != torch.bool or vals.dtype != torch.float64:
        raise TypeError(f"fold wants bool is_start and float64 vals: "
                        f"{is_start.dtype} {vals.dtype}")
    if vals.device.type == "cpu":
        return segmented_fold_ref(op, is_start, vals)
    if vals.device.type != "cuda":
        raise ValueError(f"fold runs on cuda or cpu tensors, not {vals.device}")
    if not (is_start.is_contiguous() and vals.is_contiguous()):
        raise ValueError("fold wants contiguous is_start and vals")
    if vals.data_ptr() % 8:
        raise ValueError("fold wants float64 vals on an 8-byte boundary")
    n, d = vals.shape
    # the kernel stages rows of vals and of out in one layout, so out sits
    # at vals' address modulo 16
    if vals.data_ptr() % 16:
        out = torch.empty(n * d + 1, dtype=vals.dtype,
                          device=vals.device)[1:].view(n, d)
    else:
        out = torch.empty_like(vals)
    stream = _build.stream_of(vals)
    counter, sms = _stream_state(vals.device, stream)
    _build.check(_fn()(is_start.data_ptr(), vals.data_ptr(), out.data_ptr(),
                       counter.data_ptr(), n, d, FOLD_OPS.index(op), sms,
                       stream),
                 "segmented_fold")
    segmented_fold.launches += 1
    return out


segmented_fold.launches = 0
