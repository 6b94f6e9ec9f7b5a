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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import FOLD_OPS, segmented_fold_ref


def _fn():
    f = _build.library("fold").teshu_segmented_fold
    if f.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        f.argtypes = [p, p, p, i64, i64, ctypes.c_int, p]
        f.restype = ctypes.c_int
    return f


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
    n, d = vals.shape
    out = torch.empty_like(vals)
    _build.check(_fn()(is_start.data_ptr(), vals.data_ptr(), out.data_ptr(),
                       n, d, FOLD_OPS.index(op), _build.stream_of(vals)),
                 "segmented_fold")
    segmented_fold.launches += 1
    return out


segmented_fold.launches = 0
