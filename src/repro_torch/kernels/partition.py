"""PART on the card: ``partition_permute`` (source: ``csrc/partition.cu``).

Scatters the rows of ``vals [n, d]`` into ``[num_out, d]`` by ``slots [n]``:
slots outside ``[0, num_out)`` are dropped, colliding slots sum in float32,
and the result has the input dtype.  ``unique_slots=True`` is the caller's
promise that no two rows share a slot (a permutation): the kernel then
builds the inverse of the slots in an int32 ``[num_out]`` scratch buffer
and gathers every output row from its source (zeros where no row lands),
with no memset of the output.  If two rows do share a slot despite the
promise, the output row holds one of them (the kernel keeps the one of the
largest row index; callers may not rely on which).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.partition_permute_ref`).  Any other device,
dtype or layout raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import partition_permute_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    f = _build.library("partition").teshu_partition_permute
    if f.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        f.argtypes = [p, p, p, p, i64, i64, i64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, p]
        f.restype = ctypes.c_int
    return f


def partition_permute(slots: torch.Tensor, vals: torch.Tensor, *,
                      num_out: int, unique_slots: bool = False) -> torch.Tensor:
    """Scatter rows of ``vals`` into a ``[num_out, d]`` buffer by ``slots``."""
    if vals.dim() != 2 or slots.dim() != 1 or slots.shape[0] != vals.shape[0]:
        raise ValueError(f"PART wants slots [n] and vals [n, d]: "
                         f"{tuple(slots.shape)} {tuple(vals.shape)}")
    if num_out < 0:
        raise ValueError(f"num_out must be >= 0: {num_out}")
    if slots.device != vals.device:
        raise ValueError(f"slots on {slots.device}, vals on {vals.device}")
    if vals.device.type == "cpu":
        return partition_permute_ref(slots, vals, num_out=num_out)
    if vals.device.type != "cuda":
        raise ValueError(f"PART runs on cuda or cpu tensors, not {vals.device}")
    if slots.dtype != torch.int32 or vals.dtype not in _DTYPES:
        raise TypeError(f"PART wants int32 slots and float32/bfloat16 vals: "
                        f"{slots.dtype} {vals.dtype}")
    if not (slots.is_contiguous() and vals.is_contiguous()):
        raise ValueError("PART wants contiguous slots and vals")
    n, d = vals.shape
    out = torch.empty((num_out, d), dtype=vals.dtype, device=vals.device)
    if unique_slots:          # the inverse of the slots: row i sits in int32
        if n > 2 ** 31 - 1:
            raise ValueError(f"PART with unique slots takes at most 2^31 - 1 "
                             f"rows: {n}")
        scratch = torch.empty((num_out,), dtype=torch.int32,
                              device=vals.device)
    elif vals.dtype == torch.float32:
        scratch = out
    else:
        scratch = torch.empty((num_out, d), dtype=torch.float32,
                              device=vals.device)
    chunk = 16 // vals.element_size()
    vec = int(d % chunk == 0 and vals.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    _build.check(_fn()(slots.data_ptr(), vals.data_ptr(), out.data_ptr(),
                       scratch.data_ptr(), n, d, num_out, _DTYPES[vals.dtype],
                       int(unique_slots), vec, _build.stream_of(vals)),
                 "partition_permute")
    partition_permute.launches += 1
    return out


partition_permute.launches = 0
