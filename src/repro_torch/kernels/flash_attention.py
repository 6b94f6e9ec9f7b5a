"""Prefill attention on the card: ``flash_attention`` (source:
``csrc/flash_attention.cu``).

``flash_attention(q, k, v)`` computes ``softmax(q k^T * scale) v`` for
``q [BHq, Sq, D]`` against ``k, v [BHkv, Skv, D]``: q head ``bh`` reads kv
head ``bh // (BHq / BHkv)`` (GQA, no replication), and the queries are
end-aligned with the keys, so with ``causal`` row ``i`` sees the columns
``<= i + Skv - Sq``.  With a sliding ``window`` (> 0) row ``i`` also sees
only the columns ``> i + Skv - Sq - window``, and the kernel reads only the
kv tiles that meet a block's windows.  The math is float32; the result has
q's dtype.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); a meta tensor is
checked as a CUDA one is and gets an empty meta result of the kernel's
shape and dtype.  Any other device, dtype or layout raises.  On a CUDA or
a meta tensor the call's work (:func:`.work.flash_work`) goes to the active
counters (:data:`.work.COUNTERS`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, work
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)          # the kernel's compiled head widths


def _fn():
    f = _build.library("flash_attention").teshu_flash_attention
    if f.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i32, i32,
                      ctypes.c_float, i32, i64, p]
        f.restype = ctypes.c_int
    return f


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Attention of ``q [BHq, Sq, D]`` over ``k, v [BHkv, Skv, D]``."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash attention wants q [BHq, Sq, D] and k, v "
                         f"[BHkv, Skv, D]: {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    bhq, sq, d = q.shape
    bhkv, skv, dk = k.shape
    if dk != d or bhkv == 0 or bhq % bhkv:
        raise ValueError(f"q heads must be a multiple of kv heads with one "
                         f"head width: {tuple(q.shape)} {tuple(k.shape)}")
    if skv == 0 or (causal and sq > skv):
        raise ValueError(f"need 0 < Skv, and Sq <= Skv when causal: "
                         f"Sq={sq} Skv={skv}")
    window = int(window)
    if not 0 <= window <= 1 << 30:
        raise ValueError(f"window must be 0 (none) or a width in [1, 2^30]: "
                         f"{window}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    scale = (d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention runs on cuda, cpu or meta "
                         f"tensors, not {q.device}")
    _build.refuse_autograd("flash_attention", q, k, v)
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"flash attention wants float32/bfloat16 q and k, v "
                        f"of one such dtype: {q.dtype} {k.dtype} {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head width {d} not compiled (have {HEAD_DIMS})")
    if bhq > 65535:
        raise ValueError(f"BHq = {bhq} exceeds the grid's 65535")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention wants contiguous, 16-byte "
                             "aligned q, k and v")
    out = torch.empty_like(q)
    if sq == 0 or bhq == 0:
        return out
    if work.COUNTERS:
        work.report("flash_attention", *work.flash_work(
            bhq, sq, bhkv, skv, d, q.element_size(), k.element_size(), causal,
            window), (tuple(q.shape), tuple(k.shape)))
    if q.device.type == "meta":
        return out
    _build.check(_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), bhq, bhkv, sq, skv, d, _DTYPES[q.dtype],
                       _DTYPES[k.dtype], scale, int(causal), window,
                       _build.stream_of(q)),
                 "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
