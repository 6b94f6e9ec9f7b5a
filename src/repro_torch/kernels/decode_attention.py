"""Decode attention on the card: ``decode_attention`` (source:
``csrc/decode_attention.cu``).

``decode_attention(q, k, v, valid_len)`` attends one new token per sequence,
``q [B, H, d]``, over a cache ``k, v [B, T, KVH, d]`` whose positions
``>= valid_len`` are masked; q head ``h`` reads kv head ``h // (H / KVH)``.
The math is float32; the result has q's dtype.  The wrapper splits the
valid positions over enough blocks to fill the card and the kernel merges
the splits.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`).  Any other device,
dtype or layout raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                    # cache positions per tile (kTile in the source)
BLOCKS_PER_SM = 2            # the split aims at this many blocks per SM


def _lib():
    lib = _build.library("decode_attention")
    f = lib.teshu_decode_attention
    if f.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64,
                      i64, i32, i32, ctypes.c_float, p]
        f.restype = ctypes.c_int
        lib.teshu_decode_attention_fits.argtypes = [i64, i64, i32]
        lib.teshu_decode_attention_fits.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(pairs: int, valid: int, sms: int) -> tuple[int, int]:
    """(tiles per split, splits) for ``pairs`` (batch, kv head) pairs over
    ``valid`` positions: enough splits to give the card about
    ``BLOCKS_PER_SM`` blocks per SM, every split starting below ``valid``."""
    tiles = -(-valid // TILE)
    want = max(1, -(-BLOCKS_PER_SM * sms // pairs))
    per = -(-tiles // min(tiles, want))
    return per, -(-tiles // per)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len, *, scale: float | None = None) -> torch.Tensor:
    """One-token attention of ``q [B, H, d]`` over ``k, v [B, T, KVH, d]``."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode attention wants q [B, H, d] and k, v "
                         f"[B, T, KVH, d]: {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    kb, t, kvh, dk = k.shape
    if kb != b or dk != d or kvh == 0 or h % kvh:
        raise ValueError(f"q and the cache disagree: {tuple(q.shape)} "
                         f"{tuple(k.shape)}")
    valid = int(valid_len)
    if not 1 <= valid <= t:
        raise ValueError(f"valid_len must lie in [1, T={t}]: {valid}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    scale = (d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"decode attention wants float32/bfloat16 q and k, v "
                        f"of one such dtype: {q.dtype} {k.dtype} {v.dtype}")
    g = h // kvh
    lib = _lib()
    if not lib.teshu_decode_attention_fits(g, d, _DTYPES[k.dtype]):
        raise ValueError(f"head width {d} (a multiple of 8 is needed) with "
                         f"{g} q heads per kv head exceeds one block")
    if b * kvh > 65535:
        raise ValueError(f"B * KVH = {b * kvh} exceeds the grid's 65535")
    for x in (q, k, v):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("decode attention wants contiguous, 16-byte "
                             "aligned q, k and v")
    out = torch.empty_like(q)
    if b == 0:
        return out
    per, splits = split_plan(b * kvh, valid, _sm_count(q.device.index or 0))
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b * kvh, splits, g, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b * kvh, splits, g, 2), dtype=torch.float32,
                              device=q.device)
    _build.check(lib.teshu_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(),
        b, t, kvh, g, d, valid, per, splits, _DTYPES[q.dtype],
        _DTYPES[k.dtype], scale, _build.stream_of(q)), "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
