"""Public entry points for the port's kernels.

``use_kernel=True`` (the default) goes through the wrappers, which dispatch
by the tensor's device: a CUDA tensor launches the hand-written kernel, a
CPU tensor takes the plain PyTorch version.  ``use_kernel=False`` calls the
plain version directly on any device (the yardstick the kernels are held
against on the card).
"""
from __future__ import annotations

from . import ref
from .combine import segment_combine
from .decode_attention import decode_attention as decode_attention_kernel
from .flash_attention import flash_attention
from .fold import segmented_fold as segmented_fold_kernel
from .gmm import gmm, route_and_pad
from .partition import partition_permute
from .slstm import slstm_scan as slstm_scan_kernel


def part(slots, vals, *, num_out, unique_slots=False, use_kernel=True):
    if use_kernel:
        return partition_permute(slots, vals, num_out=num_out,
                                 unique_slots=unique_slots)
    return ref.partition_permute_ref(slots, vals, num_out=num_out)


def combine(seg_ids, vals, *, num_segments, use_kernel=True):
    if use_kernel:
        return segment_combine(seg_ids, vals, num_segments=num_segments)
    return ref.segment_combine_ref(seg_ids, vals, num_segments=num_segments)


def segmented_fold(op, is_start, vals, *, use_kernel=True):
    if use_kernel:
        return segmented_fold_kernel(op, is_start, vals)
    return ref.segmented_fold_ref(op, is_start, vals)


def attention(q, k, v, *, causal=True, scale=None, window=0, use_kernel=True):
    if use_kernel:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   window=window)


def decode_attention(q, k, v, valid_len, *, window=0, use_kernel=True,
                     return_lse=False):
    """``return_lse`` (the log-sum-exp route) is passed on only where it is
    asked for, so that a plain version patched in without it still serves
    every other call."""
    lse = {"return_lse": True} if return_lse else {}
    if use_kernel:
        return decode_attention_kernel(q, k, v, valid_len, window=window,
                                       **lse)
    return ref.decode_attention_ref(q, k, v, valid_len, window=window, **lse)


def grouped_matmul(x, w, tile_group_ids, *, block_n=128, group_tiles=None,
                   use_kernel=True):
    if use_kernel:
        return gmm(x, w, tile_group_ids, block_n=block_n,
                   group_tiles=group_tiles)
    return ref.gmm_ref(x, w, tile_group_ids, block_n=block_n,
                       group_tiles=group_tiles)


def slstm_scan(xw, w_rec, b, state, *, use_kernel=True):
    if use_kernel:
        return slstm_scan_kernel(xw, w_rec, b, state)
    return ref.slstm_scan_ref(xw, w_rec, b, state)


__all__ = ["part", "combine", "segmented_fold", "attention",
           "decode_attention", "grouped_matmul", "slstm_scan", "route_and_pad",
           "partition_permute", "segment_combine", "flash_attention", "gmm"]
