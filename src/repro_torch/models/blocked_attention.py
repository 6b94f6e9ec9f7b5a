"""Blocked (flash-style) attention in plain tensor ops.

Counterpart of ``repro.models.blocked_attention``: attention computed an
outer loop over query blocks at a time and an inner loop over kv blocks,
carrying the online-softmax state ``(m, l, acc)``, so that live memory is
``O(B · H · block_q · block_kv)`` logits and the output, never the whole
``[B, H, Sq, Skv]``.  One implementation for GQA, ``dk != dv``, sliding
windows, a cache-length mask and query offsets.  It is the plain route of
:func:`repro_torch.models.layers._attend` at large shapes, as the
reference's is of its ``_attend``; the serving path runs the flash and
decode kernels instead.

As in the reference, masked tiles inside a query block's range are
computed and discarded, and with a causal sliding window a query block
reads only the ``nwb`` kv blocks that its rows can see.

The tiles default to :data:`DEFAULT_BLOCK_Q` x :data:`DEFAULT_BLOCK_KV`;
:func:`set_block_defaults` overrides them for later calls (the dry run's
``perf`` knob, as the reference's).  Every operation of the blocked loop
runs inside :func:`attention_scope`, the counterpart of the reference's
``jax.named_scope("flash_xla")``: the dry run's counter
(:mod:`repro_torch.launch.op_analysis`) reads :func:`in_attention_scope`
and keeps those bytes apart, the traffic that the flash kernel keeps on
chip (the backward's operations, which autograd runs outside the call, are
not in it).

Shapes: q ``[B, S, H, dk]``, k ``[B, T, KVH, dk]``, v ``[B, T, KVH, dv]``
-> ``[B, S, H, dv]``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_NEG = -1e30

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 1024
_block_overrides: dict = {}
_scope_depth = [0]


def set_block_defaults(block_q: int | None = None,
                       block_kv: int | None = None) -> None:
    """Override the tile sizes of later calls that name none (None: back
    to the default)."""
    for key, value in (("q", block_q), ("kv", block_kv)):
        if value is None:
            _block_overrides.pop(key, None)
        else:
            _block_overrides[key] = value


@contextlib.contextmanager
def attention_scope():
    """Marks the operations issued inside as the plain blocked
    attention's."""
    _scope_depth[0] += 1
    try:
        yield
    finally:
        _scope_depth[0] -= 1


def in_attention_scope() -> bool:
    return _scope_depth[0] > 0
# Below this many logit elements the fused path is used instead
# (:func:`use_blocked`), as in the reference
_FUSED_LOGITS_BUDGET = 1 << 27          # 128M float32 logits ~ 512 MB


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def use_blocked(b: int, s: int, t: int, h: int) -> bool:
    return b * s * t * h > _FUSED_LOGITS_BUDGET


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, q_offset: int = 0,
                      valid_len: int | None = None,
                      block_q: int | None = None, block_kv: int | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Attention of ``q`` over ``k, v``: query row ``i`` is absolute row
    ``q_offset + i``, which sees columns ``c < valid_len``, ``c <= row`` when
    causal and ``row - c < window`` with a window (0: none).  float32
    math, the result in q's dtype."""
    block_q = block_q or _block_overrides.get("q", DEFAULT_BLOCK_Q)
    block_kv = block_kv or _block_overrides.get("kv", DEFAULT_BLOCK_KV)
    b, s, h, dk = q.shape
    _, t, kvh, _ = k.shape
    dv = v.shape[-1]
    group = h // kvh
    scale = (dk ** -0.5) if scale is None else scale

    bq = min(block_q, _ceil_to(s, 8))
    bk = min(block_kv, _ceil_to(t, 8))
    s_p, t_p = _ceil_to(s, bq), _ceil_to(t, bk)
    q = F.pad(q, (0, 0, 0, 0, 0, s_p - s))
    k = F.pad(k, (0, 0, 0, 0, 0, t_p - t))
    v = F.pad(v, (0, 0, 0, 0, 0, t_p - t))
    nq, nk = s_p // bq, t_p // bk

    # [nq, B, bq, KVH, g, dk] query blocks; kv [nk, B, bk, KVH, d]
    qb = q.reshape(b, nq, bq, kvh, group, dk).permute(1, 0, 2, 3, 4, 5)
    kb = k.reshape(b, nk, bk, kvh, dk).permute(1, 0, 2, 3, 4)
    vb = v.reshape(b, nk, bk, kvh, dv).permute(1, 0, 2, 3, 4)
    t_valid = t if valid_len is None else int(valid_len)

    # a causal window: a q block sees only [q_start - window + 1, q_start +
    # bq - 1], a fixed number of kv blocks
    nwb = nk
    if window and causal:
        nwb = min(nk, -(-(window + bq - 1) // bk) + 1)

    dev = q.device
    blocks = []
    with attention_scope():      # the reference's flash_xla scope
        for qi in range(nq):
            qblk = qb[qi].float()                  # [B, bq, KVH, g, dk]
            q_start = q_offset + qi * bq
            rows = q_start + torch.arange(bq, device=dev)
            first = 0
            if nwb < nk:
                first = min(max((q_start - (window - 1)) // bk, 0), nk - nwb)
            m = torch.full((b, kvh, group, bq), _NEG, dtype=torch.float32,
                           device=dev)
            l = torch.zeros((b, kvh, group, bq), dtype=torch.float32,
                            device=dev)
            acc = torch.zeros((b, kvh, group, bq, dv), dtype=torch.float32,
                              device=dev)
            for kj in range(first, first + nwb):
                cols = kj * bk + torch.arange(bk, device=dev)
                logits = torch.einsum("bqkgd,bckd->bkgqc", qblk,
                                      kb[kj].float()) * scale
                mask = (cols[None, :] < t_valid).expand(bq, bk)
                if causal:
                    mask = mask & (rows[:, None] >= cols[None, :])
                if window:
                    mask = mask & ((rows[:, None] - cols[None, :]) < window)
                logits = torch.where(mask, logits, _NEG)
                m_new = torch.maximum(m, logits.amax(-1))
                p = torch.exp(logits - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgqc,bckd->bkgqd", p, vb[kj].float())
                m = m_new
            out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
            blocks.append(out.permute(0, 3, 1, 2, 4))  # [B, bq, KVH, g, dv]
    out = torch.stack(blocks).permute(1, 0, 2, 3, 4, 5).reshape(b, s_p, h, dv)
    return out[:, :s].to(q.dtype)
