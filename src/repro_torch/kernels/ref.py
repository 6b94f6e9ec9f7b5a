"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes exactly what its CUDA kernel computes, with stock
tensor operations.  The wrappers in :mod:`.partition`, :mod:`.combine`,
:mod:`.fold`, :mod:`.flash_attention` and :mod:`.decode_attention` run these
only for tensors that lie on the CPU; on the card the kernels run and
``chip_smoke.py`` holds them against these on the same inputs.  The grouped
matmul's (:mod:`.gmm`) is :func:`gmm_ref`.
"""
from __future__ import annotations

import torch

FOLD_OPS = ("sum", "min", "max")
MASKED = -1e30          # the attention kernels' mask value (not -inf)


def partition_permute_ref(slots: torch.Tensor, vals: torch.Tensor, *,
                          num_out: int) -> torch.Tensor:
    """PART: scatter rows of ``vals [n, d]`` into ``[num_out, d]`` by
    ``slots [n]``; slots outside ``[0, num_out)`` are dropped, colliding
    slots sum.  Accumulates in float32, returns the input dtype."""
    ok = (slots >= 0) & (slots < num_out)
    out = torch.zeros((num_out, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, slots[ok].long(), vals[ok].float())
    return out.to(vals.dtype)


def segment_combine_ref(seg_ids: torch.Tensor, vals: torch.Tensor, *,
                        num_segments: int) -> torch.Tensor:
    """COMB for +: per-segment row sums ``[num_segments, d]``; ids outside
    ``[0, num_segments)`` (the -1 drop id) are dropped.  Accumulates in
    float32, returns the input dtype."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, seg_ids[ok].long(), vals[ok].float())
    return out.to(vals.dtype)


def fold_step(op: str, acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One left-fold step ``op(acc, v)`` with numpy's semantics: NaN
    propagates from either side, and on a tie (``0.0`` against ``-0.0``) the
    later operand ``v`` wins, as ``np.minimum`` / ``np.maximum`` give it."""
    if op == "sum":
        return acc + v
    if op == "min":
        return torch.where((acc < v) | acc.isnan(), acc, v)
    if op == "max":
        return torch.where((acc > v) | acc.isnan(), acc, v)
    raise ValueError(f"unknown fold op {op!r} (ops: {FOLD_OPS})")


def segmented_fold_ref(op: str, is_start: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """Ordered segmented left fold: row ``r`` of the result holds
    ``op``-fold of its segment's rows up to and including ``r``, folded
    strictly in row order (the segment's first row is the seed).  A segment
    begins at every ``is_start`` row, and at row 0.

    The loop runs over the position inside a segment: step ``p`` folds every
    row at position ``p`` onto the result of position ``p - 1`` at once, so
    it takes as many vectorised steps as the longest segment has rows."""
    n = vals.shape[0]
    out = vals.clone()
    if n == 0:
        return out
    idx = torch.arange(n, device=vals.device)
    start = is_start.clone()
    start[0] = True
    seg_start = torch.cummax(torch.where(start, idx, 0), 0).values
    pos = idx - seg_start
    order = torch.sort(pos, stable=True).indices
    bounds = torch.bincount(pos).cumsum(0).tolist()
    for p in range(1, len(bounds)):
        rows = order[bounds[p - 1]:bounds[p]]
        out[rows] = fold_step(op, out[rows - 1], vals[rows])
    return out


# Above this many logits (1 GiB of float32) the plain flash works through
# blocks of query rows; each row's math is the same, so smaller calls are
# unchanged bit for bit
FLASH_REF_LOGITS = 1 << 28


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """``[BHq, Sq, D] x [BHkv, Skv, D] -> [BHq, Sq, D]``; GQA by head
    repetition (q head ``bh`` reads kv head ``bh // group``), queries
    end-aligned with the keys: row ``i`` is absolute row ``r = i + Skv -
    Sq``, which sees columns ``c <= r`` when causal and ``r - c < window``
    with a sliding window (``window`` 0: none).  float32 math, the result
    in q's dtype; above ``FLASH_REF_LOGITS`` logits, one block of query
    rows at a time."""
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    group = bhq // bhkv
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    scale = (d ** -0.5) if scale is None else scale
    block = sq if bhq * sq * skv <= FLASH_REF_LOGITS else \
        max(1, FLASH_REF_LOGITS // (bhq * skv))
    cols = torch.arange(skv, device=q.device)
    out = []
    for i0 in range(0, sq, block):
        qb = q[:, i0:i0 + block]
        s = torch.einsum("bqd,bkd->bqk", qb.float(), k.float()) * scale
        if causal or window:
            rows = torch.arange(i0, i0 + qb.shape[1],
                                device=q.device)[:, None] + (skv - sq)
            mask = torch.ones((qb.shape[1], skv), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= cols[None] <= rows
            if window:
                mask &= rows - cols[None] < window
            s = torch.where(mask[None], s, MASKED)
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len, *, scale: float | None = None,
                         window: int = 0) -> torch.Tensor:
    """``[B, H, d] x [B, T, KVH, d] -> [B, H, d]``: one new token per
    sequence against a cache whose positions ``>= valid_len`` are masked,
    and with a sliding window (``window`` > 0) those ``< valid_len -
    window`` too.  q head ``h`` reads kv head ``h // (H / KVH)``.  float32
    math, the result in q's dtype."""
    b, h, d = q.shape
    _, t, kvh, _ = k.shape
    g = h // kvh
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, kvh, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    pos = torch.arange(t, device=q.device)
    mask = pos < valid_len
    if window:
        mask &= pos >= valid_len - window
    s = torch.where(mask[None, None, None], s, MASKED)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def gmm_ref(x: torch.Tensor, w: torch.Tensor, tile_group_ids, *,
            block_n: int) -> torch.Tensor:
    """Grouped matmul: row tile ``i`` (rows ``[i * block_n, (i + 1) *
    block_n)``) of ``x [n, d]`` times ``w[tile_group_ids[i]]``, ``w [G, d,
    f]``.  float32 math, the result in x's dtype.

    Unlike the reference's oracle it never gathers ``w[tile_group_ids]``
    (at the MoE prefill that is a float32 copy of the experts' weights for
    every tile): it walks the runs of equal group id and does one float32
    matmul per run.  The ids are read on the host (one copy)."""
    n, d = x.shape
    g, dw, f = w.shape
    ids = torch.as_tensor(tile_group_ids).tolist()
    if dw != d or block_n <= 0 or n != len(ids) * block_n:
        raise ValueError(f"gmm wants x [n, d], w [G, d, f] and one group id "
                         f"per {block_n}-row tile: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, {len(ids)} ids")
    if ids and not 0 <= min(ids) <= max(ids) < g:
        raise ValueError(f"group ids must lie in [0, {g}): "
                         f"{min(ids)}..{max(ids)}")
    out = torch.empty((n, f), dtype=x.dtype, device=x.device)
    start = 0
    for i in range(1, len(ids) + 1):
        if i == len(ids) or ids[i] != ids[start]:
            rows = slice(start * block_n, i * block_n)
            out[rows] = (x[rows].float() @ w[ids[start]].float()).to(x.dtype)
            start = i
    return out


# ---------------------------------------------------------------------------
# how far a kernel may sit from the plain attention
# ---------------------------------------------------------------------------

def attention_tolerance(plain: torch.Tensor, abs_weighted: torch.Tensor, *,
                        rounds_p: bool = False) -> torch.Tensor:
    """Per-element bound on ``|kernel - plain|`` for an attention kernel
    whose math is float32 like the plain version's.

    ``abs_weighted`` is the plain attention of ``|v|`` (float32): row by
    row ``A = sum_j p_j |v_j|``, which bounds ``|out|``.  A bfloat16 output
    is one float32 value rounded once on each side (at most ``2^-8``
    relative each), so the two may sit ``2^-7 |plain|`` apart; a kernel
    that rounds its probabilities to bfloat16 for ``P V`` (``rounds_p``,
    the flash kernel's tensor-core path) moves the output by at most
    ``2^-8 A`` more; ``2^-14 A`` covers the float32 math's other order.
    A float32 output: ``1e-5 (1 + |plain|)``."""
    a = abs_weighted.float()
    if plain.dtype == torch.float32:
        return 1e-5 * (1.0 + plain.abs())
    tol = 2.0 ** -7 * plain.float().abs() + 2.0 ** -14 * a
    if rounds_p:
        tol = tol + 2.0 ** -8 * (1 + 2.0 ** -8) * a
    return tol


def flash_attention_tolerance(q, k, v, plain, *, causal: bool = True,
                              scale: float | None = None,
                              window: int = 0) -> torch.Tensor:
    """:func:`attention_tolerance` for ``flash_attention(q, k, v)`` against
    ``plain = flash_attention_ref(q, k, v)``; bfloat16 q, k and v take the
    kernel's tensor-core path, which rounds P to bfloat16."""
    a = flash_attention_ref(q.float(), k, v.abs(), causal=causal, scale=scale,
                            window=window)
    bf16 = torch.bfloat16
    return attention_tolerance(plain, a, rounds_p=q.dtype == k.dtype == bf16)


def decode_attention_tolerance(q, k, v, valid_len, plain, *,
                               scale: float | None = None,
                               window: int = 0) -> torch.Tensor:
    """:func:`attention_tolerance` for ``decode_attention(q, k, v,
    valid_len)`` against ``plain = decode_attention_ref(...)``: float32
    throughout, nothing rounded before the output."""
    a = decode_attention_ref(q.float(), k, v.abs(), valid_len, scale=scale,
                             window=window)
    return attention_tolerance(plain, a)


# ---------------------------------------------------------------------------
# how far the gmm kernel may sit from the plain grouped matmul
# ---------------------------------------------------------------------------

def gmm_tolerance(x, w, tile_group_ids, plain: torch.Tensor, *,
                  block_n: int) -> torch.Tensor:
    """Per-element bound on ``|gmm(x, w, ids) - plain|``, ``plain =
    gmm_ref(x, w, ids)``: ``c 2^-24 A`` for a float32 output and ``(2^-7
    |plain| + c 2^-24 A) (1 + 2^-7)`` for a bfloat16 one, with ``A = |x| @
    |w|`` (per tile, in float32) and ``c = 2 d``.

    Both sides sum the same ``d`` products, each exact in float32 (two
    bfloat16 factors, or float32 rounding), in their own orders.  Any order
    of ``d - 1`` float32 additions lies within ``(d - 1) 2^-24 A`` of the
    exact sum, so the kernel's tile-by-tile sum and the plain matmul's lie
    within ``2 (d - 1) 2^-24 A <= c 2^-24 A`` of each other.  A bfloat16
    output then rounds each float32 value once, by at most ``2^-8`` of the
    rounded value: the two outputs ``k`` and ``p`` differ by ``D <= 2^-8
    (|k| + |p|) + c 2^-24 A``, and ``|k| <= |p| + D`` gives ``D <= (2^-7
    |p| + c 2^-24 A) / (1 - 2^-8)``.  An element whose row of ``x`` is zero
    (a padding slot) is held to exactly 0."""
    a = gmm_ref(x.abs().float(), w.abs(), tile_group_ids, block_n=block_n)
    tol = 2.0 * x.shape[1] * 2.0 ** -24 * a
    if plain.dtype != torch.float32:
        tol = (tol + 2.0 ** -7 * plain.float().abs()) * (1 + 2.0 ** -7)
    return tol
