"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes exactly what its CUDA kernel computes, with stock
tensor operations.  The wrappers in :mod:`.partition`, :mod:`.combine`,
:mod:`.fold`, :mod:`.flash_attention` and :mod:`.decode_attention` run these
only for tensors that lie on the CPU; on the card the kernels run and
``chip_smoke.py`` holds them against these on the same inputs.  The grouped
matmul's (:mod:`.gmm`) is :func:`gmm_ref`, the sLSTM recurrence's
(:mod:`.slstm`) :func:`slstm_scan_ref`.
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
    it takes as many vectorised steps as the longest segment has rows.  A
    meta tensor has no segments to walk: its result is the shape alone."""
    n = vals.shape[0]
    out = vals.clone()
    if n == 0 or vals.device.type == "meta":
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
                         window: int = 0, return_lse: bool = False):
    """``[B, H, d] x [B, T, KVH, d] -> [B, H, d]``: one new token per
    sequence against a cache whose positions ``>= valid_len`` are masked,
    and with a sliding window (``window`` > 0) those ``< valid_len -
    window`` too.  q head ``h`` reads kv head ``h // (H / KVH)``.  float32
    math, the result in q's dtype.  ``return_lse``: ``(out float32, lse [B,
    H] float32)``, ``lse`` the natural log of the sum of ``exp(scale q.k)``
    over the attended positions; at ``valid_len`` 0 zeros and ``-inf``
    (nothing attended)."""
    b, h, d = q.shape
    _, t, kvh, _ = k.shape
    g = h // kvh
    if return_lse and int(valid_len) == 0:
        return (torch.zeros((b, h, d), dtype=torch.float32, device=q.device),
                torch.full((b, h), -torch.inf, device=q.device))
    scale = (d ** -0.5) if scale is None else scale
    qg = q.reshape(b, kvh, g, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    pos = torch.arange(t, device=q.device)
    mask = pos < valid_len
    if window:
        mask &= pos >= valid_len - window
    s = torch.where(mask[None, None, None], s, MASKED)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float()).reshape(b, h, d)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(b, h)
    return out.to(q.dtype)


def gmm_ref(x: torch.Tensor, w: torch.Tensor, tile_group_ids, *,
            block_n: int, group_tiles: int | None = None) -> torch.Tensor:
    """Grouped matmul: row tile ``i`` (rows ``[i * block_n, (i + 1) *
    block_n)``) of ``x [n, d]`` times ``w[tile_group_ids[i]]``, ``w [G, d,
    f]``.  float32 math, the result in x's dtype.

    Unlike the reference's oracle it never gathers ``w[tile_group_ids]``
    (at the MoE prefill that is a float32 copy of the experts' weights for
    every tile): it walks the runs of equal group id and does one float32
    matmul per run.  The ids are read on the host (one copy).  Meta ids
    hold no values: the caller states their layout, ``group_tiles`` tiles
    of group 0, then of group 1, and so on, and the runs are taken from
    that."""
    n, d = x.shape
    g, dw, f = w.shape
    tiles = torch.as_tensor(tile_group_ids)
    if tiles.device.type != "meta":
        ids = tiles.tolist()
    elif group_tiles is None or tiles.shape != (g * group_tiles,):
        raise ValueError(f"meta group ids hold no values: state their "
                         f"layout (group_tiles {group_tiles} for {g} groups, "
                         f"{tuple(tiles.shape)} ids)")
    else:
        ids = [j for j in range(g) for _ in range(group_tiles)]
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


def lse_tolerance(plain_lse: torch.Tensor, attended: int,
                  d: int) -> torch.Tensor:
    """Per-element bound on ``|kernel lse - plain lse|`` for the decode
    kernels' log-sum-exp (``decode_attention(..., return_lse=True)``) over
    ``attended`` positions of head width ``d``: both are float32 (a score
    is a sum of ``d`` exact products, the log a sum of ``attended``
    exponentials, each kept in its own order), so ``2^-24 (attended + d)
    (1 + |lse|)``."""
    return 2.0 ** -24 * (attended + d) * (1.0 + plain_lse.abs())


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


# ---------------------------------------------------------------------------
# the sLSTM recurrence
# ---------------------------------------------------------------------------

SLSTM_STATE = ("c", "n", "h", "m")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def slstm_pre(xw_t: torch.Tensor, h: torch.Tensor, w_rec: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One step's float32 pre-activation ``[B, 4d]`` from the input product
    ``xw_t [B, 4d]`` (x's dtype) and the state's float32 ``h``: ``h`` cast
    to x's dtype, the product summed in float32 and rounded to x's dtype,
    then ``xw_t + that`` rounded, then ``+ b`` rounded, then float32 (the
    reference's ``(x_t @ w_in + h.astype(x.dtype) @ w_rec + b)`` in its
    written order).  ``w_rec`` may be given as float32 already."""
    dt = xw_t.dtype
    rec = (h.to(dt).float() @ w_rec.float()).to(dt)
    return ((xw_t + rec) + b).float()


def slstm_cell(pre: torch.Tensor, st: dict) -> dict:
    """The reference's ``_slstm_cell`` after its pre-activation: z, i, f, o
    from ``pre [B, 4d]`` in float32 (tanh, the two log-sigmoids, sigmoid),
    the stabiliser ``m``, ``n`` floored at 1e-6; returns the new state
    ``{"c", "n", "h", "m"}`` (``h`` is the step's output)."""
    d = pre.shape[-1] // 4
    z = torch.tanh(pre[..., :d])
    o = torch.sigmoid(pre[..., 3 * d:])
    log_if = -softplus(-pre[..., d:3 * d])     # both log-sigmoids at once
    log_i, log_f = log_if[..., :d], log_if[..., d:]
    f_m = log_f + st["m"]
    m_new = torch.maximum(f_m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(f_m - m_new)
    c = f_s * st["c"] + i_s * z
    n = torch.clamp(f_s * st["n"] + i_s, min=1e-6)
    return {"c": c, "n": n, "h": o * (c / n), "m": m_new}


def _bf16_sum(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h [B, d] @ w [d, 4d]`` summed in bfloat16: float32 partial sums of
    8 rows of k, added pairwise with each sum rounded to bfloat16 (as a
    kernel that kept its accumulator in bfloat16 would)."""
    part = torch.einsum("bcv,cvn->bcn", h.reshape(h.shape[0], -1, 8),
                        w.reshape(-1, 8, w.shape[1]))
    while part.shape[1] > 1:
        if part.shape[1] % 2:
            part = torch.cat([part, torch.zeros_like(part[:, :1])], 1)
        part = (part[:, 0::2] + part[:, 1::2]).bfloat16().float()
    return part[:, 0]


def slstm_scan_ref(xw: torch.Tensor, w_rec: torch.Tensor, b: torch.Tensor,
                   state: dict, *, drop_rec_at: int | None = None,
                   bf16_sum: bool = False):
    """The sLSTM recurrence over ``xw [B, S, 4d]`` (the input product, in
    x's dtype, bfloat16 or float32) with ``w_rec [d, 4d]`` and ``b [4d]``
    in that dtype, from ``state`` (``c, n, h, m [B, d]`` float32): a loop
    of :func:`slstm_pre` and :func:`slstm_cell` over ``t``.  Returns ``(hs
    [B, S, d] float32, the final state)``; ``state`` is not modified.
    When autograd records, the same loop runs as one ``autograd.Function``
    (:class:`_SLSTMScan`) whose backward is the recurrence's reverse loop.
    Two planted faults for the checks (never under autograd):
    ``drop_rec_at`` leaves the recurrent product out of that one step;
    ``bf16_sum`` sums it in bfloat16 (:func:`_bf16_sum`; ``d`` a multiple
    of 8) instead of float32."""
    if drop_rec_at is None and not bf16_sum and torch.is_grad_enabled() \
            and any(t.requires_grad for t in (xw, w_rec, b, *(
                state[k] for k in SLSTM_STATE))):
        hs, *last = _SLSTMScan.apply(xw, w_rec, b,
                                     *(state[k] for k in SLSTM_STATE))
        return hs, dict(zip(SLSTM_STATE, last))
    w = w_rec.float()
    st = {k: state[k].float() for k in SLSTM_STATE}
    hs = []
    for t in range(xw.shape[1]):
        if t == drop_rec_at:
            pre = (xw[:, t] + b).float()
        elif bf16_sum:
            rec = _bf16_sum(st["h"].to(xw.dtype).float(), w).to(xw.dtype)
            pre = ((xw[:, t] + rec) + b).float()
        else:
            pre = slstm_pre(xw[:, t], st["h"], w, b)
        st = slstm_cell(pre, st)
        hs.append(st["h"])
    return torch.stack(hs, dim=1), st


SLSTM_BLOCK = 128       # steps of the training loop one CUDA graph holds
_SIDE_STREAMS: dict = {}


def _blocks(fn, statics: list, n: int, load, store) -> None:
    """``n`` calls of ``fn()``, which reads only the tensors of ``statics``
    and returns new ones: ``load(i)`` copies block ``i``'s inputs into
    ``statics`` before its call, ``store(i, out)`` takes its outputs (and
    copies a carried state back into ``statics``).  On the card the first
    call runs on a side stream (the lazy set-up, such as cuBLAS's
    workspace for that stream, made outside a capture) and is then
    captured there as one CUDA graph, which the other calls replay: the
    same kernels on the same inputs, so the same bits, with one launch a
    block where the loop issues a few dozen a step."""
    if not statics[0].is_cuda:
        for i in range(n):
            load(i)
            store(i, fn())
        return
    dev = statics[0].device
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    side = _SIDE_STREAMS[dev]
    cur = torch.cuda.current_stream(dev)
    load(0)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    store(0, out)
    if n == 1:
        return
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    for i in range(1, n):
        load(i)
        graph.replay()
        store(i, out)


def _forward_steps(xw: torch.Tensor, st: list, w: torch.Tensor,
                   b: torch.Tensor) -> tuple:
    """:func:`slstm_scan_ref`'s loop over the ``T`` steps of ``xw [B, T,
    4d]`` from the state ``st`` (``c, n, h, m``): ``(pre [B, T, 4d], c, n,
    h, m [B, T, d] after each step)``."""
    state = dict(zip(SLSTM_STATE, st))
    pres, seq = [], {k: [] for k in SLSTM_STATE}
    for x_t in xw.unbind(1):
        pre = slstm_pre(x_t, state["h"], w, b)
        state = slstm_cell(pre, state)
        pres.append(pre)
        for k in SLSTM_STATE:
            seq[k].append(state[k])
    return (torch.stack(pres, dim=1),
            *(torch.stack(seq[k], dim=1) for k in SLSTM_STATE))


def _backward_steps(pre: torch.Tensor, cs: torch.Tensor, ns: torch.Tensor,
                    ms: torch.Tensor, g_hs: torch.Tensor, carry: list,
                    wt: torch.Tensor, dt: torch.dtype) -> tuple:
    """The reverse loop over ``T`` steps: the pre-activations ``pre [B, T,
    4d]``, the states ``cs, ns, ms [B, T + 1, d]`` (before the first step,
    then after each), the outputs' gradient ``g_hs [B, T, d]`` and the
    gradient ``carry`` (``dh, dc, dn, dm``) from the steps after; returns
    ``(d pre [B, T, 4d], dh, dc, dn, dm)`` before the first step.  The
    cell's gates are recomputed from ``pre`` at once over the steps; the
    derivatives are the operations' own: ``softplus'`` is the sigmoid,
    ``maximum`` splits a tie in half, the clamp of ``n`` passes where ``n
    >= 1e-6``, each cast's adjoint is the cast back."""
    z_, i_, f_, o_ = pre.chunk(4, dim=-1)              # [B, T, d] each
    z, o = torch.tanh(z_), torch.sigmoid(o_)
    log_i, log_f = -softplus(-i_), -softplus(-f_)
    m0, m = ms[:, :-1], ms[:, 1:]
    a = log_f + m0
    i_s, f_s = torch.exp(log_i - m), torch.exp(log_f + m0 - m)
    keep = (f_s * ns[:, :-1] + i_s >= 1e-6).float()
    q = cs[:, 1:] / ns[:, 1:]
    o_n = o / ns[:, 1:]                     # d c / d h through h = o c / n
    oqn = o_n * q * keep                    # -d n / d h, the clamp's mask
    w_a = torch.where(a > log_i, 1.0, torch.where(a == log_i, 0.5, 0.0))
    sig_i, sig_f = torch.sigmoid(-i_), torch.sigmoid(-f_)
    i_tz = i_s * (1 - z * z)                # d z_ / d c
    q_so = q * o * (1 - o)                  # d o_ / d h
    dh, dc, dn, dm = carry
    dpre = torch.empty_like(pre)
    d = cs.shape[-1]
    for t in range(pre.shape[1] - 1, -1, -1):
        dh = dh + g_hs[:, t]
        dc = dc + dh * o_n[:, t]
        dn = dn * keep[:, t] - dh * oqn[:, t]
        de_f = (dn * ns[:, t] + dc * cs[:, t]) * f_s[:, t]
        de_i = (dn + dc * z[:, t]) * i_s[:, t]
        dm = dm - de_f - de_i
        d_a = dm * w_a[:, t]
        row = dpre[:, t]
        torch.mul(dc, i_tz[:, t], out=row[:, :d])
        torch.mul(de_i + dm - d_a, sig_i[:, t], out=row[:, d:2 * d])
        torch.mul(de_f + d_a, sig_f[:, t], out=row[:, 2 * d:3 * d])
        torch.mul(dh, q_so[:, t], out=row[:, 3 * d:])
        dc, dn, dm = dc * f_s[:, t], dn * f_s[:, t], de_f + d_a
        # pre = ((xw + rec) + b).float(), rec = (h.to(dt).float() @ w)
        # .to(dt): each cast's adjoint the cast back
        dh = (row.to(dt).float() @ wt).to(dt).float()
    return dpre, dh, dc, dn, dm


class _SLSTMScan(torch.autograd.Function):
    """:func:`slstm_scan_ref`'s loop under autograd.  The forward runs the
    loop as it is (the same bits) and keeps each step's pre-activation
    and state; the backward recomputes the cell's gates from them and runs
    the recurrence backwards, one step's carried ``(dh, dc, dn, dm)`` at a
    time (:func:`_backward_steps`), so that a step costs a few dozen
    operations with no autograd graph (the loop under autograd records
    one node an operation).  Both run in blocks of ``SLSTM_BLOCK`` steps
    (:func:`_blocks`: on the card one CUDA graph replayed a block; the
    steps before the last whole block, or after it going forward, run as
    they are).  ``w_rec``'s and ``b``'s gradients are summed over the
    steps in float32 and rounded once to their dtype."""

    @staticmethod
    def forward(ctx, xw, w_rec, b, c, n, h, m):
        w = w_rec.float()
        bsz, s, _ = xw.shape
        t_blk = min(SLSTM_BLOCK, s)
        whole = s // t_blk
        pres = torch.empty(xw.shape, dtype=torch.float32, device=xw.device)
        # [B, S + 1, d]: the state before step 0, then after each step
        seq = [torch.empty((bsz, s + 1, x.shape[-1]), dtype=torch.float32,
                           device=xw.device) for x in (c, n, h, m)]
        for y, x in zip(seq, (c, n, h, m)):
            y[:, 0] = x
        xs = torch.empty((bsz, t_blk, xw.shape[-1]), dtype=xw.dtype,
                         device=xw.device)
        st = [x.float().clone() for x in (c, n, h, m)]

        def store(t0, out):
            pres[:, t0:t0 + out[0].shape[1]] = out[0]
            for y, x, o in zip(seq, st, out[1:]):
                y[:, t0 + 1:t0 + 1 + o.shape[1]] = o
                x.copy_(o[:, -1])
        _blocks(lambda: _forward_steps(xs, st, w, b), [xs, *st], whole,
                lambda i: xs.copy_(xw[:, i * t_blk:(i + 1) * t_blk]),
                lambda i, out: store(i * t_blk, out))
        if whole * t_blk < s:
            store(whole * t_blk, _forward_steps(xw[:, whole * t_blk:], st,
                                                w, b))
        ctx.save_for_backward(pres, w_rec, *seq)
        ctx.dt, ctx.b_dtype = xw.dtype, b.dtype
        return (seq[2][:, 1:],) + tuple(x[:, -1] for x in seq)

    @staticmethod
    def backward(ctx, g_hs, g_c, g_n, g_h, g_m):
        pre, w_rec, cs, ns, hs, ms = ctx.saved_tensors
        dt = ctx.dt
        wt = w_rec.float().t()
        bsz, s, _ = pre.shape
        zero = torch.zeros_like(cs[:, 0])
        carry = [zero.clone() if g is None else g.float().clone()
                 for g in (g_h, g_c, g_n, g_m)]
        g_hs = torch.zeros_like(hs[:, 1:]) if g_hs is None else g_hs.float()
        t_blk = min(SLSTM_BLOCK, s)
        whole = s // t_blk
        head = s - whole * t_blk              # the steps before the blocks
        dpre = torch.empty_like(pre)
        ins = [torch.empty((bsz, t_blk) + x.shape[2:], dtype=x.dtype,
                           device=x.device) for x in (pre, g_hs)]
        ins += [torch.empty((bsz, t_blk + 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device) for x in (cs, ns, ms)]
        src = (pre, g_hs, cs, ns, ms)

        def load(i):
            t0 = s - (i + 1) * t_blk
            for x, y in zip(ins, src):
                x.copy_(y[:, t0:t0 + x.shape[1]])

        def store(i, out):
            t0 = s - (i + 1) * t_blk
            dpre[:, t0:t0 + t_blk] = out[0]
            for x, o in zip(carry, out[1:]):
                x.copy_(o)
        p_, g_, c_, n_, m_ = ins
        _blocks(lambda: _backward_steps(p_, c_, n_, m_, g_, carry, wt, dt),
                [*ins, *carry], whole, load, store)
        if head:
            out = _backward_steps(pre[:, :head], cs[:, :head + 1],
                                  ns[:, :head + 1], ms[:, :head + 1],
                                  g_hs[:, :head], carry, wt, dt)
            dpre[:, :head] = out[0]
            carry = list(out[1:])
        dh, dc, dn, dm = carry
        ds = dpre.to(dt)                       # the adjoint of xw and of b
        dw = torch.einsum("bsk,bsn->kn", hs[:, :-1].to(dt).float(),
                          ds.float())
        db = ds.float().sum(dim=(0, 1))
        return (ds, dw.to(w_rec.dtype), db.to(ctx.b_dtype), dc, dn, dh, dm)


def _dtype_step(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s values at ``|x|`` (float32 ``x``): 2^(e
    - p) for ``|x|`` in [2^e, 2^(e+1)), p = 7 (bfloat16) or 23 (float32);
    the smallest normal's spacing at 0."""
    bits = 7 if dtype == torch.bfloat16 else 23
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - bits)


# float32 roundings of the cell itself (about ten operations, tanh, exp and
# log1p each within a few ulp of their own on either side), per step
SLSTM_CELL_EPS = 2.0 ** -20


def slstm_tolerance(xw: torch.Tensor, w_rec: torch.Tensor, b: torch.Tensor,
                    state: dict, *, skipped_rounding: bool = False
                    ) -> tuple[torch.Tensor, dict]:
    """Per-element bounds on ``|kernel - plain|`` for ``slstm_scan`` against
    :func:`slstm_scan_ref` on the same inputs: ``(bound on hs [B, S, d],
    bounds on the final state)``.

    The two differ only in the recurrent product's float32 sum, which the
    kernel takes in another order, and in the cell's float32 functions.
    Each step's pre-activation ``g`` of z, i, f, o may move by the smaller
    of two slacks:

    - the interval: the plain run's float32 product ``p`` may move by ``e
      = 2 d 2^-24 (|h| @ |w_rec|)`` (the sum's reordering) plus ``|w_rec|``
      times how far the two runs' ``h``, cast to x's dtype, may lie apart
      (each ``h`` within the last step's bound, cast at both ends); the
      three roundings after it (to x's dtype, ``+ xw``, ``+ b``) are
      monotone, so ``g`` lies between its values at ``p - e`` and ``p +
      e``.  Where no rounding boundary lies within ``e`` of ``p`` that
      interval is one value: the two runs agree there exactly;
    - one step of x's dtype at each of the three rounded values (for
      bfloat16 about 2^-7 of each) plus the reordering ``e``: where the
      runs' ``h`` have drifted apart in their last bits the interval's
      worst case through ``|w_rec|`` grows without limit, but the drift
      has random signs and ``|w_rec|`` is about 0.02, so it moves a
      pre-activation far less than these steps.

    So a kernel that sums the product in a lower precision is caught where
    the runs start from one ``h`` (the first steps from any state), and
    one that drops or garbles it everywhere.  ``skipped_rounding`` adds a
    step at ``+ b``: the other run may skip that rounding, as XLA's CPU
    compiler does inside its scan.  The slack is carried through the cell
    to first order, at the plain run's values:

    - ``z = tanh`` moves by ``(1 - z^2) u_z``, ``o`` by ``o (1 - o) u_o``,
      the log-gates by ``sigmoid(-i) u_i`` and ``sigmoid(-f) u_f``;
    - ``r = c / n`` is the weighted mean ``w_f r_prev + w_i z`` (``w_i =
      i_s / n``, ``w_f = f_s n_prev / n``; the stabiliser ``m`` cancels),
      so its error ``E_r`` carries as ``w_f E_r + w_i dz + w_f |r_prev - r|
      (d log_i + d log_f + E_N)``, with ``E_N = w_f (E_N + d log_f) + w_i d
      log_i`` the error of the unscaled ``log n`` (the past's weight), and
      ``2^-20`` a step for the cell's own float32 roundings;
    - ``h = o r`` moves by ``o E_r + do |r|``; ``m`` by its branch's
      log-gate error (both where the branch may flip); ``n = N e^-m`` by
      ``n (E_N + E_m)``; ``c = r n`` by ``|r| dn + n E_r``.

    The bound is twice that (for the first-order terms), plus ``2^-20
    |x|`` for a float32 result.  n's floor of 1e-6 is not modelled: after
    the first step n >= min(1, n_0)."""
    dt = xw.dtype
    d = w_rec.shape[0]
    w = w_rec.float()
    wabs = w.abs()
    st = {k: state[k].float() for k in SLSTM_STATE}
    zeros = torch.zeros_like(st["c"])
    e_r, e_n, e_m, e_h = zeros, zeros, zeros, zeros
    tols = []
    for t in range(xw.shape[1]):
        hq = st["h"].to(dt).float()
        p32 = hq @ w
        p = p32.to(dt)
        s1 = xw[:, t] + p
        pre = (s1 + b).float()
        reorder = 2 * d * 2.0 ** -24 * (hq.abs() @ wabs)
        skip = _dtype_step(pre, dt) if skipped_rounding else 0.0
        steps = (_dtype_step(p.float(), dt) + _dtype_step(s1.float(), dt)
                 + _dtype_step(pre, dt) + reorder)
        h_apart = ((st["h"] + e_h).to(dt).float()
                   - (st["h"] - e_h).to(dt).float())
        e = reorder + h_apart @ wabs + _dtype_step(p32, torch.float32)
        lo, hi = (p32 - e).to(dt), (p32 + e).to(dt)
        interval = (((xw[:, t] + hi) + b).float()
                    - ((xw[:, t] + lo) + b).float() + skip)
        u = torch.minimum(interval, steps)
        u_z, u_i, u_f, u_o = u.chunk(4, dim=-1)
        zp, ip, fp, op = pre.chunk(4, dim=-1)
        new = slstm_cell(pre, st)
        z, o = torch.tanh(zp), torch.sigmoid(op)
        d_z, d_o = (1 - z * z) * u_z, o * (1 - o) * u_o
        d_li, d_lf = torch.sigmoid(-ip) * u_i, torch.sigmoid(-fp) * u_f
        log_i, log_f = -softplus(-ip), -softplus(-fp)
        i_s = torch.exp(log_i - new["m"])
        f_s = torch.exp(log_f + st["m"] - new["m"])
        w_i = i_s / new["n"]
        w_f = f_s * st["n"] / new["n"]
        r = new["c"] / new["n"]
        r_prev = torch.where(st["n"] > 0, st["c"] / st["n"].clamp(min=1e-30),
                             zeros)
        e_r = (w_f * e_r + w_i * d_z
               + w_f * (r_prev - r).abs() * (d_li + d_lf + e_n)
               + SLSTM_CELL_EPS * (1 + r.abs()))
        e_n = w_f * (e_n + d_lf) + w_i * d_li
        gap = (log_f + st["m"] - log_i).abs()
        flip = gap <= d_lf + e_m + d_li
        e_m = torch.where(flip, torch.maximum(d_lf + e_m, d_li),
                          torch.where(log_f + st["m"] > log_i, d_lf + e_m,
                                      d_li))
        tols.append(2 * (o * e_r + d_o * r.abs())
                    + SLSTM_CELL_EPS * new["h"].abs())
        e_h = tols[-1]
        st = new
    e_dn = st["n"] * (e_n + e_m)
    final = {"h": tols[-1] if tols else zeros,
             "m": 2 * e_m + SLSTM_CELL_EPS * st["m"].abs(),
             "n": 2 * e_dn + SLSTM_CELL_EPS * st["n"],
             "c": 2 * ((st["c"] / st["n"]).abs() * e_dn + st["n"] * e_r)
             + SLSTM_CELL_EPS * st["c"].abs()}
    return torch.stack(tols, dim=1), final
