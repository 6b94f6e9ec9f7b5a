"""Shared neural layers of the port's LM: RMSNorm, RoPE, GQA attention with
a KV cache, DeepSeek-V2's multi-head latent attention (MLA) with its latent
cache, and the SwiGLU / GELU MLP.

Counterpart of ``repro.models.layers`` for the dense text path.  Weights keep
the reference's ``[d_in, d_out]`` layout (``x @ w``), so that converted
parameters line up one to one.  Modules hold their parameters on an explicit
device and are made either from a ``torch.Generator`` (the reference's
``dense_init`` distributions) or empty, to be filled by
:mod:`repro_torch.models.convert`.

Attention with a KV cache goes through :mod:`repro_torch.kernels.ops`:
a prefill, into an empty cache or appended to a filled one, to the flash
kernel's slot over the cache's rows, single-token decode to the decode
kernel's, each with the layer's sliding window; ``use_kernel=False`` takes
their plain versions instead.  Without a cache, the flash slot, or with
``use_kernel=False`` :func:`_attend`, the reference's dispatch between the
fused and the blocked plain attention.

MLA (:class:`MLA`) runs on tensor ops alone, as the reference's does on
XLA: no kernel of the port takes its ``dk != dv`` heads.  Under a mesh it
splits its heads over ``model`` as GQA attention does.  Its two forms
are plain functions: :func:`mla_materialized` (the latent up-projected to
per-head keys and values, then :func:`_attend`) for every call but a
single-token decode, which takes :func:`mla_absorbed_decode` (``wkv_b``
folded into the query and the output, attention in the latent space in
float32).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.core import meshops
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attention import block_window, merge_blocks
from repro_torch.kernels.ref import MASKED
from repro_torch.launch import shardings

from .blocked_attention import blocked_attention, use_blocked
from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def tp_gather(y: torch.Tensor, width: int, mesh) -> torch.Tensor:
    """``y`` with its last dimension whole: ``y`` itself where it holds all
    ``width`` columns, else this rank's block of them all-gathered over
    ``model`` (``meshops.all_gather``: its gradient the reduce-scatter,
    this rank's block of the sum)."""
    if y.shape[-1] == width:
        return y
    return meshops.all_gather(y, mesh, "model", axis=y.dim() - 1)


def tp_block(t: torch.Tensor, n: int, mesh, dim: int = -1) -> torch.Tensor:
    """This ``model`` rank's block of ``n`` along ``dim`` of the whole
    ``t`` (block ``r`` for ``model`` rank ``r``, a view); ``t`` itself where
    it is ``n`` wide."""
    if t.shape[dim] == n:
        return t
    return t.narrow(dim, mesh.coord("model") * n, n)


def tp_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ``model`` that ends a row-parallel product
    (``meshops.psum``: its gradient the same sum); ``x`` itself where
    ``model`` has one rank, as ``shardings.gather`` skips an empty
    gather."""
    if mesh.shape["model"] == 1:
        return x
    return meshops.psum(x, mesh, ("model",))


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter that requires no grad: serving builds no graph, and
    making a model trainable is the trainer's act
    (``model.requires_grad_(True)``, :mod:`repro_torch.launch.train`)."""
    return nn.Parameter(t, requires_grad=False)


def normal_init(shape, std: float, dtype, device, gen) -> torch.Tensor:
    """float32 normal draws times ``std``, cast to ``dtype``; uninitialised
    memory when ``gen`` is None (the caller copies weights in)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, *,
               scale: float | None = None) -> torch.Tensor:
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    return normal_init((d_in, d_out), scale, dtype, device, gen)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal_init((vocab, d), 0.02, dtype, device, gen)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """float32 statistics, cast back to x's dtype, then the weight in that
    dtype (the reference's order)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = param(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: ``[..., S, H, Dh]``; positions: ``[..., S]``.  Rotates the two
    halves of each head (not interleaved pairs), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, QKV bias, KV cache)
# ---------------------------------------------------------------------------

def _sdpa_fused(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0,
                valid_len=None, scale: float | None = None) -> torch.Tensor:
    """``[B,S,H,dk] x [B,T,KVH,dk/dv]`` attention in plain tensor ops, with
    query offset, sliding window and cache-length mask, the whole
    ``[B, H, S, T]`` float32 logits at once (small shapes: :func:`_attend`).
    Off the serving path."""
    b, s, h, dk = q.shape
    _, t, kvh, _ = k.shape
    dv = v.shape[-1]
    g = h // kvh
    scale = (dk ** -0.5) if scale is None else scale
    qg = q.reshape(b, s, kvh, g, dk)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    rows = torch.arange(s, device=q.device)[:, None] + q_offset
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window:
        mask &= (rows - cols) < window
    if valid_len is not None:
        mask &= cols < valid_len
    logits = torch.where(mask, logits, MASKED)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, dv).to(q.dtype)


def _attend(q, k, v, *, causal: bool = True, window: int = 0,
            q_offset: int = 0, valid_len=None,
            scale: float | None = None) -> torch.Tensor:
    """The plain attention of the reference's ``_attend``: the blocked
    scan for a prefill whose logits exceed the fused budget
    (:func:`~repro_torch.models.blocked_attention.use_blocked`), the fused
    one otherwise."""
    b, s, h, _ = q.shape
    t = k.shape[1]
    if s > 1 and use_blocked(b, s, t, h):
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, valid_len=valid_len,
                                 scale=scale)
    return _sdpa_fused(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, valid_len=valid_len, scale=scale)


def _flash(q, k, v, *, window: int, use_kernel: bool) -> torch.Tensor:
    """Causal attention of ``q [B,S,H,D]`` over ``k, v [B,T,KVH,D]`` through
    the flash slot, in its ``[BH, S, D]`` layout; the queries are the last
    ``S`` of the ``T`` rows (end-aligned)."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * kvh, t, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * kvh, t, d).contiguous()
    of = kops.attention(qf, kf, vf, causal=True, window=window,
                        use_kernel=use_kernel)
    return of.reshape(b, h, s, d).transpose(1, 2)


def _rotated_heads(y: torch.Tensor, heads: int, positions: torch.Tensor,
                   cfg: ModelConfig, mesh) -> torch.Tensor:
    """``y [B, S, heads dh / m]`` (this rank's columns of a projection,
    every row) all-gathered whole over ``model`` (:func:`tp_gather`), then
    rotated at ``positions``: ``[B, S, heads, dh]``.  RoPE pairs column
    ``i`` of a head with column ``i + dh/2``, which a rank's block of
    columns may cut apart (Qwen2.5-14B on 16: 320 columns, 2.5 heads), so
    it follows the gather."""
    b, s = y.shape[:2]
    y = tp_gather(y, heads * cfg.d_head, mesh).reshape(b, s, heads,
                                                       cfg.d_head)
    return apply_rope(y, positions, cfg.rope_theta)


def _query_blocks(s: int, mesh) -> tuple[tuple[int, int], ...]:
    """This ``model`` rank's query rows of ``s`` under the ``"positions"``
    split (``shardings.position_blocks``)."""
    return shardings.position_blocks(s, mesh.shape["model"])[
        mesh.coord("model")]


def _block_slots(cache: dict, t: int, s: int, blocks: int = 1
                 ) -> tuple[slice, slice]:
    """``(rows, slots)``: the rows of a call's ``s`` new positions ``[len,
    len + s)`` that fall in the cache's block and the block's rows they go
    to (empty where none does).  The block is the cache's ``t`` rows from
    its ``t0``, one of ``blocks`` blocks of ``T`` (the ``"positions"`` and
    KV replication splits, MLA's), or all of ``T`` where the cache holds no
    ``t0``.  A call past the whole cache's end raises."""
    ln, t0 = cache["len"], cache.get("t0", 0)
    t_all = t * (blocks if "t0" in cache else 1)
    if ln + s > t_all:
        raise ValueError(f"KV cache full: {ln} + {s} positions > {t_all}")
    lo = max(ln, t0)
    hi = max(lo, min(ln + s, t0 + t))
    return slice(lo - ln, hi - ln), slice(lo - t0, hi - t0)


def _append(cache: dict, k: torch.Tensor, v: torch.Tensor, blocks: int = 1
            ) -> int:
    """Write ``k, v [B, S, kvh, dh]`` at the cache's positions ``[len, len +
    S)`` (cast to its dtype) and advance ``len``; returns the old ``len``.
    A cache holding one of ``blocks`` blocks of ``T`` (its ``t0``) takes
    the rows that fall in its block (:func:`_block_slots`)."""
    kc, vc, ln = cache["k"], cache["v"], cache["len"]
    rows, slots = _block_slots(cache, kc.shape[1], k.shape[1], blocks)
    if kc.shape[2] != k.shape[2]:
        raise ValueError(f"the cache holds {kc.shape[2]} kv heads, the layer "
                         f"computes {k.shape[2]}: make it with the model's "
                         f"mesh")
    kc[:, slots] = k[:, rows]
    vc[:, slots] = v[:, rows]
    cache["len"] = ln + k.shape[1]
    return ln


def _kv_rows(p: Attention, x: torch.Tensor, positions: torch.Tensor,
             k: torch.Tensor, v: torch.Tensor):
    """``(k, v) [B, n, n_kv_heads, dh]``: every kv head of the rows ``x [B,
    n, D]`` at ``positions``, from the whole ``wk`` and ``wv`` (and
    biases), rotated, under KV replication, whose cache block holds every
    kv head of its rows; ``k, v [B, n, 1, dh]`` are the rank's own head of
    them, which is every head where there is one."""
    cfg = p.cfg
    if cfg.n_kv_heads == 1:
        return k, v
    b, n, _ = x.shape
    kk, vv = x @ p.wk, x @ p.wv
    if p.bk is not None:
        kk, vv = kk + p.bk, vv + p.bv
    kk = apply_rope(kk.reshape(b, n, cfg.n_kv_heads, cfg.d_head), positions,
                    cfg.rope_theta)
    return kk, vv.reshape(b, n, cfg.n_kv_heads, cfg.d_head)


class Attention(nn.Module):
    """GQA self-attention with optional QKV bias, a sliding ``window`` (0:
    global) and a KV cache.

    Under a mesh whose ``model`` axis splits its heads
    (``shardings.attention_split``) the layer is called with ``wq``'s
    columns and ``wo``'s rows of this rank's ``h/m`` q heads (``[r h/m,
    (r + 1) h/m)`` for ``model`` rank ``r``), and ``wk`` / ``wv`` either
    as their own ``model`` shard (``kvh/m`` kv heads) or whole, of which it
    takes the columns of the one kv head its q heads read
    (``shardings.kv_head_of``); the replicated biases are sliced alike.
    It attends over those heads and ends in one sum over ``model``
    (:func:`tp_sum`).  Its cache holds its kv heads, or under KV
    replication every kv head of its block of ``T`` (:meth:`_replicated`;
    all of ``T`` and its one kv head where ``m`` does not divide it).

    Where ``model`` divides neither (the ``"positions"`` split: ``h`` not
    a multiple of ``m``, or ``kvh`` neither dividing nor divided by it)
    the layer is called with its ``1/m`` of the columns of ``wq``, ``wk``
    and ``wv`` and of the rows of ``wo`` (a leaf that arrives whole is cut
    to that block here), and it splits the work by positions
    (:meth:`_by_positions`): it computes its columns of ``q``, ``k`` and
    ``v`` for every row and all-gathers them, then attends for its query
    rows in a prefill or training step, or over its block of the cache's
    rows in a decode step, and ends in its rows of ``wo`` and one sum.
    Whole leaves run the layer whole."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None, window: int = 0):
        super().__init__()
        self.cfg = cfg
        self.window = window
        qh, kvh = cfg.attn_dims
        dt = dtype_of(cfg)
        self.wq = param(dense_init(gen, cfg.d_model, qh, dt, device))
        self.wk = param(dense_init(gen, cfg.d_model, kvh, dt, device))
        self.wv = param(dense_init(gen, cfg.d_model, kvh, dt, device))
        self.wo = param(dense_init(gen, qh, cfg.d_model, dt, device))
        for name, width in (("bq", qh), ("bk", kvh), ("bv", kvh)):
            self.register_parameter(name, param(torch.zeros(
                width, dtype=dt, device=device)) if cfg.qkv_bias else None)

    def _local(self, mesh):
        """``(h, kvh, wq, wk, wv, bq, bk, bv)``: the heads this rank
        computes and the weights and biases of those heads."""
        cfg, dh = self.cfg, self.cfg.d_head
        w = [self.wq, self.wk, self.wv, self.bq, self.bk, self.bv]
        h = self.wq.shape[1] // dh
        if h == cfg.n_heads:
            return cfg.n_heads, cfg.n_kv_heads, *w
        m, r = mesh.shape["model"], mesh.coord("model")
        if h * m != cfg.n_heads or self.wo.shape[0] != h * dh:
            raise ValueError(f"wq holds {h} of {cfg.n_heads} heads and wo "
                             f"{self.wo.shape[0] // dh} on a model axis of "
                             f"{m}")

        def cols(t, first, n):
            return None if t is None else t[..., first * dh:(first + n) * dh]
        kvh = self.wk.shape[1] // dh
        if kvh == cfg.n_kv_heads:         # KV replication: this rank's head
            if m % kvh:
                raise ValueError(f"{kvh} kv heads on a model axis of {m}")
            first, kvh = shardings.kv_head_of(r, m, cfg.n_kv_heads), 1
            w[1], w[2], w[4], w[5] = (cols(t, first, 1)
                                      for t in (w[1], w[2], w[4], w[5]))
        elif kvh * m != cfg.n_kv_heads:
            raise ValueError(f"wk holds {kvh} of {cfg.n_kv_heads} kv heads "
                             f"on a model axis of {m}")
        else:
            w[4], w[5] = cols(w[4], r * kvh, kvh), cols(w[5], r * kvh, kvh)
        w[3] = cols(w[3], r * h, h)
        return h, kvh, *w

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: dict | None = None, use_kernel: bool = True,
                mesh=None):
        """x: ``[B, S, D]``.  Returns ``(out, cache)``; a given cache is
        updated in place (its ``k``/``v`` rows ``[len, len + S)`` are
        written and ``len`` advances), not copied.  ``mesh`` is needed
        only where the leaves arrive as this rank's heads or columns."""
        if mesh is not None and \
                self.wq.shape[1] != self.cfg.n_heads * self.cfg.d_head and \
                shardings.attention_split(self.cfg, mesh) == "positions":
            return self._by_positions(x, positions, cache, use_kernel, mesh)
        cfg = self.cfg
        b, s, _ = x.shape
        h, kvh, wq, wk, wv, bq, bk, bv = self._local(mesh)
        q, k, v = x @ wq, x @ wk, x @ wv
        if bq is not None:
            q, k, v = q + bq, k + bk, v + bv
        q = apply_rope(q.reshape(b, s, h, cfg.d_head), positions,
                       cfg.rope_theta)
        k = apply_rope(k.reshape(b, s, kvh, cfg.d_head), positions,
                       cfg.rope_theta)
        v = v.reshape(b, s, kvh, cfg.d_head)

        if cache is None:
            out = _flash(q, k, v, window=self.window, use_kernel=True) \
                if use_kernel else _attend(q, k, v, window=self.window)
        elif "t0" in cache:                 # KV replication, a block of T
            out = self._replicated(x, positions, q, k, v, cache, use_kernel,
                                   mesh)
        else:
            ln = _append(cache, k, v)
            kc, vc = cache["k"], cache["v"]
            if s == 1:                      # the decode kernel's slot
                out = kops.decode_attention(q[:, 0].contiguous(), kc, vc,
                                            ln + 1, window=self.window,
                                            use_kernel=use_kernel)
                out = out[:, None]
            else:     # prefill, fresh or appended: flash on the cache rows,
                out = _flash(q, kc[:, :ln + s], vc[:, :ln + s],   # end-aligned
                             window=self.window, use_kernel=use_kernel)
        out = out.reshape(b, s, h * cfg.d_head)
        out = (out @ self.wo).to(x.dtype)
        return (out if h == cfg.n_heads else tp_sum(out, mesh)), cache

    def _replicated(self, x, positions, q, k, v, cache, use_kernel, mesh):
        """KV replication (``shardings.attention_split``: ``"replicate"``)
        over a cache that holds every kv head of the rank's block of
        ``T`` (its ``t0``), on ``model`` rank ``r`` of ``m``; ``q [B, S,
        h/m, dh]`` and ``k, v [B, S, 1, dh]`` the rank's heads.  Returns
        ``[B, S, h/m, dh]``.

        * The new rows that fall in the rank's block are written with every
          kv head (:func:`_kv_rows`: computed from the whole ``wk`` /
          ``wv``, ``1/m`` of the k/v projection's rows).
        * A fresh prefill attends the rank's q heads over its own kv head's
          rows of this call, cast to the cache's dtype as cached; a prefill
          over a filled cache all-gathers the cache's blocks over ``model``
          for the call and takes its kv head.
        * A decode step all-gathers ``q`` over ``model`` (every rank then
          holds all ``h`` heads), decodes over its block through the decode
          slot's log-sum-exp route and merges the blocks
          (:meth:`_decode_blocks`), and takes its ``h/m`` heads."""
        _, s, h, _ = q.shape
        m = mesh.shape["model"]
        kc, vc, ln = cache["k"], cache["v"], cache["len"]
        rows, slots = _block_slots(cache, kc.shape[1], s, m)
        if rows.stop > rows.start:
            kb, vb = _kv_rows(self, x[:, rows], positions[..., rows],
                              k[:, rows], v[:, rows])
            kc[:, slots], vc[:, slots] = kb, vb
        cache["len"] = ln + s
        if s == 1:
            q1 = meshops.all_gather(q[:, 0], mesh, "model", axis=1)
            out = self._decode_blocks(q1, cache, ln + 1, use_kernel, mesh)
            return tp_block(out, h, mesh, dim=1).contiguous()[:, None]
        if ln == 0:                     # the rows just written, as cached
            kk, vv = k.to(kc.dtype), v.to(vc.dtype)
        else:                           # the blocks of every rank, for now
            head = shardings.kv_head_of(mesh.coord("model"), m,
                                        self.cfg.n_kv_heads)
            kk, vv = (meshops.all_gather(c, mesh, "model", axis=1)
                      [:, :ln + s, head:head + 1] for c in (kc, vc))
        return _flash(q, kk, vv, window=self.window, use_kernel=use_kernel)

    def _by_positions(self, x, positions, cache, use_kernel, mesh):
        """The ``"positions"`` split (``shardings.attention_split``) on
        ``model`` rank ``r`` of ``m``.

        * Projections: the rank's ``1/m`` of the columns of ``q``, ``k``
          and ``v`` (and of the replicated biases) for every row,
          all-gathered over ``model`` and only then rotated
          (:func:`_rotated_heads`).
        * Without a cache (a prefill, or training) and in a prefill over a
          cache: the rank attends for its query rows
          (``shardings.position_blocks``: blocks ``r`` and ``2m - 1 - r``
          of ``2m``) over the key rows up to the end of each block, through
          the flash slot (end-aligned), or ``use_kernel=False`` through
          :func:`_attend` over every key row with the block's offset (the
          causal mask keeps the same pairs).  The keys of a fresh prefill
          are this call's rows (cast to the cache's dtype where there is
          one, as the cache holds them); over a filled cache, the cache's
          blocks all-gathered over ``model`` for the call.  The rank's
          ``[B, S_r, h dh]`` then goes to the ranks by an all-to-all
          (``meshops.all_to_all_axis``, each rank's rows padded to the
          longest's), each receiving its ``1/m`` of the columns of every
          row, put back in position order.
        * A decode step: every rank holds ``q`` of all heads; it attends
          over the valid rows of its own block of the cache's ``T`` (the
          cache's ``t0``: ``lm.init_cache``) through the decode slot's
          log-sum-exp route (:func:`block_window` gives the block its rows
          and window; a block with none gets zeros and ``-inf``), the
          ``[B, h, dh + 1]`` float32 outputs and log-sum-exps are
          all-gathered over ``model`` and merged (:func:`merge_blocks`), and
          every rank takes its ``1/m`` of the columns.  A cache that holds
          all of ``T`` (``m`` does not divide it) is attended whole.
        * Each path ends in the rank's rows of ``wo`` and one sum over
          ``model`` (:func:`tp_sum`).

        The new ``k`` and ``v`` rows are written where they fall in the
        rank's block of the cache."""
        cfg, dh = self.cfg, self.cfg.d_head
        b, s, _ = x.shape
        m = mesh.shape["model"]
        h, kvh = cfg.n_heads, cfg.n_kv_heads
        qw, kvw = h * dh, kvh * dh

        def cols(t, width):
            return None if t is None else tp_block(t, width // m, mesh)
        q, k, v = x @ cols(self.wq, qw), x @ cols(self.wk, kvw), \
            x @ cols(self.wv, kvw)
        if self.bq is not None:
            q, k, v = q + cols(self.bq, qw), k + cols(self.bk, kvw), \
                v + cols(self.bv, kvw)
        q = _rotated_heads(q, h, positions, cfg, mesh)
        k = _rotated_heads(k, kvh, positions, cfg, mesh)
        v = tp_gather(v, kvw, mesh).reshape(b, s, kvh, dh)

        ln = 0 if cache is None else _append(cache, k, v, m)
        if cache is not None and s == 1:
            out = self._decode_blocks(q[:, 0], cache, ln + 1, use_kernel,
                                      mesh).reshape(b, 1, qw)
            out = tp_block(out, qw // m, mesh)
        else:
            if cache is None:
                kk, vv = k, v
            elif ln == 0:               # the rows just written, as cached
                kk, vv = (t.to(cache["k"].dtype) for t in (k, v))
            elif "t0" in cache:         # the blocks of every rank, for now
                kk, vv = (meshops.all_gather(cache[c], mesh, "model", axis=1)
                          [:, :ln + s] for c in ("k", "v"))
            else:
                kk, vv = cache["k"][:, :ln + s], cache["v"][:, :ln + s]
            out = self._rows_to_columns(
                self._attend_rows(q, kk, vv, ln, use_kernel, mesh), s, mesh)
        out = (out @ tp_block(self.wo, qw // m, mesh, 0)).to(x.dtype)
        return tp_sum(out, mesh), cache

    def _attend_rows(self, q, kk, vv, ln: int, use_kernel: bool, mesh):
        """``[B, S_r, h dh]``: the attention of this rank's query rows of
        ``q [B, S, h, dh]`` (positions ``ln ..``) over the key rows ``kk,
        vv [B, ln + S, kvh, dh]``."""
        b, s, h, dh = q.shape
        outs = []
        for a, e in _query_blocks(s, mesh):
            if e == a:
                continue
            if use_kernel:
                o = _flash(q[:, a:e], kk[:, :ln + e], vv[:, :ln + e],
                           window=self.window, use_kernel=True)
            else:
                o = _attend(q[:, a:e], kk, vv, window=self.window,
                            q_offset=ln + a)
            outs.append(o)
        if not outs:
            return q.new_zeros((b, 0, h * dh))
        return torch.cat(outs, dim=1).reshape(b, -1, h * dh)

    def _rows_to_columns(self, o: torch.Tensor, s: int, mesh):
        """``[B, S, h dh / m]``: every row's ``1/m`` of the columns of this
        rank, from each rank's ``[B, S_r, h dh]`` rows (``o`` this rank's):
        one all-to-all over ``model`` of the rows padded to the longest
        rank's, then the rows in position order."""
        blocks = shardings.position_blocks(s, mesh.shape["model"])
        rows = [[p for a, e in bl for p in range(a, e)] for bl in blocks]
        n = max(map(len, rows))
        o = F.pad(o, (0, 0, 0, n - o.shape[1]))
        o = meshops.all_to_all_axis(o, mesh, "model", split_axis=2,
                                    concat_axis=1)
        where = [0] * s
        for j, rj in enumerate(rows):
            for i, p in enumerate(rj):
                where[p] = j * n + i
        return o.index_select(1, torch.tensor(where, device=o.device))

    def _decode_blocks(self, q1, cache, valid: int, use_kernel: bool, mesh):
        """``[B, h, dh]`` in q's dtype: the decode of ``q1 [B, h, dh]`` over
        the cache's ``valid`` positions, this rank's block merged with every
        other rank's by their log-sum-exps."""
        kc, vc = cache["k"], cache["v"]
        q1 = q1.contiguous()
        if "t0" not in cache:           # the whole cache on every rank
            return kops.decode_attention(q1, kc, vc, valid,
                                         window=self.window,
                                         use_kernel=use_kernel)
        rows, win = block_window(valid, cache["t0"], kc.shape[1],
                                 self.window)
        o, lse = kops.decode_attention(q1, kc, vc, rows, window=win,
                                       use_kernel=use_kernel,
                                       return_lse=True)
        both = meshops.all_gather(torch.cat([o, lse[..., None]], dim=-1)[None],
                                  mesh, "model", axis=0)
        return merge_blocks(both[..., :-1], both[..., -1]).to(q1.dtype)


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                         device, dtype=torch.bfloat16,
                         kv_heads: int | None = None,
                         rows: tuple[int, int] | None = None) -> dict:
    """``kv_heads`` (default all) the heads a rank's split layer holds;
    ``rows`` ``(t0, n)`` the block of positions ``[t0, t0 + n)`` of the
    ``max_len`` that a rank holds under the ``"positions"`` split (the
    cache then holds ``t0``), default all of them."""
    t = max_len if rows is None else rows[1]
    shape = (batch, t, kv_heads or cfg.n_kv_heads, cfg.d_head)
    out = {"k": torch.zeros(shape, dtype=dtype, device=device),
           "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}
    if rows is not None:
        out["t0"] = rows[0]
    return out


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def _mla_heads(p: MLA) -> int:
    """The heads ``p``'s ``wkv_b`` holds (this rank's under a split)."""
    m = p.cfg.mla
    return p.wkv_b.shape[1] // (m.nope_head_dim + m.v_head_dim)


class MLA(nn.Module):
    """Multi-head latent attention: ``wq_a [d, q_lora]``, ``q_a_norm``,
    ``wq_b [q_lora, h (dn + dr)]``, ``wkv_a [d, r + dr]``, ``kv_a_norm``,
    ``wkv_b [r, h (dn + dv)]`` and ``wo [h dv, d]``, the reference's
    ``init_mla`` names and layouts (``r`` the kv latent's rank, ``dn`` /
    ``dr`` the no-rope and rope halves of a query-key head, ``dv`` a value
    head).  The cache holds only the normalised latent and one rope key per
    position, shared by the heads.

    Under a mesh whose ``model`` axis splits its heads
    (``shardings.mla_split``) the layer is called with ``wq_b``'s and
    ``wkv_b``'s columns and ``wo``'s rows of this rank's ``h/m`` heads
    (``[r h/m, (r + 1) h/m)`` for ``model`` rank ``r``) and with its ``1/m``
    of the columns of the down-projections ``wq_a`` and ``wkv_a``.  It
    all-gathers those two products over ``model`` (:func:`tp_gather`), so
    that ``q_a_norm`` sees the whole ``q_lora`` row and the latent and rope
    key are split apart and normalised whole on every rank; its cache holds
    them for its block of ``T`` (``shardings.local_cache_rows``: the
    reference's bytes, whose specs split the latent's ``r``).  A prefill
    attends its heads over this call's rows (a fresh cache) or over every
    rank's block all-gathered; a decode step attends all heads over its
    block and merges the blocks (:meth:`_decode_blocks`).  It ends in one
    sum over ``model`` (:func:`tp_sum`).  Whole leaves run the layer
    whole."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None):
        super().__init__()
        m, h, d, dt = cfg.mla, cfg.n_heads, cfg.d_model, dtype_of(cfg)
        self.cfg = cfg
        self.wq_a = param(dense_init(gen, d, m.q_lora_rank, dt, device))
        self.q_a_norm = RMSNorm(m.q_lora_rank, cfg.norm_eps, dt, device)
        self.wq_b = param(dense_init(
            gen, m.q_lora_rank, h * (m.nope_head_dim + m.rope_head_dim), dt,
            device))
        self.wkv_a = param(dense_init(gen, d, m.kv_lora_rank + m.rope_head_dim,
                                      dt, device))
        self.kv_a_norm = RMSNorm(m.kv_lora_rank, cfg.norm_eps, dt, device)
        self.wkv_b = param(dense_init(
            gen, m.kv_lora_rank, h * (m.nope_head_dim + m.v_head_dim), dt,
            device))
        self.wo = param(dense_init(gen, h * m.v_head_dim, d, dt, device))

    def _local(self, mesh) -> int:
        """The heads this rank computes: all of them where the leaves are
        whole, else ``wkv_b``'s, which must be ``n_heads / m`` and agree
        with ``wq_b``'s and ``wo``'s."""
        cfg, m, h = self.cfg, self.cfg.mla, _mla_heads(self)
        others = (self.wq_b.shape[1] // (m.nope_head_dim + m.rope_head_dim),
                  self.wo.shape[0] // m.v_head_dim)
        if others != (h, h):
            raise ValueError(f"wkv_b holds {h} heads, wq_b and wo {others}")
        if h == cfg.n_heads:
            return h
        if mesh is None or h * mesh.shape["model"] != cfg.n_heads:
            raise ValueError(f"wkv_b holds {h} of {cfg.n_heads} heads: run "
                             f"the layer under the mesh that splits them")
        return h

    def _q_a(self, x: torch.Tensor, mesh) -> torch.Tensor:
        """``q_a_norm(x @ wq_a)`` over the whole ``q_lora`` row: this
        rank's columns gathered before the norm."""
        return self.q_a_norm(tp_gather(x @ self.wq_a,
                                       self.cfg.mla.q_lora_rank, mesh))

    def project(self, x: torch.Tensor, positions: torch.Tensor, mesh=None):
        """``(q_nope [B,S,h,dn], q_rope [B,S,h,dr], latent [B,S,r], k_rope
        [B,S,dr])`` of ``x [B, S, D]``: the rope halves rotated at
        ``positions``, the latent normalised (what the cache holds); ``h``
        this rank's heads (:meth:`_local`), the latent and rope key
        whole."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        h = self._local(mesh)
        q = self._q_a(x, mesh) @ self.wq_b
        q = q.reshape(b, s, h, m.nope_head_dim + m.rope_head_dim)
        q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        latent, k_rope = tp_gather(
            x @ self.wkv_a, m.kv_lora_rank + m.rope_head_dim, mesh).split(
                [m.kv_lora_rank, m.rope_head_dim], dim=-1)
        k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
        return q_nope, q_rope, self.kv_a_norm(latent), k_rope[:, :, 0]

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: dict | None = None, use_kernel: bool = True,
                mesh=None):
        """x: ``[B, S, D]``.  Returns ``(out, cache)``; a given cache is
        updated in place (its ``latent`` / ``k_rope`` rows ``[len, len +
        S)`` are written, those of its block where it holds one of ``T``,
        and ``len`` advances).  Both forms read the cache's rows ``[0, len
        + S)`` only.  ``use_kernel`` is taken for the
        interface's sake: no kernel runs here.  ``mesh`` is needed only
        where the leaves arrive as this rank's shards."""
        b, s, _ = x.shape
        q_nope, q_rope, latent, k_rope = self.project(x, positions, mesh)
        if cache is None:
            with record_function("mla.prefill"):     # names it in a profile
                out = mla_materialized(self, q_nope, q_rope, latent, k_rope)
        else:
            lc, rc, ln = cache["latent"], cache["k_rope"], cache["len"]
            split = "t0" in cache
            rows, slots = _block_slots(cache, lc.shape[1], s,
                                       mesh.shape["model"] if split else 1)
            lc[:, slots] = latent[:, rows]  # cast to the cache's dtype
            rc[:, slots] = k_rope[:, rows]
            cache["len"] = ln + s
            if not split:
                kv = lc[:, :ln + s], rc[:, :ln + s]
            elif ln == 0:                   # the rows just written, as cached
                kv = latent.to(lc.dtype), k_rope.to(rc.dtype)
            else:                           # every rank's block, for now
                kv = None if s == 1 else tuple(
                    meshops.all_gather(c, mesh, "model", axis=1)[:, :ln + s]
                    for c in (lc, rc))
            if s == 1 and split:
                with record_function("mla.decode"):
                    out = self._decode_blocks(q_nope, q_rope, cache, ln + 1,
                                              mesh)
            elif s == 1:
                with record_function("mla.decode"):
                    out = mla_absorbed_decode(self, q_nope, q_rope, *kv,
                                              valid_len=ln + 1)
            else:     # prefill, fresh or appended: queries end-aligned
                with record_function("mla.prefill"):
                    out = mla_materialized(self, q_nope, q_rope, *kv,
                                           q_offset=ln, valid_len=ln + s)
        out = out.to(x.dtype) @ self.wo
        return (out if q_nope.shape[2] == self.cfg.n_heads
                else tp_sum(out, mesh)), cache

    def _decode_blocks(self, q_nope, q_rope, cache, valid: int, mesh):
        """The absorbed decode step over a cache that holds the rank's block
        of ``T`` (its ``t0``): ``[B, 1, h dv]`` float32 for this rank's
        ``h/m`` heads.  The rank folds ``wkv_b``'s key half into its heads'
        queries (``q_lat``, float32) and all-gathers them with ``q_rope``
        over ``model``, attends all ``h`` heads over the valid rows of its
        block (:func:`mla_block_decode`), merges the blocks by their
        log-sum-exps into its own heads (:func:`_merge_heads`) and applies
        their ``wv_abs``."""
        m = self.cfg.mla
        b, _, h, _ = q_nope.shape
        wk_abs, wv_abs = _absorbed(self)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wk_abs)
        q_all = meshops.all_gather(torch.cat([q_lat, q_rope[:, 0].float()],
                                             dim=-1), mesh, "model", axis=1)
        lc = cache["latent"]
        n, _ = block_window(valid, cache["t0"], lc.shape[1])
        ctx, lse = mla_block_decode(
            *q_all.split([m.kv_lora_rank, m.rope_head_dim], dim=-1),
            lc[:, :n], cache["k_rope"][:, :n], scale=_mla_scale(m))
        out = torch.einsum("bhr,rhd->bhd", _merge_heads(ctx, lse, mesh),
                           wv_abs)
        return out.reshape(b, 1, h * m.v_head_dim)


def _mla_scale(m) -> float:
    return (m.nope_head_dim + m.rope_head_dim) ** -0.5


def mla_materialized(p: MLA, q_nope, q_rope, latent, k_rope, *,
                     q_offset: int = 0, valid_len=None) -> torch.Tensor:
    """MLA's materialised form: ``latent [B, T, r] @ wkv_b`` split into
    per-head ``k_nope`` and ``v``, each head's key ``[k_nope, k_rope]`` (the
    shared rope key broadcast over the heads), then causal :func:`_attend`
    with head widths ``dn + dr`` and ``dv``.  Rows ``T`` are this call's or
    the cache's (bfloat16 rows cast to the weights' dtype, which is exact);
    the queries are rows ``[q_offset, q_offset + S)``; ``h`` the heads of
    ``wkv_b``.  ``[B, S, h dv]`` in the queries' dtype."""
    m, h = p.cfg.mla, _mla_heads(p)
    b, s = q_nope.shape[:2]
    t = latent.shape[1]
    kv = (latent.to(p.wkv_b.dtype) @ p.wkv_b).reshape(
        b, t, h, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].to(k_nope.dtype).expand(
        b, t, h, m.rope_head_dim)], dim=-1)
    out = _attend(q_cat, k_cat, v, causal=True, q_offset=q_offset,
                  valid_len=valid_len, scale=_mla_scale(m))
    return out.reshape(b, s, h * m.v_head_dim)


def mla_absorbed_decode(p: MLA, q_nope, q_rope, latent, k_rope, *,
                        valid_len) -> torch.Tensor:
    """MLA's absorbed form (DeepSeek-V2 §2.1.3): ``wkv_b``'s key half folded
    into the query (``q_lat [B, S, h, r]``), its value half into the output,
    so that attention runs over the latent rows ``[B, T, r]`` themselves,
    every operand float32.  Columns ``>= valid_len`` are masked (no causal
    mask: the decode's one query sees every valid row); ``h`` the heads of
    ``wkv_b``.  ``[B, S, h dv]`` float32."""
    m, h = p.cfg.mla, _mla_heads(p)
    b, s = q_nope.shape[:2]
    t = latent.shape[1]
    wk_abs, wv_abs = _absorbed(p)
    lat = latent.float()
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), wk_abs)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, lat)
              + torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
              ) * _mla_scale(m)
    cols = torch.arange(t, device=latent.device)
    scores = torch.where(cols < valid_len, scores, MASKED)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, lat)
    out = torch.einsum("bshr,rhd->bshd", ctx, wv_abs)
    return out.reshape(b, s, h * m.v_head_dim)


def _absorbed(p: MLA) -> tuple[torch.Tensor, torch.Tensor]:
    """``(wk_abs [r, h, dn], wv_abs [r, h, dv])``: ``wkv_b``'s key and
    value halves in float32, ``h`` its heads."""
    m = p.cfg.mla
    w_abs = p.wkv_b.float().reshape(m.kv_lora_rank, _mla_heads(p),
                                    m.nope_head_dim + m.v_head_dim)
    return w_abs.split([m.nope_head_dim, m.v_head_dim], dim=-1)


def mla_block_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     latent: torch.Tensor, k_rope: torch.Tensor, *,
                     scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The absorbed decode of one query a sequence over one block of the
    latent cache: ``q_lat [B, h, r]`` and ``q_rope [B, h, dr]`` (float32)
    over the block's valid rows ``latent [B, n, r]`` and ``k_rope [B, n,
    dr]``.  ``(ctx [B, h, r], lse [B, h])`` float32: the softmax-weighted
    latent rows and the log-sum-exp of the scaled scores; a block with no
    row gives zeros and ``-inf``.  Blocks merge by their log-sum-exps
    (``merge_blocks``) into :func:`mla_absorbed_decode`'s context over
    their rows."""
    b, h, r = q_lat.shape
    if latent.shape[1] == 0:
        return (q_lat.new_zeros((b, h, r)),
                q_lat.new_full((b, h), float("-inf")))
    lat = latent.float()
    scores = (torch.einsum("bhr,btr->bht", q_lat, lat)
              + torch.einsum("bhd,btd->bht", q_rope, k_rope.float())) * scale
    lse = torch.logsumexp(scores, dim=-1)
    ctx = torch.einsum("bht,btr->bhr", torch.exp(scores - lse[..., None]),
                       lat)
    return ctx, lse


def _merge_heads(ctx: torch.Tensor, lse: torch.Tensor, mesh) -> torch.Tensor:
    """``[B, h/m, r]``: this ``model`` rank's heads of the blocks' contexts
    ``ctx [B, h, r]`` merged by their log-sum-exps ``lse [B, h]`` (each
    rank's over its block): an all-reduce max of ``lse`` over ``model``,
    then one reduce-scatter over the heads of the rescaled contexts and
    their weights ``exp(lse - max)``, ``[B, h, r + 1]``."""
    b, h, r = ctx.shape
    n = mesh.shape["model"]
    w = torch.exp(lse - meshops.psum(lse, mesh, ("model",),
                                     op=dist.ReduceOp.MAX))
    part = torch.cat([ctx * w[..., None], w[..., None]], dim=-1)
    part = meshops.psum_scatter(part.transpose(0, 1).reshape(-1), mesh,
                                ("model",)).view(h // n, b, r + 1)
    return (part[..., :r] / part[..., r:]).transpose(0, 1)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   device, rows: tuple[int, int] | None = None) -> dict:
    """The latent and rope key, bfloat16; ``rows`` ``(t0, n)`` the block of
    positions ``[t0, t0 + n)`` of the ``max_len`` that a rank holds where
    the layer's heads split over ``model`` (the cache then holds ``t0``),
    default all of them."""
    m = cfg.mla
    t = max_len if rows is None else rows[1]
    out = {"latent": torch.zeros((batch, t, m.kv_lora_rank),
                                 dtype=torch.bfloat16, device=device),
           "k_rope": torch.zeros((batch, t, m.rope_head_dim),
                                 dtype=torch.bfloat16, device=device),
           "len": 0}
    if rows is not None:
        out["t0"] = rows[0]
    return out


# ---------------------------------------------------------------------------
# MLP: SwiGLU (3 matrices) or GELU (2)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GELU (``w_up``,
    ``w_down``) of width ``d_ff``.  Under a mesh that splits it over
    ``model`` it is called with this rank's ``f/m`` columns of ``w_gate``
    and ``w_up`` (column-parallel) and rows of ``w_down`` (row-parallel),
    and ends in one sum over ``model`` (:func:`tp_sum`)."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None,
                 d_ff: int | None = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        dt = dtype_of(cfg)
        self.d_ff = d_ff
        gate = dense_init(gen, cfg.d_model, d_ff, dt, device) \
            if cfg.gated_mlp else None
        self.register_parameter("w_gate", None if gate is None else param(gate))
        self.w_up = param(dense_init(gen, cfg.d_model, d_ff, dt, device))
        self.w_down = param(dense_init(gen, d_ff, cfg.d_model, dt, device))

    def forward(self, x, mesh=None):
        f = self.w_up.shape[1]
        if self.w_down.shape[0] != f:
            raise ValueError(f"w_up holds {f} columns, w_down "
                             f"{self.w_down.shape[0]} rows")
        if self.w_gate is not None:
            y = (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
        else:   # jax.nn.gelu's default is the tanh approximation
            y = F.gelu(x @ self.w_up, approximate="tanh") @ self.w_down
        return y if f == self.d_ff else tp_sum(y, mesh)
