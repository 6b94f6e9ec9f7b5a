"""Shared neural layers of the port's LM: RMSNorm, RoPE, GQA attention with
a KV cache, and the SwiGLU / GELU MLP.

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
fused and the blocked plain attention.  MLA comes with its model's slice
and raises here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import MASKED

from .blocked_attention import blocked_attention, use_blocked
from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def param(t: torch.Tensor) -> nn.Parameter:
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


class Attention(nn.Module):
    """GQA self-attention with optional QKV bias, a sliding ``window`` (0:
    global) and a KV cache."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None, window: int = 0):
        super().__init__()
        if cfg.mla is not None:
            raise NotImplementedError("MLA attention comes with the "
                                      "DeepSeek-V2 slice of the port")
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

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache: dict | None = None, use_kernel: bool = True):
        """x: ``[B, S, D]``.  Returns ``(out, cache)``; a given cache is
        updated in place (its ``k``/``v`` rows ``[len, len + S)`` are
        written and ``len`` advances), not copied."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = apply_rope(q.reshape(b, s, cfg.n_heads, cfg.d_head), positions,
                       cfg.rope_theta)
        k = apply_rope(k.reshape(b, s, cfg.n_kv_heads, cfg.d_head), positions,
                       cfg.rope_theta)
        v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)

        if cache is None:
            out = _flash(q, k, v, window=self.window, use_kernel=True) \
                if use_kernel else _attend(q, k, v, window=self.window)
        else:
            kc, vc, ln = cache["k"], cache["v"], cache["len"]
            if ln + s > kc.shape[1]:
                raise ValueError(f"KV cache full: {ln} + {s} positions > "
                                 f"{kc.shape[1]}")
            kc[:, ln:ln + s] = k            # cast to the cache's dtype
            vc[:, ln:ln + s] = v
            cache["len"] = ln + s
            if s == 1:                      # the decode kernel's slot
                out = kops.decode_attention(q[:, 0].contiguous(), kc, vc,
                                            ln + 1, window=self.window,
                                            use_kernel=use_kernel)
                out = out[:, None]
            else:     # prefill, fresh or appended: flash on the cache rows,
                out = _flash(q, kc[:, :ln + s], vc[:, :ln + s],   # end-aligned
                             window=self.window, use_kernel=use_kernel)
        out = out.reshape(b, s, cfg.n_heads * cfg.d_head)
        return (out @ self.wo).to(x.dtype), cache


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                         device, dtype=torch.bfloat16) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


# ---------------------------------------------------------------------------
# MLP: SwiGLU (3 matrices) or GELU (2)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, gen=None,
                 d_ff: int | None = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        dt = dtype_of(cfg)
        gate = dense_init(gen, cfg.d_model, d_ff, dt, device) \
            if cfg.gated_mlp else None
        self.register_parameter("w_gate", None if gate is None else param(gate))
        self.w_up = param(dense_init(gen, cfg.d_model, d_ff, dt, device))
        self.w_down = param(dense_init(gen, d_ff, cfg.d_model, dt, device))

    def forward(self, x):
        if self.w_gate is not None:
            return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x @ self.w_up, approximate="tanh") @ self.w_down
