"""Hymba-style hybrid mixer: attention and Mamba (S6) heads side by side.

Counterpart of ``repro.models.hybrid``.  Both paths read the same normed
input; their outputs, each RMS-normed, are mean-fused with learnable
per-path scales.  The attention path is :class:`~.layers.Attention` with the
layer's sliding window (the flash and decode kernels on the card); the
Mamba path runs as tensor ops, with no kernel of its own.

The selective scan's decay and input tensors are ``[B, S, di, n]``, so it is
chunked as in the reference: a loop over chunks of ``MAMBA_CHUNK`` positions
carries the ``[B, di, n]`` float32 state exactly, and within a chunk an
inclusive scan over its ``L`` positions, written as a log-depth
(Hillis-Steele) scan in place of ``lax.associative_scan``, gives the states
from a zero start, to which the carried state decayed by the cumulative
product is added.  A single decoded token with a state takes the
reference's fast path (one update of the state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .config import ModelConfig
from .layers import Attention, dense_init, dtype_of, normal_init, param, rms_norm

MAMBA_CHUNK = 128


class Mamba(nn.Module):
    """The S6 head's parameters, named as the reference's ``init_mamba``;
    ``log_a`` and ``d_skip`` stay float32 whatever the model's dtype."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None):
        super().__init__()
        ss = cfg.ssm
        d, n = cfg.d_model, ss.state_dim
        di = d * ss.expand
        dt = dtype_of(cfg)
        f32 = torch.float32
        self.w_in = param(dense_init(gen, d, 2 * di, dt, device))
        self.conv = param(normal_init((ss.conv_dim, di), 0.1, dt, device, gen))
        self.w_bcdt = param(dense_init(gen, di, 2 * n + 1, dt, device))
        # S4D-real init: log(1..n) in every row
        self.log_a = param(torch.log(torch.linspace(
            1.0, float(n), n, dtype=f32, device=device)).repeat(di, 1))
        self.d_skip = param(torch.ones(di, dtype=f32, device=device))
        self.w_out = param(dense_init(gen, di, d, dt, device))
        self.dt_bias = param(torch.full((1,), -4.6, dtype=dt, device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state):
    """Depthwise causal convolution of ``x [B, S, di]`` by ``w [K, di]``,
    ``state [B, K-1, di]`` the tail of the past (zeros when None); the K
    products summed in x's dtype in the reference's order.  Returns (out,
    the new tail)."""
    k = w.shape[0]
    pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out, (xp[:, -(k - 1):] if k > 1 else None)


def recording(*ts: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``ts``: grad mode on and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The inclusive scan of ``h_t = a_t h_{t-1} + b_t`` from ``h = 0``
    along axis 1: log2(L) Hillis-Steele steps of the reference's operator
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``, in place: returns the
    ``h`` in ``b``, and ``a`` is overwritten.  When autograd records, the
    same steps out of place (each step's rows joined to the untouched
    head), which give the same bits."""
    off, n = 1, a.shape[1]
    if recording(a, b):
        while off < n:
            b = torch.cat([b[:, :off], b[:, off:] + b[:, :-off] * a[:, off:]],
                          dim=1)
            if 2 * off < n:
                a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
            off *= 2
        return b
    while off < n:
        b[:, off:] += b[:, :-off] * a[:, off:]     # the product made first
        if 2 * off < n:                            # a's last step unused
            a[:, off:] = a[:, :-off] * a[:, off:]
        off *= 2
    return b


def mamba_forward(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                  state: dict | None = None, *, chunk: int = MAMBA_CHUNK):
    """S6 selective scan of ``x [B, S, d]``: ``(out [B, S, d], {"conv":
    [B, K-1, di], "ssm": [B, di, n] float32})``; ``state`` is the same
    dict from the past (None: zeros)."""
    b, s, _ = x.shape
    n = cfg.ssm.state_dim
    xi, z = (x @ p.w_in).chunk(2, dim=-1)                  # [B, S, di]
    di = xi.shape[-1]
    xi, conv_state = _causal_conv(xi, p.conv,
                                  None if state is None else state["conv"])
    xi = F.silu(xi)
    bcdt = (xi @ p.w_bcdt).float()
    bmat, cmat, dt_raw = bcdt.split([n, n, 1], dim=-1)     # [B,S,n] x2, [B,S,1]
    dt = F.softplus(dt_raw + p.dt_bias.float())
    a = -torch.exp(p.log_a)                                # [di, n]
    prev = torch.zeros((b, di, n), dtype=torch.float32, device=x.device) \
        if state is None else state["ssm"].float()
    xif = xi.float()

    if s == 1 and state is not None:                       # decode fast path
        da = torch.exp(dt[..., None] * a)                  # [B, 1, di, n]
        dbx = (dt * xif)[..., None] * bmat[:, :, None, :]
        h = prev * da[:, 0] + dbx[:, 0]                    # [B, di, n]
        y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None] \
            + xif * p.d_skip
    else:
        L = min(chunk, s)
        pad = (-s) % L
        nc = (s + pad) // L

        def chunks(t):                                     # [nc, B, L, *]
            t = F.pad(t, (0, 0, 0, pad))
            return t.reshape(b, nc, L, t.shape[-1]).transpose(0, 1)

        h, ys = prev, []
        for dtc, xic, bc, cc in zip(chunks(dt), chunks(xif), chunks(bmat),
                                    chunks(cmat)):
            dta = dtc[..., None] * a                       # [B, L, di, n]
            dbx = (dtc * xic)[..., None] * bc[:, :, None, :]
            hs = _scan(torch.exp(dta), dbx)
            # the carried state, decayed by the cumulative product
            carry = torch.cumsum(dta, dim=1)
            if recording(hs, carry, h):
                hs = hs + carry.exp() * h[:, None]
            else:
                hs += carry.exp_() * h[:, None]
            ys.append(torch.einsum("bldn,bln->bld", hs, cc))
            h = hs[:, -1]
        y = torch.stack(ys, dim=1).reshape(b, nc * L, di)[:, :s]
        y = y + xif * p.d_skip
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p.w_out, {"conv": conv_state, "ssm": h.float()}


class HymbaMixer(nn.Module):
    """The reference's ``init_hymba_block`` parameters and ``hymba_mixer``:
    attention (with ``window``) and the Mamba head on the same input,
    their RMS-normed outputs mean-fused with per-path scales."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None, window: int = 0):
        super().__init__()
        self.cfg = cfg
        dt = dtype_of(cfg)
        self.attn = Attention(cfg, device=device, gen=gen, window=window)
        self.mamba = Mamba(cfg, device=device, gen=gen)
        for name in ("attn_scale", "mamba_scale", "attn_norm", "mamba_norm"):
            setattr(self, name, param(torch.ones(cfg.d_model, dtype=dt,
                                                 device=device)))

    def forward(self, x, positions, *, cache=None, use_kernel=True):
        """``(fused [B, S, d], cache)``: a given cache ``{"attn", "ssm"}``
        is updated in place (the attention rows, and the Mamba state
        replaced by the new one)."""
        eps = self.cfg.norm_eps
        ao, _ = self.attn(x, positions, use_kernel=use_kernel,
                          cache=None if cache is None else cache["attn"])
        with record_function("hymba.mamba"):    # names it in a profile
            mo, ssm = mamba_forward(self.mamba, self.cfg, x,
                                    None if cache is None else cache["ssm"])
        fused = 0.5 * (rms_norm(ao, self.attn_norm, eps) * self.attn_scale
                       + rms_norm(mo, self.mamba_norm, eps) * self.mamba_scale)
        if cache is not None:
            cache["ssm"] = ssm
        return fused, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    """The Mamba head's zero state: the conv tail ``[B, K-1, di]`` bfloat16
    and the scan state ``[B, di, n]`` float32, as the reference's
    ``init_cache``."""
    di = cfg.d_model * cfg.ssm.expand
    return {"conv": torch.zeros((batch, cfg.ssm.conv_dim - 1, di),
                                dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros((batch, di, cfg.ssm.state_dim),
                               dtype=torch.float32, device=device)}
