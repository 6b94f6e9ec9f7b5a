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
product is added.  Under autograd the scan is one ``autograd.Function``
whose backward is the reverse recurrence, so that a chunk keeps its decays
and states, not every step of the log-depth scan.  A single decoded token with a state takes the
reference's fast path (one update of the state).

Under a mesh whose ``model`` axis splits the Mamba head
(``shardings.mixer_split``: ``m`` divides ``di``) the head is called with
this rank's ``2 di / m`` columns of ``w_in`` and its ``di / m`` channels of
``conv``, ``log_a`` and ``w_out`` (rows), and with ``d_skip`` and
``w_bcdt`` whole.  ``w_in``'s columns hold ``x`` and ``z`` side by side, so
a contiguous block is all ``x`` on the first half of the ranks and all
``z`` on the rest: the rank all-gathers its product and takes its own
channels of both (:func:`_x_and_z`).  ``w_bcdt`` contracts over the
channels: the rank multiplies its channels by their rows and sums the
``[B, S, 2n + 1]`` product over ``model`` before ``B``, ``C`` and ``dt``
are split off.  The scan and its state (``conv [B, K-1, di/m]``, ``ssm
[B, di/m, n]``, the reference's ``cache_spec``) hold the rank's channels,
and ``w_out``'s row-parallel product ends in one sum.  The attention
beside it splits its heads as :class:`~.layers.Attention` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .config import ModelConfig
from .layers import (Attention, dense_init, dtype_of, normal_init, param,
                     rms_norm, tp_block, tp_gather, tp_sum)

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


def _scan_in_place(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The inclusive scan of ``h_t = a_t h_{t-1} + b_t`` from ``h = 0``
    along axis 1: log2(L) Hillis-Steele steps of the reference's operator
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``, in place: returns the
    ``h`` in ``b``, and ``a`` is overwritten."""
    off, n = 1, a.shape[1]
    while off < n:
        b[:, off:] += b[:, :-off] * a[:, off:]     # the product made first
        if 2 * off < n:                            # a's last step unused
            a[:, off:] = a[:, :-off] * a[:, off:]
        off *= 2
    return b


class _Scan(torch.autograd.Function):
    """:func:`_scan_in_place` on copies of ``a`` and ``b`` under autograd.
    It saves ``a`` and the states ``h`` (``a`` is the caller's ``exp``
    output, which autograd keeps anyway) where autograd of the log-depth
    steps would keep every step's operands.  The backward is the reverse
    recurrence: ``lam_t = g_t + a_{t+1} lam_{t+1}`` (the same scan over the
    flipped rows), then ``db = lam`` and ``da_t = lam_t h_{t-1}`` (0 at
    ``t = 0``, whose ``h_{-1}`` is 0)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _scan_in_place(a.clone(), b.clone())
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        shifted = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        lam = _scan_in_place(shifted.flip(1), g.flip(1)).flip(1)
        da = torch.cat([torch.zeros_like(lam[:, :1]), lam[:, 1:] * h[:, :-1]],
                       dim=1)
        return da, lam


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The inclusive scan of ``h_t = a_t h_{t-1} + b_t`` from ``h = 0``
    along axis 1 (:func:`_scan_in_place`: ``a`` and ``b`` are overwritten
    and ``h`` returned in ``b``); when autograd records, the same steps on
    copies with the reverse recurrence as their backward (:class:`_Scan`),
    which give the same bits."""
    if recording(a, b):
        return _Scan.apply(a, b)
    return _scan_in_place(a, b)


def _channels(p: Mamba, cfg: ModelConfig, mesh) -> int:
    """The channels ``p`` holds: all ``di`` where its leaves are whole,
    else ``conv``'s, which must be ``di / m`` and agree with ``w_in``'s,
    ``log_a``'s and ``w_out``'s."""
    di = cfg.d_model * cfg.ssm.expand
    c = p.conv.shape[1]
    if (p.w_in.shape[1], p.log_a.shape[0], p.w_out.shape[0]) != (2 * c, c, c):
        raise ValueError(f"conv holds {c} channels, w_in "
                         f"{p.w_in.shape[1]} columns, log_a "
                         f"{p.log_a.shape[0]} and w_out {p.w_out.shape[0]} "
                         f"rows")
    if c != di and (mesh is None or c * mesh.shape["model"] != di):
        raise ValueError(f"conv holds {c} of {di} channels: run the head "
                         f"under the mesh that splits them")
    return c


def _x_and_z(p: Mamba, x: torch.Tensor, di: int, c: int, mesh):
    """This rank's ``c`` channels of ``x`` and of ``z``: ``x @ w_in``
    all-gathered whole over ``model`` where ``w_in`` holds the rank's
    columns, then each half's block of the rank."""
    xz = tp_gather(x @ p.w_in, 2 * di, mesh)
    return tp_block(xz[..., :di], c, mesh), tp_block(xz[..., di:], c, mesh)


def mamba_forward(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                  state: dict | None = None, *, chunk: int = MAMBA_CHUNK,
                  mesh=None):
    """S6 selective scan of ``x [B, S, d]``: ``(out [B, S, d], {"conv":
    [B, K-1, c], "ssm": [B, c, n] float32})``; ``state`` is the same
    dict from the past (None: zeros).  ``c`` is ``di``, or this rank's
    ``di / m`` channels where ``p`` holds them (see the module's
    docstring); ``mesh`` is needed only then."""
    b, s, _ = x.shape
    n, di = cfg.ssm.state_dim, cfg.d_model * cfg.ssm.expand
    c = _channels(p, cfg, mesh)
    xi, z = _x_and_z(p, x, di, c, mesh)                    # [B, S, c]
    xi, conv_state = _causal_conv(xi, p.conv,
                                  None if state is None else state["conv"])
    xi = F.silu(xi)
    bcdt = xi @ tp_block(p.w_bcdt, c, mesh, 0)
    bcdt = (bcdt if c == di else tp_sum(bcdt, mesh)).float()
    bmat, cmat, dt_raw = bcdt.split([n, n, 1], dim=-1)     # [B,S,n] x2, [B,S,1]
    dt = F.softplus(dt_raw + p.dt_bias.float())
    a = -torch.exp(p.log_a)                                # [c, n]
    d_skip = tp_block(p.d_skip, c, mesh, 0)
    prev = torch.zeros((b, c, n), dtype=torch.float32, device=x.device) \
        if state is None else state["ssm"].float()
    xif = xi.float()

    if s == 1 and state is not None:                       # decode fast path
        da = torch.exp(dt[..., None] * a)                  # [B, 1, c, n]
        dbx = (dt * xif)[..., None] * bmat[:, :, None, :]
        h = prev * da[:, 0] + dbx[:, 0]                    # [B, c, n]
        y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None] \
            + xif * d_skip
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
            dta = dtc[..., None] * a                       # [B, L, c, n]
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
        y = torch.stack(ys, dim=1).reshape(b, nc * L, c)[:, :s]
        y = y + xif * d_skip
    y = (y * F.silu(z.float())).to(x.dtype) @ p.w_out
    return (y if c == di else tp_sum(y, mesh)), \
        {"conv": conv_state, "ssm": h.float()}


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

    def forward(self, x, positions, *, cache=None, use_kernel=True,
                mesh=None):
        """``(fused [B, S, d], cache)``: a given cache ``{"attn", "ssm"}``
        is updated in place (the attention rows, and the Mamba state
        replaced by the new one).  ``mesh`` is needed only where the
        leaves arrive as this rank's heads or channels; both paths end in
        their sums, so the norms and the fuse read whole outputs."""
        eps = self.cfg.norm_eps
        ao, _ = self.attn(x, positions, use_kernel=use_kernel, mesh=mesh,
                          cache=None if cache is None else cache["attn"])
        with record_function("hymba.mamba"):    # names it in a profile
            mo, ssm = mamba_forward(self.mamba, self.cfg, x,
                                    None if cache is None else cache["ssm"],
                                    mesh=mesh)
        fused = 0.5 * (rms_norm(ao, self.attn_norm, eps) * self.attn_scale
                       + rms_norm(mo, self.mamba_norm, eps) * self.mamba_scale)
        if cache is not None:
            cache["ssm"] = ssm
        return fused, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, *, device,
                   channels: int | None = None) -> dict:
    """The Mamba head's zero state: the conv tail ``[B, K-1, di]`` bfloat16
    and the scan state ``[B, di, n]`` float32, as the reference's
    ``init_cache``; ``channels`` (default all ``di``) those a rank's split
    head holds."""
    di = channels or cfg.d_model * cfg.ssm.expand
    return {"conv": torch.zeros((batch, cfg.ssm.conv_dim - 1, di),
                                dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros((batch, di, cfg.ssm.state_dim),
                               dtype=torch.float32, device=device)}
