"""xLSTM blocks of the port: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of ``repro.models.ssm``, with its parameters under its names
(``MLSTM``: ``w_up``, ``wq``, ``wk``, ``wv``, ``w_ifo``, ``b_ifo``,
``w_down``, ``norm``; ``SLSTM``: ``w_in``, ``w_rec``, ``b``, ``w_down``,
``norm``) and every cast to x's dtype where the reference has it.

mLSTM has three forms, as in the reference: the parallel one
(:func:`mlstm_parallel`, decay-masked linear attention; the training form,
on no served path), the chunkwise one (:func:`mlstm_chunked`, chunks of 256
carrying ``(C, n, m)`` exactly; a prefill, which returns the decode state)
and the recurrent step (:func:`mlstm_step`, one token).  They run as
tensor ops; the reference's ``lax.scan`` over chunks is a Python loop.

sLSTM mixes its hidden state recurrently, so it is sequential:
:func:`slstm_forward` computes the input product ``x @ w_in`` for every
token as one matmul and hands the recurrence to
:func:`repro_torch.kernels.ops.slstm_scan` (the ``slstm_scan`` kernel on
the card, its plain loop on the CPU or with ``use_kernel=False``).

Under a mesh (``shardings.mixer_split``) both mixers take one rule: each
in-projection that arrives as this rank's ``model`` columns (mLSTM's
``w_up``, ``wq``, ``wk``, ``wv`` and ``w_ifo``, sLSTM's ``w_in``) is
multiplied on them and its output all-gathered whole over ``model``, so
the core (the chunkwise or recurrent mLSTM with its ``(C, n, m)`` state,
the sLSTM recurrence over the whole ``w_rec`` and state, which reads all
of ``h`` at every step) runs whole on every rank, and the normed output
meets ``w_down``'s rows of the rank, a row-parallel product ending in one
sum over ``model``.  ``w_up``'s columns hold ``xi`` and ``zg`` side by
side and ``w_ifo``'s are laid out ``(3, h)``: each is gathered before it
is split.  A leaf that arrives whole runs whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import softplus

from .config import ModelConfig
from .layers import (dense_init, dtype_of, param, rms_norm, tp_block,
                     tp_gather, tp_sum)
from .moe import silu

MLSTM_CHUNK = 256


class MLSTM(nn.Module):
    """The reference's ``init_mlstm``: up-projection to ``2 di`` (the inner
    branch and the output gate's branch, ``di = 2 d``), q, k, v, per-head
    input / forget / output gates, and the down-projection."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        di = 2 * d
        dt = dtype_of(cfg)
        self.w_up = param(dense_init(gen, d, 2 * di, dt, device))
        self.wq = param(dense_init(gen, di, di, dt, device))
        self.wk = param(dense_init(gen, di, di, dt, device))
        self.wv = param(dense_init(gen, di, di, dt, device))
        self.w_ifo = param(dense_init(gen, di, 3 * h, dt, device))
        self.b_ifo = param(torch.zeros(3 * h, dtype=dt, device=device))
        self.w_down = param(dense_init(gen, di, d, dt, device))
        self.norm = param(torch.ones(di, dtype=dt, device=device))


class SLSTM(nn.Module):
    """The reference's ``init_slstm``: z, i, f, o pre-activations from the
    input (``w_in``) and the recurrent state (``w_rec``, scale 0.02)."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None):
        super().__init__()
        d = cfg.d_model
        dt = dtype_of(cfg)
        self.w_in = param(dense_init(gen, d, 4 * d, dt, device))
        self.w_rec = param(dense_init(gen, d, 4 * d, dt, device, scale=0.02))
        self.b = param(torch.zeros(4 * d, dtype=dt, device=device))
        self.w_down = param(dense_init(gen, d, d, dt, device))
        self.norm = param(torch.ones(d, dtype=dt, device=device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _up(p: MLSTM, cfg: ModelConfig, x: torch.Tensor, mesh):
    """``(xi, zg)`` ``[..., di]`` of ``x @ w_up``, gathered whole over
    ``model`` where ``w_up`` holds the rank's columns."""
    return tp_gather(x @ p.w_up, 4 * cfg.d_model, mesh).chunk(2, dim=-1)


def _qkv_gates(p: MLSTM, cfg: ModelConfig, xi: torch.Tensor, mesh=None):
    """q, k, v ``[..., h, dh]`` float32 (k divided by ``sqrt(dh)`` in x's
    dtype, the divisor rounded to it first, as jax takes a Python scalar)
    and the gates ``log_i``, ``log_f``, ``o`` ``[..., h]`` float32 (the
    gates' bias added in x's dtype); each product gathered whole over
    ``model`` where its matrix holds the rank's columns."""
    h = cfg.n_heads
    lead, di = xi.shape[:-1], xi.shape[-1]
    dh = di // h
    root = torch.tensor(dh ** 0.5, dtype=xi.dtype, device=xi.device)
    q = tp_gather(xi @ p.wq, di, mesh).reshape(*lead, h, dh).float()
    k = (tp_gather(xi @ p.wk, di, mesh) / root).reshape(*lead, h, dh).float()
    v = tp_gather(xi @ p.wv, di, mesh).reshape(*lead, h, dh).float()
    gates = (tp_gather(xi @ p.w_ifo, 3 * h, mesh) + p.b_ifo).reshape(
        *lead, 3, h).float()
    log_i = -softplus(-gates[..., 0, :])
    log_f = -softplus(-gates[..., 1, :])
    o = torch.sigmoid(gates[..., 2, :])
    return q, k, v, log_i, log_f, o


def _down(w_down: torch.Tensor, y: torch.Tensor, mesh) -> torch.Tensor:
    """``y @ w_down``; where ``w_down`` holds the rank's ``model`` rows,
    the rank's block of ``y``'s columns times them, summed over
    ``model``."""
    rows = w_down.shape[0]
    out = tp_block(y, rows, mesh) @ w_down
    return out if rows == y.shape[-1] else tp_sum(out, mesh)


def _mlstm_out(p: MLSTM, cfg: ModelConfig, out: torch.Tensor, zg, dtype,
               mesh=None):
    """``out`` (float32, gated) cast to x's dtype, normed over the whole
    ``di``, times ``silu(zg)``, projected down (:func:`_down`)."""
    out = rms_norm(out.to(dtype), p.norm, cfg.norm_eps) * silu(zg)
    return _down(p.w_down, out, mesh)


def mlstm_parallel(p: MLSTM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The exact parallel form (training): decay-masked linear attention
    over an ``S x S`` decay matrix, max-stabilised per query row."""
    b, s, _ = x.shape
    xi, zg = _up(p, cfg, x, None)
    q, k, v, log_i, log_f, o = _qkv_gates(p, cfg, xi)
    a = torch.cumsum(log_f, dim=1)                          # [B, S, h]
    dmat = a[:, :, None, :] - a[:, None, :, :] + log_i[:, None, :, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    dmat = torch.where(mask[None, :, :, None], dmat, -torch.inf)
    dmax = dmat.amax(dim=2, keepdim=True)
    dmat = torch.exp(dmat - dmax.clamp(min=0.0))
    logits = torch.einsum("bihd,bjhd->bijh", q, k) * dmat
    norm = torch.maximum(logits.sum(dim=2).abs(),
                         torch.exp(-dmax[:, :, 0].clamp(min=0.0)))
    out = torch.einsum("bijh,bjhd->bihd", logits, v)
    out = (out / (norm[..., None] + 1e-6)) * o[..., None]
    return _mlstm_out(p, cfg, out.reshape(b, s, -1), zg, x.dtype)


def init_mlstm_state(cfg: ModelConfig, batch: int, *, device) -> dict:
    """``C [B, h, dh, dh]``, ``n [B, h, dh]`` zeros and ``m [B, h]`` at
    -1e30, float32."""
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=f32, device=device)}


def mlstm_chunked(p: MLSTM, cfg: ModelConfig, x: torch.Tensor,
                  state: dict | None = None, *, chunk: int = MLSTM_CHUNK,
                  mesh=None):
    """The chunkwise-parallel mLSTM: an ``L x L`` decay matrix within each
    chunk of ``L = min(chunk, S)`` positions, the ``(C, n, m)`` state
    carried exactly across chunks.  A ragged tail is padded with input
    gates at -1e30 (nothing added) and forget gates at 0 (the state kept),
    and cut after.  Returns ``(out [B, S, d], {"C", "n", "m"})``; ``state``
    (None: zeros) is not modified."""
    b, s, _ = x.shape
    xi, zg = _up(p, cfg, x, mesh)
    q, k, v, log_i, log_f, o = _qkv_gates(p, cfg, xi, mesh)
    h, dh = q.shape[2], q.shape[3]
    L = min(chunk, s)
    pad = (-s) % L
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    nc = (s + pad) // L
    st = init_mlstm_state(cfg, b, device=x.device) if state is None else state
    C, n, m_in = st["C"], st["n"], st["m"]
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    outs = []
    for i in range(nc):
        rows = slice(i * L, (i + 1) * L)
        qb, kb, vb, li, lf = (t[:, rows] for t in (q, k, v, log_i, log_f))
        a = torch.cumsum(lf, dim=1)                         # [B, L, h]
        dmat = a[:, :, None, :] - a[:, None, :, :] + li[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, -torch.inf)
        m_row = torch.maximum(dmat.amax(dim=2), a + m_in[:, None, :])
        w = torch.exp(dmat - m_row[:, :, None, :])          # [B, L, L, h]
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) * w
        inter_w = torch.exp(a + m_in[:, None, :] - m_row)   # [B, L, h]
        num = torch.einsum("btsh,bshd->bthd", scores, vb) \
            + inter_w[..., None] * torch.einsum("bhkv,bthk->bthv", C, qb)
        den = scores.sum(dim=2) \
            + inter_w * torch.einsum("bhk,bthk->bth", n, qb)
        den = torch.maximum(den.abs(), torch.exp(-m_row))
        outs.append(num / (den[..., None] + 1e-6))          # [B, L, h, dh]
        # the state at the chunk's end (row L - 1 of the same factorisation)
        a_end = a[:, -1:, :]
        m_out = torch.maximum((a_end - a + li).amax(dim=1),
                              a_end[:, 0] + m_in)           # [B, h]
        kw = torch.exp(a_end - a + li - m_out[:, None, :])  # [B, L, h]
        decay = torch.exp(a_end[:, 0] + m_in - m_out)
        C = decay[..., None, None] * C \
            + torch.einsum("blh,blhk,blhv->bhkv", kw, kb, vb)
        n = decay[..., None] * n + torch.einsum("blh,blhk->bhk", kw, kb)
        m_in = m_out
    out = torch.cat(outs, dim=1)[:, :s]
    out = (out * o[..., None]).reshape(b, s, h * dh)
    return _mlstm_out(p, cfg, out, zg, x.dtype, mesh), \
        {"C": C, "n": n, "m": m_in}


def mlstm_step(p: MLSTM, cfg: ModelConfig, x: torch.Tensor, state: dict, *,
               mesh=None):
    """The recurrent form, one token: ``x [B, 1, d]`` -> ``(out [B, 1, d],
    the new state)``; ``state`` is not modified."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mlstm_step takes one token: x {tuple(x.shape)}")
    xi, zg = _up(p, cfg, x[:, 0], mesh)
    q, k, v, log_i, log_f, o = _qkv_gates(p, cfg, xi, mesh)  # [B, h, dh]
    m_new = torch.maximum(log_f + state["m"], log_i)        # [B, h]
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    C = f_s[..., None, None] * state["C"] \
        + i_s[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(),
                        torch.exp(-m_new))
    out = (num / (den[..., None] + 1e-6)) * o[..., None]
    out = _mlstm_out(p, cfg, out.reshape(b, -1), zg, x.dtype, mesh)
    return out[:, None], {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_state(cfg: ModelConfig, batch: int, *, device) -> dict:
    """``c, n, h [B, d]`` zeros and ``m [B, d]`` at -1e30, float32."""
    shape, f32 = (batch, cfg.d_model), torch.float32
    st = {k: torch.zeros(shape, dtype=f32, device=device) for k in "cnh"}
    st["m"] = torch.full(shape, -1e30, dtype=f32, device=device)
    return st


def slstm_forward(p: SLSTM, cfg: ModelConfig, x: torch.Tensor,
                  state: dict | None = None, *, use_kernel: bool = True,
                  mesh=None):
    """``x [B, S, d]`` -> ``(out [B, S, d], the final state)``: the input
    product for every token as one matmul (gathered whole over ``model``
    where ``w_in`` holds the rank's columns: the gates lie ``[z | i | f |
    o]``, so a block of columns is never one unit's four; the gathered
    product made contiguous, as the kernel takes it), the recurrence on
    ``kops.slstm_scan`` over the whole ``w_rec`` and state, its float32
    ``hs`` cast to x's dtype, normed and projected down
    (:func:`_down`).  ``state`` (None: zeros) is not modified."""
    st = init_slstm_state(cfg, x.shape[0], device=x.device) \
        if state is None else state
    xw = tp_gather(x @ p.w_in, 4 * cfg.d_model, mesh).contiguous()
    hs, st = kops.slstm_scan(xw, p.w_rec, p.b, st, use_kernel=use_kernel)
    hs = rms_norm(hs.to(x.dtype), p.norm, cfg.norm_eps)
    return _down(p.w_down, hs, mesh), st
