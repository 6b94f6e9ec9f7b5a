"""Mixture-of-Experts block of the port, with the shuffle layer as its
dispatch service.

Counterpart of ``repro.models.moe``: router top-k (``_route``), fixed
per-expert capacity (``_capacity``; tokens over it drop), the capacity
buffers (``_build_buffers``), the expert FFN (``_expert_ffn``) and the
weighted combine (``_combine``), the shared-expert branch of ``moe_ffn``,
and the dispatch templates that ``cfg.moe.dispatch`` selects when
``moe_ffn`` is given expert-parallel mesh axes (else ``gspmd``):

* ``gspmd``  -- every expert on this rank, routing its own tokens (the
  reference's result); under a mesh the experts are gathered whole from
  their placed shards before the block runs (``models.lm``).
* ``teshu``  -- the explicit dispatch (:func:`_moe_ep`): one flat
  all-to-all over the EP axes (``("pod", "model")`` when multi-pod),
  :func:`repro_torch.core.meshops.all_to_all_axis`.
* ``teshu2`` -- the two-level exchange template [27]: the all-to-all over
  the fast ``model`` axis first, then one merged flow per pod pair
  (:func:`~repro_torch.core.meshops.two_level_all_to_all`); with one EP
  axis, the flat all-to-all.

MoE dispatch is a TeShu shuffle: the router is ``partFunc``, the
all-to-all the transfer, the weighted combine ``combFunc``.  The dispatch
is per-rank SPMD code over a :class:`~repro_torch.launch.mesh.Mesh`: ``x``
is this rank's rows of the batch, and its ``experts`` hold its slice of
``E / ep`` experts (the expert axis of their placement,
``launch.shardings``; the block sees them gathered over ``data``, their
other split).

The expert FFN's products run through the grouped matmul
(:func:`repro_torch.kernels.ops.grouped_matmul`, the ``gmm`` kernel on the
card): on the capacity layout, tile ``i`` of the flattened buffer belongs
to expert ``i // (C / block_n)``, so the reference's ``ecd,edf->ecf``
einsum is ``gmm(buf.reshape(E * C, d), w, repeat(arange(E), C / block_n))``.
The reference's capacity ``cap`` (a multiple of 8) decides which tokens are
kept; only the buffer is padded, to ``cap_pad``, a multiple of the gmm's
``block_n`` (:func:`buffer_layout`).  Token ``p`` of expert ``e`` sits in
slot ``e * cap_pad + p``, so the pad rows stay zero and the combine never
reads them.  The expert-parallel dispatch ships the reference's ``cap``
rows a (source, expert) pair, so its wire carries the reference's bytes,
and lays them into a zeroed ``[e_local, ep * cap_pad, d]`` buffer.

Parameters keep the reference's names and layouts (``router [d, E]``,
``experts.w_gate / w_up [E, d, f]``, ``experts.w_down [E, f, d]``,
``shared.*``), so :mod:`repro_torch.models.convert` maps them one to one.

Training takes the plain path (``use_kernel=False``), which autograd
differentiates: the gmm kernel has no backward.  Under a mesh the dispatch
trains too: its all-to-alls, its all-gather over ``model`` and the aux
loss's ``pmean`` carry their adjoints (:mod:`repro_torch.core.meshops`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import meshops
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gmm import positions_in_group

from . import layers
from .config import ModelConfig
from .layers import dense_init, dtype_of, param


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s own chain of operations, ``x * (1 / (1 + exp(-x)))``,
    each rounded to x's dtype: in bfloat16 it gives the reference's bits,
    which ``F.silu`` (one rounding) does not."""
    return x * (1 / (1 + torch.exp(-x)))


class ExpertStack(nn.Module):
    """``n`` SwiGLU experts: ``w_gate``, ``w_up [n, d, f]``, ``w_down [n, f,
    d]``.  As in the reference's ``init_moe``, one matrix is drawn per
    projection and repeated over the experts (a copy each, so that a caller
    may redraw them)."""

    def __init__(self, cfg: ModelConfig, n: int, *, device, gen=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.moe.d_ff_expert, dtype_of(cfg)
        for name, (d_in, d_out) in (("w_gate", (d, f)), ("w_up", (d, f)),
                                    ("w_down", (f, d))):
            if gen is None:
                w = torch.empty((n, d_in, d_out), dtype=dt, device=device)
            else:
                w = dense_init(gen, d_in, d_out, dt, device)[None].repeat(
                    n, 1, 1)
            setattr(self, name, param(w))


class MoE(nn.Module):
    """The MoE FFN of one block: ``router [d, E]``, ``experts`` and, when
    ``num_shared``, the always-on ``shared`` experts.  Made from ``gen``
    with the reference's ``init_moe`` distributions (the router
    ``0.02``-scaled, each projection ``1/sqrt(d_in)``-scaled and repeated
    over the experts), or empty for a conversion to fill; whole (an
    ``LM`` under a mesh places each of its leaves)."""

    def __init__(self, cfg: ModelConfig, *, device, gen=None):
        super().__init__()
        m = cfg.moe
        self.cfg = cfg
        self.router = param(dense_init(gen, cfg.d_model, m.num_experts,
                                       dtype_of(cfg), device, scale=0.02))
        self.experts = ExpertStack(cfg, m.num_experts, device=device, gen=gen)
        self.shared = ExpertStack(cfg, m.num_shared, device=device, gen=gen) \
            if m.num_shared else None

    def forward(self, x, *, use_kernel: bool = True, mesh=None,
                mesh_axes: tuple[str, ...] = ()):
        return moe_ffn(self, self.cfg, x, mesh=mesh, mesh_axes=mesh_axes,
                       use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# routing, capacity, buffers
# ---------------------------------------------------------------------------

def _route(router_w, x_flat, m):
    """partFunc: ``(eids [T, k] int32, weights [T, k] float32, aux)``.  The
    router matmul runs in the model dtype, then float32 softmax and top-k,
    the weights renormalised, and the load-balance loss ``E * sum_e f_e
    P_e`` (``f_e`` the share of tokens whose top-1 is ``e``, ``P_e`` the
    mean probability of ``e``).  ``lax.top_k`` puts the lower index first
    on a tie and ``torch.topk`` does not promise it: a stable descending
    sort does."""
    logits = (x_flat @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, eids = top.values[:, :m.top_k], top.indices[:, :m.top_k]
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
    # the top-1 one-hot as a comparison: F.one_hot takes other ops on each
    # device (a host check of the ids on the CPU, a scatter on the card, a
    # comparison on meta), where the dry run wants one op sequence
    top1 = torch.arange(m.num_experts, device=eids.device)
    f = (eids[:, :1] == top1).float().mean(0)
    aux = m.num_experts * (f * probs.mean(0)).sum()
    return eids.to(torch.int32), weights, aux


def _capacity(tokens: int, m) -> int:
    cap = int(tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-cap // 8) * 8)


def buffer_layout(cap: int) -> tuple[int, int]:
    """``(block_n, cap_pad)`` for capacity ``cap``: the gmm's row tile and
    ``cap`` rounded up to it.  16, 32 or 64 where that covers ``cap`` (the
    kernel's swapped path, which streams the experts); else 128, so that a
    128-row block of the kernel's compute path owns one expert."""
    block_n = 16 if cap <= 16 else 32 if cap <= 32 else 64 if cap <= 64 \
        else 128
    return block_n, -(-cap // block_n) * block_n


def _build_buffers(x_flat, eids, weights, num_experts: int, cap: int,
                   cap_pad: int | None = None):
    """Scatter tokens into per-expert buffers (the PART primitive):
    ``(buf [E, cap_pad, d], wbuf [E, cap_pad], (slot, keep, tok))``.  The
    ``p``-th assignment (in token order) to expert ``e`` is kept when ``p <
    cap`` and lands in slot ``e * cap_pad + p``; the rest go to the drop
    slot ``E * cap_pad``.  ``cap_pad`` defaults to ``cap``, the reference's
    layout."""
    t, d = x_flat.shape
    k = eids.shape[1]
    cap_pad = cap if cap_pad is None else cap_pad
    dev = x_flat.device
    flat_e = eids.reshape(-1)
    tok = torch.arange(t * k, device=dev) // k
    order, pos_sorted = positions_in_group(flat_e)
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = pos < cap
    slot = torch.where(keep, flat_e.long() * cap_pad + pos,
                       num_experts * cap_pad)
    buf = torch.zeros((num_experts * cap_pad + 1, d), dtype=x_flat.dtype,
                      device=dev)
    buf[slot] = x_flat[tok]
    wbuf = torch.zeros(num_experts * cap_pad + 1, dtype=weights.dtype,
                       device=dev)
    wbuf[slot] = weights.reshape(-1)
    return (buf[:-1].view(num_experts, cap_pad, d),
            wbuf[:-1].view(num_experts, cap_pad), (slot, keep, tok))


# ---------------------------------------------------------------------------
# expert FFN and combine
# ---------------------------------------------------------------------------

def _expert_ffn(w: ExpertStack, x: torch.Tensor, *, block_n: int,
                use_kernel: bool = True) -> torch.Tensor:
    """``x [E, C, d]`` (``C`` a multiple of ``block_n``) through expert
    ``e``'s SwiGLU: three grouped matmuls, ``silu(gate) * up`` in x's
    dtype."""
    e, c, d = x.shape
    tiles = c // block_n
    ids = (torch.arange(e * tiles, device=x.device) // tiles).to(torch.int32)
    flat = x.reshape(e * c, d)

    def mm(a, wt):
        return kops.grouped_matmul(a, wt, ids, block_n=block_n,
                                   group_tiles=tiles,
                                   use_kernel=use_kernel)
    h = silu(mm(flat, w.w_gate)) * mm(flat, w.w_up)
    return mm(h, w.w_down).reshape(e, c, -1).to(x.dtype)


def _combine(out_buf, wbuf, meta, t: int, d: int) -> torch.Tensor:
    """COMB: ``[t, d]``, each token's ``k`` expert outputs times their
    weights (promoted to float32, then cast back to the buffer's dtype)
    summed in slot order ``j = 0..k-1`` into zeros, in the buffer's dtype:
    the order of the reference's sequential scatter-add, where
    ``index_add_`` on the card would add in no fixed order."""
    slot, keep, _ = meta
    flat = out_buf.reshape(-1, d)
    idx = slot.clamp(max=flat.shape[0] - 1)
    y = flat[idx].float() * wbuf.reshape(-1)[idx, None]
    y = torch.where(keep[:, None], y, 0.0).to(out_buf.dtype).view(t, -1, d)
    out = torch.zeros((t, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(y.shape[1]):
        out = out + y[:, j]
    return out


def moe_ffn(p: MoE, cfg: ModelConfig, x: torch.Tensor, *, mesh=None,
            mesh_axes: tuple[str, ...] = (), use_kernel: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D] -> ([B, S, D], aux loss)``: the shared experts (if
    any) on every token, plus the routed experts by ``cfg.moe.dispatch``
    when ``mesh_axes`` (the EP axes of ``mesh``) are given, else by the
    gspmd dispatch.  Under a mesh ``x`` is this rank's rows; shared
    experts held as this rank's ``f / m`` columns over ``model``
    (``shardings.kept_axes``) run their three grouped matmuls at that
    width and end in one sum over ``model``."""
    m = cfg.moe
    b, s, d = x.shape
    out = torch.zeros_like(x)
    if m.num_shared:
        t = b * s
        block_n, t_pad = buffer_layout(t)
        xs = torch.zeros((m.num_shared, t_pad, d), dtype=x.dtype,
                         device=x.device)
        xs[:, :t] = x.reshape(t, d)
        shared = _expert_ffn(p.shared, xs, block_n=block_n,
                             use_kernel=use_kernel)[:, :t]
        shared = shared.float().sum(0).to(x.dtype).reshape(b, s, d)
        if p.shared.w_up.shape[-1] != m.d_ff_expert:   # f / m columns
            shared = layers.tp_sum(shared, mesh)
        out = out + shared
    dispatch = m.dispatch if mesh_axes else "gspmd"
    if dispatch == "gspmd":
        y, aux = _moe_gspmd(p, cfg, x, use_kernel=use_kernel)
    elif mesh is None:
        raise ValueError(f"the {dispatch!r} dispatch over {mesh_axes} "
                         f"needs the mesh")
    else:
        y, aux = _moe_ep(p, cfg, x, mesh, tuple(mesh_axes),
                         two_level=dispatch == "teshu2",
                         use_kernel=use_kernel)
    return out + y, aux


def _moe_gspmd(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
               use_kernel: bool = True):
    m = cfg.moe
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    eids, weights, aux = _route(p.router, x_flat, m)
    cap = _capacity(b * s, m)
    block_n, cap_pad = buffer_layout(cap)
    buf, wbuf, meta = _build_buffers(x_flat, eids, weights, m.num_experts,
                                     cap, cap_pad)
    y = _expert_ffn(p.experts, buf, block_n=block_n, use_kernel=use_kernel)
    return _combine(y, wbuf, meta, b * s, d).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# TeShu: explicit expert-parallel dispatch (vanilla or two-level template)
# ---------------------------------------------------------------------------

def _moe_ep(p: MoE, cfg: ModelConfig, x: torch.Tensor, mesh,
            ep_axes: tuple[str, ...], *, two_level: bool,
            use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert-parallel dispatch through the shuffle layer, on
    this rank (the reference's ``_moe_shard_map``).

    Geometry: tokens stay split over the batch axes ``("pod", "data")``;
    experts are split over ``ep_axes`` and replicated over ``data``.  The
    ranks spanning ``ep_axes`` at one ``data`` coordinate form one EP group
    covering every expert; the shuffle is an all-to-all over exactly those
    axes.  Each ``model`` coordinate routes its own slice of the rank's
    tokens (they are replicated over ``model``), and an all-gather over
    ``model`` restores them all.

    The aux loss is the ``pmean`` of the ranks' own over the mesh.
    Gradients flow back through both exchanges, the padded receive buffer
    and its mask, the all-gather and the ``pmean``."""
    m = cfg.moe
    e_total = m.num_experts
    ep = mesh.axis_size(ep_axes)
    if e_total % ep:
        raise ValueError(f"{e_total} experts do not divide over {ep} ranks")
    e_local = e_total // ep
    if p.experts.w_gate.shape[0] != e_local:
        raise ValueError(f"the block holds {p.experts.w_gate.shape[0]} "
                         f"experts, not this rank's {e_local} of {e_total}")
    msize = mesh.shape["model"]
    bl, s, d = x.shape
    tokens = bl * s
    do_slice = tokens % msize == 0 and tokens >= msize
    x_flat = x.reshape(tokens, d)
    if do_slice:                          # divide routing work over 'model'
        tl = tokens // msize
        x_my = x_flat[mesh.coord("model") * tl:][:tl]
    else:                                 # tiny (decode) batches: route all
        tl, x_my = tokens, x_flat
    eids, weights, aux = _route(p.router, x_my, m)
    cap = _capacity(tl, m)
    buf, wbuf, meta = _build_buffers(x_my, eids, weights, e_total, cap)
    # the shuffle template delivers the per-expert buffers to their ranks,
    # the routing weight riding along as one column in x's dtype
    payload = torch.cat([buf, wbuf[..., None].to(buf.dtype)], dim=-1
                        ).reshape(ep, e_local * cap, d + 1)
    del buf
    payload = _ep_shuffle(payload, mesh, ep_axes, two_level).view(
        ep, e_local, cap, d + 1)
    # my local experts over the tokens from every source of the EP group,
    # source j's in rows [j * cap_pad, j * cap_pad + cap) of each expert
    block_n, cap_pad = buffer_layout(cap)
    xb = torch.zeros((e_local, ep, cap_pad, d), dtype=x.dtype,
                     device=x.device)
    xb[:, :, :cap] = payload[..., :d].transpose(0, 1)
    mask = torch.zeros((e_local, ep, cap_pad), dtype=torch.bool,
                       device=x.device)
    mask[:, :, :cap] = (payload[..., d] > 0).transpose(0, 1)
    del payload
    yb = _expert_ffn(p.experts, xb.view(e_local, ep * cap_pad, d),
                     block_n=block_n, use_kernel=use_kernel)
    del xb
    yb = torch.where(mask.view(e_local, ep * cap_pad, 1), yb, 0.0)
    # the reverse shuffle: outputs back to their sources, in the same slots
    yb = yb.view(e_local, ep, cap_pad, d)[:, :, :cap].transpose(0, 1)
    yb = _ep_shuffle(yb.reshape(ep, e_local * cap, d), mesh, ep_axes,
                     two_level)
    y = _combine(yb.view(e_total, cap, d), wbuf, meta, tl, d)
    if do_slice:
        y = meshops.all_gather(y, mesh, "model", axis=0)
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    aux = meshops.psum(aux, mesh, axes) / mesh.axis_size(axes)
    return y.reshape(bl, s, d), aux


def _ep_shuffle(x: torch.Tensor, mesh, ep_axes: tuple[str, ...],
                two_level: bool) -> torch.Tensor:
    """The dispatch shuffle: flat all-to-all (vanilla template) or the
    two-level exchange template over (slow pod boundary, fast model
    axis)."""
    if two_level and len(ep_axes) == 2:
        o, i = mesh.shape[ep_axes[0]], mesh.shape[ep_axes[1]]
        return meshops.two_level_all_to_all(
            x.reshape(o, i, *x.shape[1:]), mesh, ep_axes[0], ep_axes[1]
        ).reshape(x.shape)
    return meshops.all_to_all_axis(x, mesh, ep_axes, split_axis=0,
                                   concat_axis=0)
