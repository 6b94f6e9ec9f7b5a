"""Mesh-side realizations of the TeShu primitives, on ``torch.distributed``.

Counterpart of ``repro.core.meshops``.  The local-cluster backend
(:mod:`.primitives`) defines the semantics; this module maps them onto a
mesh of ranks for the LM integrations:

* ``SEND/RECV``  -> :func:`ring_exchange` (``batch_isend_irecv``)
* ``PART`` + ``SEND*`` -> :func:`all_to_all_axis` / :func:`two_level_all_to_all`
  (``all_to_all_single``)
* ``COMB`` (sum) -> :func:`hier_psum`: reduce-scatter over the fast inner
  axis, an (optionally int8-compressed) all-reduce over the slow outer
  axis, all-gather back; :func:`flat_psum` is the one-all-reduce baseline.
* ``SAMP``       -> :func:`sample_group_mask`, consistent-hash group
  sampling of a key tensor.

The reference's functions run inside ``jax.shard_map`` with the named axes
manual.  These are per-rank SPMD code: every rank of the mesh calls the
same function with the :class:`~repro_torch.launch.mesh.Mesh` and the axis
names in place of shard_map's ambient axes, and gets its own block back.
All-to-all and all-gather are JAX's *tiled* forms: chunk ``j`` of the split
dimension goes to the rank with index ``j`` over the axes (the first axis
named the major one), and the received chunks are concatenated in that
order.  A tensor must lie on the mesh's device type: a CUDA tensor on a
gloo mesh raises (gloo would stage an all-reduce through the host), as
does a CPU tensor on a NCCL mesh.

Every collective call and the bytes handed to it are counted in
``COUNTS`` and ``BYTES`` (by kind: ``all_to_all``, ``all_gather``,
``all_reduce``, ``reduce_scatter``, ``send_recv``); :func:`reset_counts`
zeroes them.

:func:`all_to_all_axis`, :func:`all_gather` and :func:`psum` carry a
gradient: each is a ``torch.autograd.Function`` whose backward is its
adjoint, as ``shard_map``'s transpose takes it.  The all-to-all's is the
reverse all-to-all (``split_axis`` and ``concat_axis`` swapped), the tiled
all-gather's a tiled ``psum_scatter`` over the same axes in the same (JAX)
order, the sum's a sum.  :func:`two_level_all_to_all` is two all-to-alls
and inherits theirs.  A backward's collective is counted under its own
kind, as a forward's is; under ``torch.no_grad`` (serving) nothing is
recorded and the calls are the same.

Two places differ from the reference's wire or arithmetic, not its result:

* The compressed path of :func:`hier_psum` sums its int8 codes as int32:
  neither gloo nor NCCL reduces int16, the reference's type.  The codes'
  sum is an exact integer either way, so the result is the reference's;
  the wire carries 4 bytes a code where the reference's carries 2.
* :func:`hash32` computes in int64, masked to 32 bits after every add and
  multiply (torch has no add, shift or remainder for ``uint32``), and
  returns the uint32 values held in int64.  The seed's offset keeps the
  reference's rule: where ``seed * 0x9E3779B9 + 0x9E3779B9`` does not fit
  in uint32 it raises ``OverflowError``, as ``jnp.uint32`` does, so every
  seed but -1 and 0 raises, and so do :func:`sample_group_mask` and
  :func:`estimate_tokens_per_expert`, which hash with seeds ``0xC0FFEE``
  and ``0x5A11``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

KINDS = ("all_to_all", "all_gather", "all_reduce", "reduce_scatter",
         "send_recv")
COUNTS = dict.fromkeys(KINDS, 0)
BYTES = dict.fromkeys(KINDS, 0)


def reset_counts() -> None:
    for k in KINDS:
        COUNTS[k] = BYTES[k] = 0


def _count(kind: str, x: torch.Tensor) -> None:
    COUNTS[kind] += 1
    BYTES[kind] += x.numel() * x.element_size()


def _check(x: torch.Tensor, mesh) -> None:
    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor on a {mesh.device_type} "
                         f"mesh: move it to {mesh.device_type} first")


# ---------------------------------------------------------------------------
# the collectives in lax's terms (tiled all-to-all and all-gather, psum)
# ---------------------------------------------------------------------------

def all_to_all_axis(x: torch.Tensor, mesh, axis_name, split_axis: int = 0,
                    concat_axis: int = 0) -> torch.Tensor:
    """Vanilla shuffle over one mesh axis or a tuple of axes (the baseline
    global dispatch): ``lax.all_to_all(x, axis_name, split_axis,
    concat_axis, tiled=True)``.  ``split_axis`` is cut into one chunk a
    rank, chunk ``j`` sent to rank ``j``, the chunks received concatenated
    on ``concat_axis`` in source order.  The split axis is moved to the
    front and made contiguous for ``all_to_all_single``, then moved back.
    Its backward is the reverse all-to-all."""
    return _AllToAll.apply(x, mesh, axis_name, split_axis, concat_axis)


def _all_to_all(x: torch.Tensor, mesh, axis_name, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    _check(x, mesh)
    g = mesh.group(axis_name)
    n = g.size
    if x.shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    front = x.movedim(split_axis, 0)
    chunks = front.reshape(n, front.shape[0] // n, *front.shape[1:])
    if not g.in_jax_order:           # position g goes to group rank g
        chunks = chunks[list(g.order)]
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    _count("all_to_all", chunks)
    dist.all_to_all_single(out, chunks, group=g.pg)
    if not g.in_jax_order:           # back to the sources' JAX order
        out = out[_inverse(g.order)]
    if split_axis == concat_axis == 0:
        return out.reshape(x.shape)
    return torch.cat([c.movedim(0, split_axis) for c in out.unbind(0)],
                     dim=concat_axis)


def all_gather(x: torch.Tensor, mesh, axes, axis: int = 0) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=axis, tiled=True)``: every rank's
    block concatenated on ``axis`` in the ranks' order.  Its backward sums
    the gradient over ``axes`` and keeps this rank's block of it (a tiled
    ``psum_scatter`` on ``axis``)."""
    return _AllGather.apply(x, mesh, axes, axis)


def _all_gather(x: torch.Tensor, mesh, axes, axis: int) -> torch.Tensor:
    _check(x, mesh)
    g = mesh.group(axes)
    inp = x.movedim(axis, 0).contiguous()
    out = torch.empty((g.size * inp.shape[0], *inp.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("all_gather", inp)
    dist.all_gather_into_tensor(out, inp, group=g.pg)
    if not g.in_jax_order:
        out = out.view(g.size, *inp.shape)[_inverse(g.order)].reshape(
            out.shape)
    return out.movedim(0, axis)


def psum(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``lax.psum`` (``op`` SUM) or ``lax.pmax`` (MAX) of ``x`` over
    ``axes``: a new tensor.  A sum's backward is the sum of the gradient
    over ``axes``; a MAX carries none."""
    if op == dist.ReduceOp.SUM:
        return _PSum.apply(x, mesh, axes)
    return _psum(x, mesh, axes, op)


def _psum(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    _check(x, mesh)
    out = x.clone(memory_format=torch.contiguous_format)   # NCCL's layout
    _count("all_reduce", out)
    dist.all_reduce(out, op=op, group=mesh.group(axes).pg)
    return out


def psum_scatter(flat: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.psum_scatter(flat, axes, scatter_dimension=0, tiled=True)``:
    the sum over ``axes``, of which this rank keeps chunk ``index``."""
    _check(flat, mesh)
    g = mesh.group(axes)
    chunks = flat.reshape(g.size, -1)
    if not g.in_jax_order:
        chunks = chunks[list(g.order)]
    chunks = chunks.contiguous()
    out = torch.empty(chunks.shape[1], dtype=flat.dtype, device=flat.device)
    _count("reduce_scatter", chunks)
    dist.reduce_scatter_tensor(out, chunks.reshape(-1), group=g.pg)
    return out


def _scatter_sum(g: torch.Tensor, mesh, axes, axis: int) -> torch.Tensor:
    """The adjoint of the tiled all-gather on ``axis``: the sum of ``g``
    over ``axes``, of which this rank keeps its block on ``axis``."""
    front = g.movedim(axis, 0)
    n = mesh.group(axes).size
    block = (front.shape[0] // n, *front.shape[1:])
    return psum_scatter(front.contiguous().reshape(-1), mesh, axes).view(
        block).movedim(0, axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_axis, concat_axis):
        ctx.args = (mesh, axes, split_axis, concat_axis)
        return _all_to_all(x, mesh, axes, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, mesh, axes, concat_axis, split_axis),
                None, None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.args = (mesh, axes, axis)
        return _all_gather(x, mesh, axes, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, axis = ctx.args
        return _scatter_sum(g, mesh, axes, axis), None, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _psum(g, mesh, axes), None, None


def _inverse(order: Sequence[int]) -> list[int]:
    inv = [0] * len(order)
    for g, j in enumerate(order):
        inv[j] = g
    return inv


# ---------------------------------------------------------------------------
# SEND/RECV: neighbor exchange on a ring (the coordinated-template analogue)
# ---------------------------------------------------------------------------

def ring_exchange(x: torch.Tensor, mesh, axis_name: str,
                  shift: int = 1) -> torch.Tensor:
    """SEND to (i+shift), RECV from (i-shift) along a mesh axis
    (``lax.ppermute`` with the perm ``i -> (i + shift) % n``)."""
    _check(x, mesh)
    g = mesh.group(axis_name)
    dst = g.ranks[(g.index + shift) % g.size]
    src = g.ranks[(g.index - shift) % g.size]
    if dst == g.ranks[g.index]:          # the perm sends every block home
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    _count("send_recv", x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, dst, group=g.pg),
            dist.P2POp(dist.irecv, out, src, group=g.pg)]):
        req.wait()
    return out


# ---------------------------------------------------------------------------
# PART + exchange: all-to-all variants
# ---------------------------------------------------------------------------

def two_level_all_to_all(x: torch.Tensor, mesh, outer_axis: str,
                         inner_axis: str) -> torch.Tensor:
    """Two-level exchange [27] on a 2-D mesh slice: merge per-destination
    -group flows.

    ``x`` is laid out ``[outer, inner, ...]`` by destination coordinate;
    the result is ``[outer_src, inner_src, ...]``, identical to the flat
    all-to-all over the combined ``(outer, inner)`` axes, but decomposed
    into a fast intra-pod stage and one merged flow per pod pair across the
    slow boundary: ``O(outer + inner)`` flows per rank instead of
    ``O(outer * inner)``."""
    o, i = mesh.shape[outer_axis], mesh.shape[inner_axis]
    if x.shape[0] != o or x.shape[1] != i:
        raise ValueError(f"x {tuple(x.shape)} is not laid out [{o}, {i}, "
                         f"...] by destination")
    # stage 1 (fast axis): deliver the destination-inner dimension in a pod
    y = all_to_all_axis(x, mesh, inner_axis, split_axis=1, concat_axis=1)
    # stage 2 (slow axis): one merged flow per pod pair
    return all_to_all_axis(y, mesh, outer_axis, split_axis=0,
                           concat_axis=0)


# ---------------------------------------------------------------------------
# COMB = sum: hierarchical / compressed gradient synchronization
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``(codes, scale)``, the
    scale ``(max |x| + 1e-12) / 127`` in x's dtype, the codes rounded half
    to even and clipped to +-127."""
    flat = x.reshape(-1)
    absmax = flat.abs().max() + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def flat_psum(x: torch.Tensor, mesh, axis_names: Sequence[str]
              ) -> torch.Tensor:
    """Vanilla shuffle with combiner: one global all-reduce (the
    baseline)."""
    return psum(x, mesh, tuple(axis_names))


def hier_psum(x: torch.Tensor, mesh, inner_axis: str,
              outer_axis: str | None, *,
              compress_outer: bool = False) -> torch.Tensor:
    """Network-aware all-reduce: RS(inner) -> [quantize] AR(outer)
    [dequantize] -> AG(inner).

    The flattened ``x`` is padded with zeros to a multiple of the inner
    size and cut back after the gather.  Bytes crossing the slow ``outer``
    boundary drop by ``1/size(inner)`` against a flat all-reduce; with
    ``compress_outer`` each element crosses as an int8 code under a scale
    shared over ``outer`` (a MAX all-reduce), the codes summed exactly as
    int32 (4 bytes a code on the wire; the reference's int16 takes 2)."""
    n_inner = mesh.axis_size(inner_axis)
    orig_shape = x.shape
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n_inner
    if pad:
        flat = F.pad(flat, (0, pad))
    shard = psum_scatter(flat, mesh, inner_axis)
    if outer_axis is not None:
        if compress_outer:
            local_scale = shard.abs().max() / 127.0 + 1e-12
            scale = psum(local_scale, mesh, outer_axis, dist.ReduceOp.MAX)
            q = torch.clamp(torch.round(shard / scale), -127, 127).to(
                torch.int32)
            q = psum(q, mesh, outer_axis)
            shard = q.to(shard.dtype) * scale
        else:
            shard = psum(shard, mesh, outer_axis)
    full = all_gather(shard, mesh, inner_axis, axis=0)
    if pad:
        full = full[: full.shape[0] - pad]
    return full.reshape(orig_shape)


def grad_sync(grads, mesh, *, inner_axis: str, outer_axis: str | None,
              mode: str = "hier", compress_outer: bool = False):
    """Apply the selected gradient-shuffle plan to a (nested) dict of
    gradient tensors.  ``mode``: ``flat`` (vanilla all-reduce baseline) or
    ``hier`` (network-aware)."""
    axes = [a for a in (inner_axis, outer_axis) if a]
    if mode == "flat":
        def sync(g):
            return flat_psum(g, mesh, axes)
    elif mode == "hier":
        def sync(g):
            return hier_psum(g, mesh, inner_axis, outer_axis,
                             compress_outer=compress_outer)
    else:
        raise ValueError(f"unknown grad sync mode {mode!r}")

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else sync(t)
    return walk(grads)


# ---------------------------------------------------------------------------
# SAMP on the mesh: consistent-hash group masks over integer key tensors
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _seed_offset(seed: int) -> int:
    """``jnp.uint32(seed * 0x9E3779B9 + 0x9E3779B9)``, raising where it
    does: outside ``[0, 2^32)``."""
    off = seed * _GOLDEN + _GOLDEN
    if not 0 <= off <= _MASK:
        raise OverflowError(f"Python integer {off} out of bounds for uint32")
    return off


def _mix(x: torch.Tensor, offset: int) -> torch.Tensor:
    """The finalizer on the keys' low 32 bits plus ``offset``, in int64:
    every product is masked back to 32 bits (a product of two values under
    2^32 wraps modulo 2^64, which keeps its low 32 bits), so every shift
    sees a non-negative value."""
    z = ((x.to(torch.int64) & _MASK) + offset) & _MASK
    z = ((z ^ (z >> 16)) * _C1) & _MASK
    z = ((z ^ (z >> 13)) * _C2) & _MASK
    return z ^ (z >> 16)


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3-style finalizer of integer keys (the analogue of
    ``messages.splitmix64``, 32-bit): the uint32 values, held in int64."""
    return _mix(x, _seed_offset(seed))


def sample_group_mask(keys: torch.Tensor, rate: float, *,
                      seed: int = 0) -> torch.Tensor:
    """Boolean mask selecting one consistent-hash destination group
    (Figure 4)."""
    s = max(1, int(round(1.0 / rate)))
    j = hash32(torch.tensor([seed], dtype=torch.int32, device=keys.device),
               seed=0xC0FFEE)[0] % s
    return hash32(keys, seed=0x5A11) % s == j


def estimate_tokens_per_expert(expert_ids: torch.Tensor, num_experts: int,
                               rate: float, *, seed: int = 0) -> torch.Tensor:
    """Sampled estimate of the dispatch histogram (float32 ``[E]``), the
    MoE analogue of the paper's reduction-ratio estimate.  Ids lie in
    ``[0, num_experts)``."""
    mask = sample_group_mask(expert_ids, rate, seed=seed)
    ids = torch.where(mask, expert_ids.long(), num_experts).reshape(-1)
    counts = torch.bincount(ids, minlength=num_experts + 1)[:num_experts]
    return counts.to(torch.float32) / rate
