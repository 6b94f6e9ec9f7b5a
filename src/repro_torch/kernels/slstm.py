"""The sLSTM recurrence on the card: ``slstm_scan`` (source:
``csrc/slstm.cu``).

``slstm_scan(xw, w_rec, b, state)`` runs xLSTM's sLSTM cell over the ``S``
steps of ``xw [B, S, 4d]`` (the input product ``x @ w_in``, in x's dtype,
bfloat16 or float32), with ``w_rec [d, 4d]`` and ``b [4d]`` in that dtype,
from ``state`` (``c, n, h, m [B, d]`` float32), and returns ``(hs [B, S,
d] float32, the final state)``; ``state`` is left as it is.  The semantics
are :func:`repro_torch.kernels.ref.slstm_scan_ref`'s, rounding for
rounding but for the recurrent product's float32 sum, which the kernel
takes in another order (:func:`~repro_torch.kernels.ref.slstm_tolerance`
bounds the difference).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version;
a meta tensor is checked as a CUDA one is (but for co-residency, which
only the card answers) and gets empty meta results of the kernel's shapes.
Any other device, dtype or shape raises.  On a CUDA or a meta tensor the
call's work (:func:`.work.slstm_work`) goes to the active counters
(:data:`.work.COUNTERS`).  The kernel is one cooperative launch of ``d /
units`` persistent blocks, all co-resident (checked with
the occupancy API before the launch: a grid that cannot be resident
raises), each owning ``units`` hidden units, with at most one block per
multiprocessor: for bfloat16 the widest of 16, 8 and 4 (the tensor-core
product's widths; 16, so 64 blocks, at d 1,024), else the fewest.  The
blocks pass h from step to step through an exchange buffer and a flag
each, which a buffer per (device, stream) keeps from call to call; each
call's steps publish values above every earlier call's (:class:`FlagBase`),
so nothing is cleared between calls.  It takes ``1 <= B <= 8``, ``S >= 1``
and ``d`` a multiple of 8.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, work
from .ref import SLSTM_STATE, slstm_scan_ref

MAX_BATCH = 8           # the kernel's kMaxB
THREADS = 256           # the kernel's kThreads
MMA_UNITS = (16, 8, 4)  # units a block of the kernel's tensor-core path, the
                        # widest first (fewer blocks, fewer flags to poll)
MMA_MAX_D = 1024        # widths it holds in registers (d a multiple of 16)
MAX_BLOCKS = 2048       # flags a (device, stream) keeps: above any grid
                        # that an H100 holds at once
FLAG_STRIDE = 16        # the kernel's kFlagStride: a flag a 128-byte line
_ERRORS = {-1: "cannot be co-resident on the card",
           -2: "needs more shared memory a block than the card has"}
_SMS: dict[int, int] = {}
_FLAGS: dict[tuple[int, int], tuple] = {}


def default_units(d: int, sms: int, dtype=None) -> int:
    """The hidden units a block: for bfloat16 at a width the tensor-core
    path takes, the first of :data:`MMA_UNITS` dividing ``d`` with ``d /
    units`` blocks at most ``sms``; otherwise the fewest of any."""
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= MMA_MAX_D:
        for u in MMA_UNITS:
            if d % u == 0 and d // u <= sms:
                return u
    return next(u for u in range(1, d + 1) if d % u == 0 and d // u <= sms)


class FlagBase:
    """The base of one (device, stream)'s flags: a call of ``S`` steps
    takes the current base and publishes ``base + 1`` to ``base + S - 1``
    (at most ``base + S``), and the next call's base is ``S + 1`` higher,
    so every flag a call finds shows less than its first awaited step
    ``base + 1``.  64-bit values: 2^63 steps before they wrap."""

    def __init__(self) -> None:
        self.next = 0

    def take(self, s: int) -> int:
        base = self.next
        self.next = base + s + 1
        return base


def _flags(device: torch.device, stream: int) -> tuple:
    """(flags, :class:`FlagBase`) of ``device``'s ``stream``: room for
    ``MAX_BLOCKS`` flags, ``FLAG_STRIDE`` int64 apart, zeroed once and kept
    for the process (launches on one stream never overlap, so they can
    share them)."""
    key = (device.index, stream)
    if key not in _FLAGS:
        _FLAGS[key] = (torch.zeros(MAX_BLOCKS * FLAG_STRIDE,
                                   dtype=torch.int64, device=device),
                       FlagBase())
    return _FLAGS[key]


def slstm_scan(xw: torch.Tensor, w_rec: torch.Tensor, b: torch.Tensor,
               state: dict):
    """The sLSTM recurrence: ``(hs [B, S, d] float32, {"c", "n", "h",
    "m"} [B, d] float32)``."""
    if xw.dim() != 3 or w_rec.dim() != 2 or b.dim() != 1:
        raise ValueError(f"slstm_scan wants xw [B, S, 4d], w_rec [d, 4d] and "
                         f"b [4d]: {tuple(xw.shape)} {tuple(w_rec.shape)} "
                         f"{tuple(b.shape)}")
    bsz, s, d4 = xw.shape
    d = w_rec.shape[0]
    if w_rec.shape[1] != d4 or d4 != 4 * d or b.shape[0] != d4 or s < 1:
        raise ValueError(f"slstm_scan wants xw [B, S>=1, 4d], w_rec [d, 4d] "
                         f"and b [4d]: {tuple(xw.shape)} {tuple(w_rec.shape)} "
                         f"{tuple(b.shape)}")
    if set(state) != set(SLSTM_STATE) or any(
            state[k].shape != (bsz, d) or state[k].dtype != torch.float32
            for k in SLSTM_STATE):
        raise ValueError(f"slstm_scan wants a float32 state c, n, h, m of "
                         f"[{bsz}, {d}]")
    if xw.dtype not in (torch.bfloat16, torch.float32) or \
            w_rec.dtype != xw.dtype or b.dtype != xw.dtype:
        raise TypeError(f"slstm_scan wants xw, w_rec and b of one dtype, "
                        f"bfloat16 or float32: {xw.dtype} {w_rec.dtype} "
                        f"{b.dtype}")
    tensors = (xw, w_rec, b, *(state[k] for k in SLSTM_STATE))
    if any(t.device != xw.device for t in tensors):
        raise ValueError(f"slstm_scan wants every tensor on {xw.device}")
    if xw.device.type == "cpu":
        return slstm_scan_ref(xw, w_rec, b, state)
    if xw.device.type not in ("cuda", "meta"):
        raise ValueError(f"slstm_scan runs on cuda, cpu or meta tensors, not "
                         f"{xw.device}")
    _build.refuse_autograd("slstm_scan", xw, w_rec, b, *state.values())
    if not 1 <= bsz <= MAX_BATCH or d % 8:
        raise ValueError(f"slstm_scan takes 1 <= B <= {MAX_BATCH} and d a "
                         f"multiple of 8: B {bsz}, d {d}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("slstm_scan wants contiguous tensors")
    if work.COUNTERS:
        work.report("slstm_scan", *work.slstm_work(bsz, s, d,
                                                   xw.element_size()),
                    (tuple(xw.shape), tuple(w_rec.shape)))
    if xw.device.type == "meta":
        return (torch.empty((bsz, s, d), dtype=torch.float32, device="meta"),
                {k: torch.empty((bsz, d), dtype=torch.float32, device="meta")
                 for k in SLSTM_STATE})
    index = xw.device.index if xw.device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    hs, out = launch(_build.library("slstm"), xw, w_rec, b, state,
                     default_units(d, _SMS[index], xw.dtype))
    slstm_scan.launches += 1
    return hs, out


slstm_scan.launches = 0


def launch(lib, xw, w_rec, b, state, units: int, *, flags=None):
    """One launch of ``teshu_slstm_scan`` from ``lib`` (the shipped library,
    or a probe built from the same source) with ``units`` hidden units a
    block, on inputs :func:`slstm_scan` has checked; counts nothing.  A
    ``units`` the kernel does not take raises.  ``flags``: a ``(buffer,
    FlagBase)`` of the caller's own, else the stream's."""
    f = lib.teshu_slstm_scan
    if f.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * 14 + [i32, ctypes.c_uint64] + [i32] * 5 + [p]
        f.restype = ctypes.c_int
    bsz, s, _ = xw.shape
    d = w_rec.shape[0]
    stream = _build.stream_of(xw)
    flags, flag_base = flags or _flags(xw.device, stream)
    hs = torch.empty((bsz, s, d), dtype=torch.float32, device=xw.device)
    out = dict(zip(SLSTM_STATE, torch.empty(
        (len(SLSTM_STATE), bsz, d), dtype=torch.float32,
        device=xw.device).unbind(0)))
    hx = torch.empty((2, bsz, d), dtype=xw.dtype, device=xw.device)
    err = f(xw.data_ptr(), w_rec.data_ptr(), b.data_ptr(),
            *(state[k].data_ptr() for k in SLSTM_STATE), hs.data_ptr(),
            *(out[k].data_ptr() for k in SLSTM_STATE), hx.data_ptr(),
            flags.data_ptr(), flags.numel(), flag_base.take(s), bsz, s, d,
            units,
            int(xw.dtype == torch.bfloat16), stream)
    if err in _ERRORS:
        raise RuntimeError(f"slstm_scan: a grid of {d // units} blocks of "
                           f"{units} units {_ERRORS[err]}")
    _build.check(err, "slstm_scan")
    return hs, out
