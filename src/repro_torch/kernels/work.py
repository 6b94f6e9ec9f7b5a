"""What one call of each LM kernel does: its bytes and operations, and the
counters it reports them to.

The kernels are launched through ``ctypes``, so torch's dispatcher, and
with it a ``TorchDispatchMode`` such as the dry run's counter
(:class:`repro_torch.launch.op_analysis.OpCounter`), never sees them.
Each LM kernel's wrapper therefore reports its own work, by the formula of
this module, to every counter in :data:`COUNTERS` (none is there unless a
counter is active, and then the report costs one call): on a CUDA tensor
where it launches its kernel, and on a meta tensor, where it returns a
result of the kernel's shape alone.  On a CPU tensor it reports nothing:
the plain version's own operations reach the counter.

The same formulas give the bound column of ``chip_smoke.py``'s ``kernels``
line: each input read once and each output written once (bytes), and the
operations the kernel's math does on these inputs.
"""
from __future__ import annotations

import numpy as np

# the active counters: each has ``kernel(name, nbytes, flops, shapes)``
COUNTERS: list = []


def report(name: str, nbytes: float, flops: float, shapes) -> None:
    """Add one call of kernel ``name`` (``shapes``: its inputs') to every
    active counter."""
    for c in COUNTERS:
        c.kernel(name, nbytes, flops, shapes)


def distinct(t) -> int:
    """The number of distinct values of ``t``, read on the host where no
    active dispatch mode sees it (the counters count the step, not their
    own reads)."""
    import torch
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return int(torch.unique(t).numel())


def host_int(t) -> int:
    """``int(t)`` of a 0-dim tensor, unseen by the active modes."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return int(t)


def attended_pairs(sq: int, skv: int, causal: bool, window: int = 0) -> int:
    """Query-key pairs the mask keeps for ``sq`` queries end-aligned with
    ``skv`` keys: row ``i`` is ``r = i + skv - sq``, which sees the columns
    ``<= r`` when causal and ``> r - window`` with a window (0: none)."""
    r = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(skv, r + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, r - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def flash_work(bhq: int, sq: int, bhkv: int, skv: int, d: int, q_bytes: int,
               kv_bytes: int, causal: bool, window: int = 0
               ) -> tuple[float, float]:
    """(bytes, operations) of one flash call: q, k and v read once, the
    output (q's dtype) written once; ``4 d`` operations (``Q K^T`` and
    ``P V``) for each query-key pair that the mask keeps, per q head."""
    nbytes = 2 * bhq * sq * d * q_bytes + 2 * bhkv * skv * d * kv_bytes
    return float(nbytes), 4.0 * d * attended_pairs(sq, skv, causal,
                                                   window) * bhq


def decode_work(b: int, h: int, kvh: int, d: int, valid: int, q_bytes: int,
                kv_bytes: int, window: int = 0, lse: bool = False
                ) -> tuple[float, float]:
    """(bytes, operations) of one decode call: q read and the output written
    once (float32, and the ``[B, H]`` float32 log-sum-exp with it, on the
    ``lse`` route), the cache's attended positions of K and V read once
    (``valid``, or the window's last ``window`` of them)."""
    n = min(valid, window) if window else valid
    out = b * h * (4 * d + 4) if lse else b * h * d * q_bytes
    nbytes = b * h * d * q_bytes + out + 2 * b * n * kvh * d * kv_bytes
    return float(nbytes), 4.0 * d * b * h * n


def gmm_work(n: int, d: int, f: int, used_groups: int, x_bytes: int,
             w_bytes: int) -> tuple[float, float]:
    """(bytes, operations) of one gmm call: x read and the ``[n, f]``
    output (x's dtype) written once, the weights of each group that some
    tile uses read once; ``2 d`` operations an output element."""
    nbytes = (n * d + n * f) * x_bytes + used_groups * d * f * w_bytes
    return float(nbytes), 2.0 * n * d * f


def slstm_work(b: int, s: int, d: int, x_bytes: int) -> tuple[float, float]:
    """(bytes, operations) of one ``slstm_scan`` call: ``xw [B, S, 4d]``,
    ``w_rec [d, 4d]`` and ``b [4d]`` read once, the float32 state ``c, n,
    h, m`` read and written once, ``hs [B, S, d]`` float32 written once;
    the recurrent product's ``2 B S d 4d`` operations."""
    nbytes = (b * s * 4 * d + d * 4 * d + 4 * d) * x_bytes + 8 * b * d * 4 \
        + b * s * d * 4
    return float(nbytes), 2.0 * b * s * d * 4 * d
