"""The decode attention's log-sum-exp route on the CPU: the cache split into
blocks of ``T``, each block's output and log-sum-exp, and their merge.

A GQA layer whose heads do not divide ``model`` splits a decode step by
positions (``shardings.attention_split``: ``"positions"``): each ``model``
rank attends over its block of the cache's rows with
``decode_attention(..., return_lse=True)`` (the block's valid rows and
window from ``block_window``; a block with none gets zeros and ``-inf``
with no launch) and the blocks are merged by their log-sum-exps
(``merge_blocks``).  On a CPU tensor the wrapper takes the plain version,
so these tests pin the function both CUDA routes must compute: the plain
log-sum-exp against ``torch.logsumexp`` of the scaled scores, and ``m``
blocks merged against one whole plain decode and against the JAX
package's decode oracle (``repro.kernels.ref.decode_attention_ref``) on
the same numpy-made inputs, at float32 within ``MERGE_TOL`` (rtol 1e-6,
atol 1e-6: the outputs are of order one).  The cases cover blocks of 1 to
8 over the cache, ``valid_len`` 1, mid-cache and ``T``, blocks past
``valid_len``, and windows that start inside a block, at a block's edge or
before the cache.  Three planted faults must miss the bound by 10x: the
log-sum-exp in base 2, the merge as a plain mean of the blocks, and each
block given the layer's window.  The kernels are held to these plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref, work  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    block_window, decode_attention, merge_blocks)

MERGE_TOL = dict(rtol=1e-6, atol=1e-6)
CONTROL_FACTOR = 10
B, H, KVH, T, D = 3, 6, 3, 48, 16
# (valid_len, window, blocks): whole and ragged lengths, blocks past
# valid_len, windows starting inside a block (12 rows a block at 4), at a
# block's first row, and reaching before the cache
CASES = [(48, 0, 4), (48, 0, 1), (37, 0, 4), (1, 0, 4), (13, 0, 8),
         (48, 0, 2), (30, 0, 3), (37, 8, 4), (37, 13, 4), (25, 1, 4),
         (48, 12, 4), (48, 36, 4), (20, 64, 4), (44, 20, 8), (7, 5, 6)]


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, D), (B, T, KVH, D), (B, T, KVH, D)))
    return q, k, v


def _split(q, k, v, valid: int, window: int, n: int, *, bw=block_window,
           lse_scale: float = 1.0, merge=merge_blocks) -> torch.Tensor:
    """The decode of ``q`` over ``k, v``'s first ``valid`` rows cut into
    ``n`` blocks of ``T / n``: each block's plain output and log-sum-exp
    (through the wrapper on CPU tensors), merged."""
    rows = T // n
    outs, lses = [], []
    for i in range(n):
        kb, vb = (x[:, i * rows:(i + 1) * rows].contiguous() for x in (k, v))
        v_r, w_r = bw(valid, i * rows, rows, window)
        o, lse = decode_attention(q, kb, vb, v_r, window=w_r,
                                  return_lse=True)
        outs.append(o)
        lses.append(lse * lse_scale)
    return merge(torch.stack(outs), torch.stack(lses))


@pytest.mark.parametrize("valid,window,n", CASES)
def test_merged_blocks_equal_one_whole_decode(valid, window, n):
    """``n`` blocks merged by their log-sum-exps equal the whole plain
    decode, and the JAX package's oracle, within ``MERGE_TOL``."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(valid + 7 * n + window))
    whole = ops.decode_attention(q, k, v, valid, window=window,
                                 use_kernel=False)
    got = _split(q, k, v, valid, window, n)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **MERGE_TOL)
    if not window:
        oracle = np.asarray(jref.decode_attention_ref(
            *(x.numpy() for x in (q, k, v)), valid))
        np.testing.assert_allclose(got.numpy(), oracle, **MERGE_TOL)


@pytest.mark.parametrize("valid,window", [(48, 0), (37, 0), (1, 0),
                                          (37, 8), (48, 1)])
def test_plain_lse_is_the_log_sum_exp_of_the_scores(valid, window):
    """The plain version's ``lse [B, H]``: the natural log of the sum of
    ``exp(scale q.k)`` over the attended positions (float32; ``scale =
    d^-1/2``), its output the float32 one of ``return_lse=False``."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(valid + window))
    out, lse = ref.decode_attention_ref(q, k, v, valid, window=window,
                                        return_lse=True)
    lo = max(0, valid - window) if window else 0
    kg = k[:, lo:valid].repeat_interleave(H // KVH, dim=2)
    scores = torch.einsum("bhd,bthd->bht", q.double(), kg.double()) \
        / math.sqrt(D)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(scores, -1).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(out, ref.decode_attention_ref(
        q, k, v, valid, window=window), rtol=0, atol=0)


def test_empty_block_gives_zeros_and_minus_inf_without_a_launch():
    """``valid_len`` 0 on the log-sum-exp route (a block past the cache's
    length, or wholly left of the window): zeros and ``-inf``, with no
    launch and no work reported, on CPU and meta tensors alike; off that
    route 0 is refused."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(0))
    for dev in ("cpu", "meta"):
        args = [x.to(dev) for x in (q, k, v)]
        before = decode_attention.launches
        seen = []

        class Count:
            def kernel(self, *a):
                seen.append(a)
        work.COUNTERS.append(Count())
        try:
            o, lse = decode_attention(*args, 0, return_lse=True)
        finally:
            work.COUNTERS.pop()
        assert decode_attention.launches == before and not seen
        assert o.dtype == torch.float32 and o.shape == q.shape
        if dev == "cpu":
            assert bool((o == 0).all()) and bool(torch.isneginf(lse).all())
        with pytest.raises(ValueError, match="valid_len"):
            decode_attention(*args, 0)


def test_meta_branch_reports_the_lse_route():
    """On meta tensors the route returns float32 ``out`` and ``[B, H]``
    ``lse`` and reports ``work.decode_work(..., lse=True)``: the output
    written in float32 and the log-sum-exp beside it."""
    b, h, kvh, t, d = 4, 40, 8, 2048, 128
    q = torch.empty((b, h, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, t, kvh, d), dtype=torch.bfloat16, device="meta")
    seen = []

    class Count:
        def kernel(self, name, nbytes, flops, shapes):
            seen.append((name, nbytes, flops))
    work.COUNTERS.append(Count())
    try:
        o, lse = decode_attention(q, k, k, 1056, return_lse=True)
    finally:
        work.COUNTERS.pop()
    assert o.dtype == lse.dtype == torch.float32
    assert tuple(o.shape) == (b, h, d) and tuple(lse.shape) == (b, h)
    nbytes, flops = work.decode_work(b, h, kvh, d, 1056, 2, 2, lse=True)
    assert seen == [("decode_attention", nbytes, flops)]
    plain = work.decode_work(b, h, kvh, d, 1056, 2, 2)
    assert nbytes - plain[0] == b * h * (4 * d + 4 - 2 * d)


@pytest.mark.parametrize("valid,offset,rows,window,want", [
    (37, 0, 12, 0, (12, 0)), (37, 36, 12, 0, (1, 0)), (37, 48, 12, 0, (0, 0)),
    (37, 24, 12, 8, (12, 7)), (37, 12, 12, 8, (0, 0)),
    (37, 24, 12, 13, (12, 0)), (37, 24, 12, 14, (12, 0)),
    (37, 36, 12, 8, (1, 0)), (40, 24, 12, 8, (12, 4)),
    (44, 36, 12, 5, (8, 5))])
def test_block_window_rule(valid, offset, rows, window, want):
    """A block's valid rows ``clamp(valid - offset, 0, rows)`` and its
    window ``v_r - start``, ``start = max(0, valid - window - offset)``
    (0 where the window reaches back to the block's first row or before);
    a block wholly past ``valid`` or left of the window has none."""
    assert block_window(valid, offset, rows, window) == want


def _miss(got, want) -> float:
    tol = MERGE_TOL["atol"] + MERGE_TOL["rtol"] * np.abs(want)
    return float((np.abs(got - want) / tol).max())


@pytest.mark.parametrize("fault", ["base_2_lse", "plain_mean",
                                   "layer_window"])
def test_planted_faults_miss_the_merge_bound(fault):
    """Each fault misses ``MERGE_TOL`` by 10x where the merge meets it: the
    blocks' log-sum-exps in base 2 (``lse / ln 2``), the merge as a plain
    mean of the blocks' outputs, and every block given the layer's window
    (a window starting inside a block)."""
    valid, window, n = (37, 8, 4) if fault == "layer_window" else (37, 0, 4)
    q, k, v = (torch.from_numpy(x) for x in _inputs(91))
    whole = ops.decode_attention(q, k, v, valid, window=window,
                                 use_kernel=False).numpy()
    kw = {"base_2_lse": dict(lse_scale=1 / math.log(2)),
          "plain_mean": dict(merge=lambda outs, lses: outs.mean(0)),
          "layer_window": dict(bw=lambda valid_, offset, rows, w: (
              min(max(valid_ - offset, 0), rows), w))}[fault]
    assert _miss(_split(q, k, v, valid, window, n).numpy(), whole) <= 1.0
    miss = _miss(_split(q, k, v, valid, window, n, **kw).numpy(), whole)
    assert miss >= CONTROL_FACTOR, (fault, miss)
