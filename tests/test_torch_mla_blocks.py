"""MLA's latent cache split over ``model`` by ``T``, on the CPU.

Under a mesh whose ``model`` axis splits MLA's heads, each rank's cache
holds the latent and rope key of its block of ``T``
(``shardings.local_cache_rows``).  A decode step attends every head over
the valid rows of each block (``layers.mla_block_decode``: the float32
context and the log-sum-exp of the block; zeros and ``-inf`` for a block
with no valid row), and the blocks merge by their log-sum-exps.  Here the
blocks of one whole cache are merged (``merge_blocks``) and held to one
whole ``layers.mla_absorbed_decode`` within float32 rounding (rtol 1e-6
of the output's largest element), at DeepSeek-V2's SMOKE width, for
``m`` 2, 4 and 16, with blocks past the cache's length, and on a cache
prefilled in two chunks whose second crosses a block; the chunks are
written through ``layers._block_slots`` into each block as the layer
writes them.  A plain mean of the blocks must miss by 10x.  The split
itself, on gloo ranks against the reference, is ``test_torch_tp.py``'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import (block_window,  # noqa: E402
                                                  merge_blocks)
from repro_torch.models import layers  # noqa: E402

RTOL = 1e-6
CONTROL_FACTOR = 10
B, T = 2, 48


def _module():
    cfg = get_config("deepseek-v2-236b", smoke=True)
    gen = torch.Generator().manual_seed(3)
    return layers.MLA(cfg, device="cpu", gen=gen)


def _inputs(mod, seed: int):
    """``q_nope [B, 1, h, dn]``, ``q_rope [B, 1, h, dr]`` float32 and a
    bf16 cache's ``latent [B, T, r]`` and ``k_rope [B, T, dr]``, from
    numpy."""
    m, h = mod.cfg.mla, mod.cfg.n_heads
    rng = np.random.default_rng(seed)

    def rand(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return (rand(B, 1, h, m.nope_head_dim), rand(B, 1, h, m.rope_head_dim),
            rand(B, T, m.kv_lora_rank, dtype=torch.bfloat16),
            rand(B, T, m.rope_head_dim, dtype=torch.bfloat16))


def _blocks(mod, q_nope, q_rope, latent, k_rope, valid: int, m: int,
            merge=merge_blocks):
    """``[B, 1, h dv]``: the decode over ``m`` blocks of ``T / m`` rows,
    each through ``mla_block_decode`` over its valid rows, merged, then
    ``wv_abs``."""
    a = mod.cfg.mla
    wk_abs, wv_abs = layers._absorbed(mod)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk_abs)
    n = latent.shape[1] // m
    ctxs, lses = [], []
    for i in range(m):
        rows, _ = block_window(valid, i * n, n)
        ctx, lse = layers.mla_block_decode(
            q_lat, q_rope[:, 0], latent[:, i * n:i * n + rows],
            k_rope[:, i * n:i * n + rows], scale=layers._mla_scale(a))
        ctxs.append(ctx)
        lses.append(lse)
    ctx = merge(torch.stack(ctxs), torch.stack(lses))
    return torch.einsum("bhr,rhd->bhd", ctx, wv_abs).reshape(
        q_nope.shape[0], 1, -1)


def _miss(got, want) -> float:
    return float((got - want).abs().max()
                 / (RTOL * want.abs().max()))


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("valid", [1, 13, 21, 48])
def test_merged_blocks_equal_the_whole_absorbed_decode(m, valid):
    """``m`` blocks of a 48-position cache, ``valid`` of them valid (1:
    every block but the first past the length; 13 and 21: a block in part;
    48: all), merged by their log-sum-exps: the whole absorbed decode's
    output within rtol 1e-6 of its largest element; an empty block gives
    zeros and ``-inf``."""
    mod = _module()
    q_nope, q_rope, latent, k_rope = _inputs(mod, 10 + valid)
    with torch.no_grad():
        want = layers.mla_absorbed_decode(mod, q_nope, q_rope, latent,
                                          k_rope, valid_len=valid)
        got = _blocks(mod, q_nope, q_rope, latent, k_rope, valid, m)
        ctx, lse = layers.mla_block_decode(
            q_nope[:, 0], q_rope[:, 0], latent[:, :0], k_rope[:, :0],
            scale=1.0)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _miss(got, want) <= 1.0
    assert bool((ctx == 0).all()) and bool(torch.isneginf(lse).all())


@pytest.mark.parametrize("m", [2, 4])
def test_two_chunks_written_into_blocks_decode_as_one_cache(m):
    """A prompt of 20 positions prefilled in two chunks (7, then 13, which
    crosses a block of 24 / 12 rows) and one decode row, each written into
    the ``m`` blocks through ``layers._block_slots`` as ``MLA.forward``
    writes them: the blocks side by side are the whole cache's rows (zeros
    past them), a write past the cache's end raises, and the decode over
    the blocks is the whole one's within rtol 1e-6."""
    mod = _module()
    q_nope, q_rope, latent, k_rope = _inputs(mod, 7)
    n = T // m
    caches = [{"latent": torch.zeros((B, n, latent.shape[2]),
                                     dtype=torch.bfloat16),
               "k_rope": torch.zeros((B, n, k_rope.shape[2]),
                                     dtype=torch.bfloat16),
               "len": 0, "t0": i * n} for i in range(m)]
    for lo, hi in ((0, 7), (7, 20), (20, 21)):
        for c in caches:
            rows, slots = layers._block_slots(c, n, hi - lo, m)
            c["latent"][:, slots] = latent[:, lo:hi][:, rows]
            c["k_rope"][:, slots] = k_rope[:, lo:hi][:, rows]
            c["len"] = hi
    for k, whole in (("latent", latent), ("k_rope", k_rope)):
        side = torch.cat([c[k] for c in caches], dim=1)
        assert torch.equal(side[:, :21], whole[:, :21])
        assert not bool(side[:, 21:].any())
    with pytest.raises(ValueError, match="KV cache full"):
        layers._block_slots(caches[0], n, T - 20, m)
    side = [torch.cat([c[k] for c in caches], dim=1)
            for k in ("latent", "k_rope")]
    with torch.no_grad():
        want = layers.mla_absorbed_decode(mod, q_nope, q_rope, *side,
                                          valid_len=21)
        got = _blocks(mod, q_nope, q_rope, *side, 21, m)
    assert _miss(got, want) <= 1.0


def test_blocks_merged_as_a_mean_miss():
    """The control: the blocks' contexts merged by a plain mean (the
    planted fault ``mla_merge_mean`` of ``tp_ranks``) miss the whole decode
    by 10x its bound."""
    mod = _module()
    q_nope, q_rope, latent, k_rope = _inputs(mod, 5)
    with torch.no_grad():
        want = layers.mla_absorbed_decode(mod, q_nope, q_rope, latent,
                                          k_rope, valid_len=30)
        got = _blocks(mod, q_nope, q_rope, latent, k_rope, 30, 4,
                      merge=lambda ctx, lse: ctx.mean(0))
    assert _miss(got, want) >= CONTROL_FACTOR
