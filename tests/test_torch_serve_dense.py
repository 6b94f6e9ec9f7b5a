"""The dense models' serving paths on the CPU that ``test_torch_lm.py``
does not take, held against the JAX package, and the prefill control of
``chip_smoke.py``'s dense serve phases.

* Pixtral-12B and MusicGen-large from the reference's input: the
  reference's stub frontend weights carried into the port, the frontend's
  embeddings prefilled into a fresh cache (``lm.forward(embeds=...)``),
  then greedy ``serve_step`` s from tokens, as the card's embeds runs do;
  against ``jfront`` -> ``jlm.forward(embeds=..., cache=...)`` ->
  ``jlm.serve_step`` on the same numpy inputs.
* MQA at ``decode_tma``'s largest group, 48 q heads over one kv head
  (Granite-34B's SMOKE config with 48 heads of 16, on both sides): a
  prefill into a cache and a decode step.
* The prefill control (the plain flash with its causal diagonal one
  column late, written here as ``chip_smoke.py`` writes it): the mirror
  is the plain flash but its diagonal, and at SMOKE it moves every dense
  model's prefill logits past ``LOGIT_TOL_STEPS`` bf16 steps, so a control
  that cannot fail shows here before the card.

Tolerances are ``test_torch_lm.py``'s: float32 SMOKE models through a
bfloat16 cache, logits within rtol / atol 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.models import frontends as jfront
from repro.models import lm as jlm

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import frontends, lm  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        lm_params_from_reference, to_tensor)

DENSE = ["qwen2.5-14b", "granite-34b", "llama3-405b", "qwen1.5-110b",
         "pixtral-12b", "musicgen-large"]
CACHED = dict(rtol=2e-3, atol=2e-3)
# chip_smoke.py's logit check: every step within this many bf16 steps at
# the largest logit of the plain run's
LOGIT_TOL_STEPS = 10


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _models(rcfg, pcfg, seed: int):
    """The reference's ``init_lm`` weights with every norm and bias
    jittered from numpy, and the port's model carried from them."""
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), rcfg))
    rng = np.random.default_rng(seed)
    blocks = params["blocks"]
    for name in ("ln1", "ln2"):
        blocks[name] = (1 + 0.1 * rng.standard_normal(blocks[name].shape)
                        ).astype(blocks[name].dtype)
    for name in ("bq", "bk", "bv"):
        if name in blocks["attn"]:
            a = blocks["attn"][name]
            blocks["attn"][name] = (0.1 * rng.standard_normal(a.shape)
                                    ).astype(a.dtype)
    return params, lm_params_from_reference(pcfg, params, device="cpu")


# ---------------------------------------------------------------------------
# Pixtral and MusicGen from their frontends' embeddings
# ---------------------------------------------------------------------------

def _embeds(rcfg, rng, b: int, s: int):
    """``(reference embeddings, the port's)`` of one batch through the
    reference's stub frontend and the port's carrying its weights."""
    if rcfg.modality == "vlm":
        jf = jfront.init_patch_frontend(jax.random.key(5), rcfg, 48)
        pf = {"proj": to_tensor(jf["proj"], "cpu")}
        x = rng.standard_normal((b, s, 48)).astype(np.float32)
        return (jfront.patch_embed(jf, jnp.asarray(x)),
                frontends.patch_embed(pf, torch.from_numpy(x)))
    jf = jfront.init_frame_frontend(jax.random.key(5), rcfg, 4)
    pf = {"tables": [to_tensor(t, "cpu") for t in jf["tables"]]}
    codes = rng.integers(0, rcfg.vocab, (b, s, 4)).astype(np.int32)
    return (jfront.frame_embed(jf, jnp.asarray(codes)),
            frontends.frame_embed(pf, torch.from_numpy(codes)))


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large"])
def test_embeds_prefill_then_token_steps_match_reference(arch):
    """The frontend, the prefill from its embeddings into a cache, then 4
    greedy steps from tokens: the same tokens, every step's logits within
    ``CACHED``."""
    rcfg, pcfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params, model = _models(rcfg, pcfg, seed=11)
    b, s, max_len = 2, 9, 32
    jemb, pemb = _embeds(rcfg, np.random.default_rng(12), b, s)
    np.testing.assert_allclose(_np(pemb), _np(jemb), rtol=1e-6, atol=1e-6)
    jcache = jlm.init_cache(rcfg, b, max_len)
    pcache = lm.init_cache(pcfg, b, max_len, device="cpu")
    want, jcache, _ = jlm.forward(params, rcfg, embeds=jemb, cache=jcache)
    got, pcache, _ = lm.forward(model, embeds=pemb, cache=pcache)
    np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    for _ in range(4):
        jtok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        ptok = got[:, -1].argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(ptok, jtok)
        want, jcache = jlm.serve_step(params, rcfg, jcache,
                                      tokens=jnp.asarray(jtok[:, None]))
        got, pcache = lm.serve_step(model, pcache,
                                    tokens=torch.from_numpy(ptok[:, None]))
        assert got.shape == (b, 1, rcfg.vocab)
        np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    assert pcache["pos"] == int(jcache["pos"]) == s + 4


# ---------------------------------------------------------------------------
# MQA at a group of 48
# ---------------------------------------------------------------------------

def test_mqa_at_group_48_prefill_and_decode_match_reference():
    """Granite-34B's SMOKE config with 48 q heads of 16 over its one kv head
    on both sides: a prefill into a cache and a decode step, logits and the
    cache's rows against the reference's."""
    changes = dict(n_heads=48, n_kv_heads=1, d_head=16)
    rcfg = dataclasses.replace(ref_config("granite-34b", smoke=True),
                               **changes)
    pcfg = dataclasses.replace(get_config("granite-34b", smoke=True),
                               **changes)
    params, model = _models(rcfg, pcfg, seed=13)
    assert model.blocks[0].attn.wq.shape == (pcfg.d_model, 48 * 16)
    b, s, max_len = 2, 11, 16
    toks = np.random.default_rng(14).integers(0, rcfg.vocab, (b, s + 1)
                                              ).astype(np.int32)
    jcache = jlm.init_cache(rcfg, b, max_len)
    pcache = lm.init_cache(pcfg, b, max_len, device="cpu")
    want, jcache, _ = jlm.forward(params, rcfg,
                                  tokens=jnp.asarray(toks[:, :s]),
                                  cache=jcache)
    got, pcache, _ = lm.forward(model, tokens=torch.from_numpy(toks[:, :s]),
                                cache=pcache)
    np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    want, jcache = jlm.serve_step(params, rcfg, jcache,
                                  tokens=jnp.asarray(toks[:, s:]))
    got, pcache = lm.serve_step(model, pcache,
                                tokens=torch.from_numpy(toks[:, s:]))
    np.testing.assert_allclose(_np(got), _np(want), **CACHED)
    theirs = cache_from_reference(pcfg, jcache, device="cpu")
    for mine, them in zip(pcache["layers"], theirs["layers"]):
        assert mine["k"].shape == (b, max_len, 1, 16)
        assert mine["len"] == them["len"] == s + 1
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(mine[name]), _np(them[name]),
                                       rtol=2 ** -7, atol=2 ** -7)


# ---------------------------------------------------------------------------
# the prefill control
# ---------------------------------------------------------------------------

def late_diagonal_flash(q, k, v, *, causal=True, scale=None, window=0,
                        late: int = 1):
    """``chip_smoke._late_diagonal_flash``: the plain flash whose causal
    diagonal is ``late`` columns late, row ``r`` (end-aligned) attending
    ``c <= r + late`` (and ``r - c < window``); float32 math in the plain
    flash's blocks of query rows."""
    bhq, sq, d = q.shape
    skv = k.shape[1]
    g = bhq // k.shape[0]
    k, v = (x.repeat_interleave(g, dim=0).float() for x in (k, v))
    block = max(1, min(sq, ref.FLASH_REF_LOGITS // (bhq * skv)))
    cols = torch.arange(skv)[None]
    out = []
    for i0 in range(0, sq, block):
        qb = q[:, i0:i0 + block]
        s = torch.einsum("bqd,bkd->bqk", qb.float(), k) * (scale or d ** -0.5)
        rows = torch.arange(i0, i0 + qb.shape[1])[:, None] + (skv - sq)
        mask = cols <= rows + late
        if window:
            mask &= rows - cols < window
        p = torch.softmax(torch.where(mask[None], s, ref.MASKED), dim=-1)
        out.append(torch.einsum("bqk,bkd->bqd", p, v).to(q.dtype))
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("window", [0, 4])
def test_late_diagonal_is_the_plain_flash_but_its_diagonal(window):
    """Not late, the mirror is the plain flash; one column late, each
    end-aligned row ``r`` is the plain flash's one row over the keys up to
    ``r + 1`` (its window one wider), and the last row is unchanged."""
    g = torch.Generator().manual_seed(15)
    q = torch.randn((6, 5, 16), generator=g)
    k, v = (torch.randn((2, 9, 16), generator=g) for _ in range(2))
    torch.testing.assert_close(
        late_diagonal_flash(q, k, v, window=window, late=0),
        ref.flash_attention_ref(q, k, v, window=window), rtol=1e-6, atol=1e-6)
    got = late_diagonal_flash(q, k, v, window=window)
    for i in range(4):                  # the rows with a key after them
        r = i + 9 - 5
        want = ref.flash_attention_ref(q[:, i:i + 1], k[:, :r + 2],
                                       v[:, :r + 2],
                                       window=window + 1 if window else 0)
        torch.testing.assert_close(got[:, i:i + 1], want, rtol=1e-6,
                                   atol=1e-6)
    torch.testing.assert_close(got[:, -1], ref.flash_attention_ref(
        q, k, v, window=window)[:, -1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_control_misses_the_logit_bound(arch):
    """The served SMOKE model, plain, against the same run with the plain
    flash replaced by the late diagonal (teacher-forced on its tokens): the
    prefill's last-position logits move past ``LOGIT_TOL_STEPS`` bf16 steps
    at the largest logit, as the card's dense serve phases require at step
    0 (the decode steps are the decode control's)."""
    cfg = get_config(arch, smoke=True)
    kw = dict(batch=2, prompt_len=16, gen_len=2, max_len=32, device="cpu",
              params=lm.init_lm(cfg, seed=0, device="cpu"))
    gen, plain = serve(arch, use_kernel=False, **kw)
    saved = ref.flash_attention_ref
    ref.flash_attention_ref = late_diagonal_flash
    try:
        _, control = serve(arch, use_kernel=False, forced=gen, **kw)
    finally:
        ref.flash_attention_ref = saved
    top = float(plain.logits[0].abs().max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    diff = float((control.logits[0] - plain.logits[0]).abs().max())
    assert diff > LOGIT_TOL_STEPS * step, (diff, step)
