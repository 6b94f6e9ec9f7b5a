"""Modality frontends: stubs, as in the reference.

Counterpart of ``repro.models.frontends``.  The vlm (pixtral-12b) and audio
(musicgen-large) configs specify the transformer backbone only and take
precomputed patch or frame embeddings (``lm.forward(embeds=...)``).  These
helpers make such embeddings from raw-ish inputs with realistic shapes, and
write the embedding contract (``[B, S, d_model]`` in the model's dtype)
down in one place.  Weights are drawn from a ``torch.Generator`` (in
place of the reference's key) with the reference's distributions; nothing
in the training or serving path calls them.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_device

from .config import ModelConfig
from .layers import dense_init, dtype_of, normal_init


def init_patch_frontend(gen: torch.Generator, cfg: ModelConfig,
                        patch_dim: int = 768) -> dict:
    """ViT-patch stub: one linear projection ``patch_dim -> d_model``, on
    ``gen``'s device."""
    dev = check_device(gen.device)
    return {"proj": dense_init(gen, patch_dim, cfg.d_model, dtype_of(cfg),
                               dev)}


def patch_embed(p: dict, patches: torch.Tensor) -> torch.Tensor:
    """patches: ``[B, S, patch_dim]`` (pre-extracted, e.g. 16x16x3
    flattened)."""
    return patches @ p["proj"]


def init_frame_frontend(gen: torch.Generator, cfg: ModelConfig,
                        codebooks: int = 4) -> dict:
    """EnCodec-frame stub: one embedding table per codebook (normal, 0.02),
    summed, on ``gen``'s device; the delay pattern and the acoustic
    tokenizer are out of scope."""
    dev = check_device(gen.device)
    return {"tables": [normal_init((cfg.vocab, cfg.d_model), 0.02,
                                   dtype_of(cfg), dev, gen)
                       for _ in range(codebooks)]}


def frame_embed(p: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes: ``[B, S, codebooks]`` int -> ``[B, S, d_model]``, the
    tables' rows added in codebook order."""
    out = 0
    for i, table in enumerate(p["tables"]):
        out = out + table[codes[..., i].long()]
    return out
