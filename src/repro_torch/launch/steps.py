"""Step builders of the port: train, prefill and serve, on one device.

Counterpart of the mesh-free part of ``repro.launch.steps``: the recipes
(per-architecture execution knobs), ``make_train_step`` (microbatch
gradients, then one AdamW update) and thin prefill / serve steps.  A step
takes the model (the port's parameters live in it) where the reference's
takes a params pytree.  The reference's ``build_cell``, ``input_specs``
and ``clamp_n_micro`` shard over a mesh and wait for the port's DTensor
placements; training under a mesh is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import AdamWConfig, adamw_update, microbatch_grads


@dataclasses.dataclass(frozen=True)
class Recipe:
    n_micro: int = 1
    moment_dtype: str = "float32"
    accum_dtype: str = "float32"
    factored_v: bool = False           # Adafactor-style second moment
    remat: bool | None = None          # None = keep cfg.remat
    dispatch: str | None = None        # override cfg.moe.dispatch
    lr: float = 3e-4


# The reference's memory-driven defaults for the big configs (sized for its
# TPU pods; kept as they are, so that a recipe reads the same in both)
_TRAIN_RECIPES: dict[str, Recipe] = {
    "llama3-405b": Recipe(n_micro=16, moment_dtype="bfloat16",
                          accum_dtype="bfloat16"),
    "qwen1.5-110b": Recipe(n_micro=8, moment_dtype="bfloat16"),
    "deepseek-v2-236b": Recipe(n_micro=8, moment_dtype="bfloat16",
                               accum_dtype="bfloat16"),
    "qwen3-moe-235b-a22b": Recipe(n_micro=8, moment_dtype="bfloat16",
                                  accum_dtype="bfloat16"),
    "granite-34b": Recipe(n_micro=4),
    "qwen2.5-14b": Recipe(n_micro=2),
    "pixtral-12b": Recipe(n_micro=2),
    "musicgen-large": Recipe(n_micro=2),
    "hymba-1.5b": Recipe(n_micro=16),
    "xlstm-350m": Recipe(n_micro=8),
}


def recipe_for(arch: str, shape: ShapeConfig) -> Recipe:
    if shape.kind == "train":
        return _TRAIN_RECIPES.get(arch, Recipe())
    return Recipe()


def _with_recipe(cfg: ModelConfig, recipe: Recipe) -> ModelConfig:
    changes: dict = {}
    if recipe.remat is not None and recipe.remat != cfg.remat:
        changes["remat"] = recipe.remat
    if recipe.dispatch and cfg.moe is not None and \
            recipe.dispatch != cfg.moe.dispatch:
        changes["moe"] = dataclasses.replace(cfg.moe, dispatch=recipe.dispatch)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    recipe: Recipe) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the mean loss and gradients of ``lm.train_loss`` over
    ``recipe.n_micro`` microbatches (accumulated in
    ``recipe.accum_dtype``), then one :func:`adamw_update` of the model's
    parameters and ``opt_state`` in place; ``metrics`` holds the float32
    ``loss``, ``grad_norm`` and ``lr`` tensors.  The model's parameters
    must require grad."""
    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, grads = microbatch_grads(lambda p, b: lm.train_loss(model, b),
                                       params, batch, recipe.n_micro,
                                       accum_dtype=recipe.accum_dtype)
        _, opt_state, metrics = adamw_update(ocfg, params, grads, opt_state)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig) -> Callable:
    """``prefill_step(model, batch) -> (last logits [B, 1, V], cache)``
    into a fresh cache of ``shape.seq_len`` positions."""
    @torch.no_grad()
    def prefill_step(model, batch):
        x = batch.get("tokens", batch.get("embeds"))
        cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                              device=x.device)
        logits, cache, _ = lm.forward(model, tokens=batch.get("tokens"),
                                      embeds=batch.get("embeds"), cache=cache)
        return logits[:, -1:], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(model, cache, batch) -> (logits [B, 1, V], cache)``,
    one token per sequence, the cache updated in place."""
    @torch.no_grad()
    def serve_step(model, cache, batch):
        return lm.serve_step(model, cache, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"))

    return serve_step
