"""Step builders of the port: train, prefill and serve, on one device or
over a mesh of ranks.

Counterpart of ``repro.launch.steps`` but for its sharded cells: the
recipes (per-architecture execution knobs), ``clamp_n_micro``,
``make_train_step`` (microbatch gradients, then one AdamW update) and thin
prefill / serve steps.  A step takes the model (the port's parameters live
in it) where the reference's takes a params pytree.  Each builder takes the
mesh, whose EP axes are ``ep_axes_for(mesh)``, where the reference's takes
``ep`` under an ambient mesh.

Under a mesh a train step is per-rank SPMD code on this rank's rows of the
batch (:func:`repro_torch.data.pipeline.rank_rows`: microbatch by
microbatch, as the reference's ``microbatch_grads`` reshapes the global
batch before ``shard_map`` shards each microbatch).  ``lm.train_loss``
gives each rank its share of the global loss, the dispatch's collectives
carry their adjoints, and the microbatches' gradients, accumulated on the
rank, are summed once a step over the axes each leaf is replicated on
(:func:`sum_grads`): a routed-expert slice over the axes outside the EP
axes, every other leaf over the whole mesh.  That is the gradient of the
reference's global loss under ``shard_map`` (whose transpose divides an
output's cotangent over the axes it is not split on and sums an input's
over the axes it is replicated on).  The reported loss is the global one.
The reference's ``build_cell`` and ``input_specs`` wait for the port's
DTensor placements.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import meshops
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import AdamWConfig, adamw_update, microbatch_grads

from .shardings import ep_axes_for

# the most bytes :func:`sum_grads` packs into one buffer; a larger leaf is
# summed alone
BUCKET_BYTES = 1 << 30


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


def clamp_n_micro(recipe: Recipe, shape: ShapeConfig, mesh) -> Recipe:
    """Keep microbatches shardable: ``global_batch / n_micro`` must divide
    by the batch shards (``("pod", "data")``), else the reference's batch
    spec drops its sharding and every chip replays the whole microbatch.
    The reference's arithmetic, unchanged."""
    shards = 1
    for a in ("pod", "data"):
        shards *= mesh.shape.get(a, 1)
    n = max(1, min(recipe.n_micro, shape.global_batch // shards))
    while n > 1 and (shape.global_batch % n or
                     (shape.global_batch // n) % shards):
        n -= 1
    if n != recipe.n_micro:
        recipe = dataclasses.replace(recipe, n_micro=n)
    return recipe


def _with_recipe(cfg: ModelConfig, recipe: Recipe) -> ModelConfig:
    changes: dict = {}
    if recipe.remat is not None and recipe.remat != cfg.remat:
        changes["remat"] = recipe.remat
    if recipe.dispatch and cfg.moe is not None and \
            recipe.dispatch != cfg.moe.dispatch:
        changes["moe"] = dataclasses.replace(cfg.moe, dispatch=recipe.dispatch)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def split_leaves(cfg: ModelConfig, names, mesh) -> dict:
    """``{name: EP axes}`` of the leaves that are this rank's slice under
    ``mesh``: a MoE block's routed experts, when the model dispatches over
    the mesh's EP axes (``teshu`` / ``teshu2``); empty without a mesh."""
    if mesh is None or cfg.moe is None or cfg.moe.dispatch == "gspmd":
        return {}
    ep = ep_axes_for(mesh)
    return {n: ep for n in names if ".moe.experts." in n} if ep else {}


def sum_plan(grads: dict, mesh, split: dict) -> list[tuple[tuple, list]]:
    """The gradient sums of one step: ``[(axes, [names])]``, one
    all-reduce each.  A leaf is summed over the axes it is replicated on
    (a split leaf over the mesh's axes outside its own, every other leaf
    over all of them); leaves of one dtype and axis set are packed into
    buffers of at most :data:`BUCKET_BYTES`, in the dict's order, and a
    larger leaf goes alone."""
    groups: dict = {}
    for n, g in grads.items():
        axes = tuple(a for a in mesh.axis_names if a not in split.get(n, ()))
        if axes:
            groups.setdefault((g.dtype, axes), []).append(n)
    plan = []
    for (_, axes), names in groups.items():
        bucket, size = [], 0
        for n in names:
            nbytes = grads[n].numel() * grads[n].element_size()
            if bucket and size + nbytes > BUCKET_BYTES:
                plan.append((axes, bucket))
                bucket, size = [], 0
            bucket.append(n)
            size += nbytes
        if bucket:
            plan.append((axes, bucket))
    return plan


@torch.no_grad()
def sum_grads(grads: dict, mesh, split: dict) -> dict:
    """Each gradient summed over the axes its leaf is replicated on
    (:func:`sum_plan`), in place of the dict's entries: a lone leaf
    through ``meshops.flat_psum``, a bucket packed into one flat buffer
    and unpacked."""
    for axes, names in sum_plan(grads, mesh, split):
        if len(names) == 1:
            grads[names[0]] = meshops.flat_psum(grads[names[0]], mesh, axes)
            continue
        flat = meshops.flat_psum(torch.cat([grads[n].reshape(-1)
                                            for n in names]), mesh, axes)
        start = 0
        for n in names:
            g = grads[n]
            grads[n] = flat[start:start + g.numel()].view(g.shape)
            start += g.numel()
    return grads


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    recipe: Recipe, *, mesh=None) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the mean loss and gradients of ``lm.train_loss`` over
    ``recipe.n_micro`` microbatches (accumulated in
    ``recipe.accum_dtype``), then one :func:`adamw_update` of the model's
    parameters and ``opt_state`` in place; ``metrics`` holds the float32
    ``loss``, ``grad_norm`` and ``lr`` tensors.  The model's parameters
    must require grad.

    Under ``mesh`` the batch is this rank's rows, microbatch-major
    (``rank_rows``), the gradients are summed over the mesh once
    (:func:`sum_grads`) before the update, and ``loss`` and ``grad_norm``
    are the reference's global ones, the same on every rank."""
    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, grads = microbatch_grads(
            lambda p, b: lm.train_loss(model, b, mesh=mesh),
            params, batch, recipe.n_micro, accum_dtype=recipe.accum_dtype)
        split = split_leaves(cfg, params, mesh)
        if mesh is not None:
            grads = sum_grads(grads, mesh, split)
            loss = meshops.flat_psum(loss, mesh, mesh.axis_names)
        _, opt_state, metrics = adamw_update(ocfg, params, grads, opt_state,
                                             mesh=mesh, split=split)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *,
                      mesh=None) -> Callable:
    """``prefill_step(model, batch) -> (last logits [B, 1, V], cache)``
    into a fresh cache of ``shape.seq_len`` positions for the batch's rows
    (under ``mesh``, this rank's)."""
    @torch.no_grad()
    def prefill_step(model, batch):
        x = batch.get("tokens", batch.get("embeds"))
        cache = lm.init_cache(cfg, x.shape[0], shape.seq_len,
                              device=x.device)
        logits, cache, _ = lm.forward(model, tokens=batch.get("tokens"),
                                      embeds=batch.get("embeds"), cache=cache,
                                      mesh=mesh)
        return logits[:, -1:], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None) -> Callable:
    """``serve_step(model, cache, batch) -> (logits [B, 1, V], cache)``,
    one token per sequence, the cache updated in place (under ``mesh``,
    this rank's rows)."""
    @torch.no_grad()
    def serve_step(model, cache, batch):
        return lm.serve_step(model, cache, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), mesh=mesh)

    return serve_step
