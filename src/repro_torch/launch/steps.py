"""Step builders of the port: train, prefill and serve, on one device or
over a mesh of ranks, and the cells that stand in for their inputs.

Counterpart of ``repro.launch.steps``: the recipes (per-architecture
execution knobs), ``clamp_n_micro``, ``make_train_step`` (microbatch
gradients, then one AdamW update), thin prefill / serve steps, and
:func:`build_cell` / :func:`input_specs`, the step of one (architecture x
input shape x mesh) cell with stand-ins for its arguments.  A step takes
the model (the port's parameters live in it) where the reference's takes a
params pytree.  Each of them takes the mesh, whose EP axes are
``ep_axes_for(mesh)``, where the reference's takes ``ep`` under an ambient
mesh.

Under a mesh the model's parameters are placed by their specs
(``launch.shardings``), and a train step is per-rank SPMD code on this
rank's rows of the batch (:func:`repro_torch.data.pipeline.rank_rows`:
microbatch by microbatch, as the reference's ``microbatch_grads`` reshapes
the global batch before ``shard_map`` shards each microbatch).  ``lm.train_loss``
gives each rank its share of the global loss, the dispatch's collectives
carry their adjoints, and the microbatches' gradients, accumulated on the
rank, are summed once a step over the axes each leaf is replicated on
(:func:`sum_grads`: the mesh's axes its spec does not name; the axes it
names were summed by its gather's reduce-scatter, or for a routed expert's
EP axes by the dispatch's exchanges).  That is the gradient of the
reference's global loss under ``shard_map`` (whose transpose divides an
output's cotangent over the axes it is not split on and sums an input's
over the axes it is replicated on).  The reported loss is the global one.

A :class:`Cell`'s arguments are stand-ins on the meta device: an ``LM``
placed under the mesh (its leaves the rank's shards), and ``DTensor``
stand-ins over meta tensors for the optimizer state, the batch and the
cache.  The reference's ``Cell.jitted()`` and ``lower()`` have no
counterpart here: the dry run runs a cell's step on its stand-ins under a
fake process group and a dispatch mode that counts what each operation
would do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import get_config
from repro_torch.core import meshops
from repro_torch.models import lm
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               microbatch_grads)

from .shardings import (batch_specs, cache_specs, opt_v_specs, param_specs,
                        split_leaves, with_shardings)

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


def sum_plan(grads: dict, mesh, split: dict) -> list[tuple[tuple, list]]:
    """The gradient sums of one step: ``[(axes, [names])]``, one
    all-reduce each.  A leaf is summed over the axes it is replicated on:
    the mesh's axes outside those ``split`` (:func:`split_leaves`) gives
    it, all of them for a leaf it does not name; leaves of one dtype and
    axis set are packed into buffers of at most :data:`BUCKET_BYTES`, in
    the dict's order, and a larger leaf goes alone."""
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
    (``rank_rows``), the model is placed on the mesh, the gradients are
    summed over the mesh once (:func:`sum_grads`) before the update, and
    ``loss`` and ``grad_norm`` are the reference's global ones, the same on
    every rank."""
    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, grads = microbatch_grads(
            lambda p, b: lm.train_loss(model, b, mesh=mesh),
            params, batch, recipe.n_micro, accum_dtype=recipe.accum_dtype)
        if mesh is not None:
            grads = sum_grads(grads, mesh, split_leaves(model.specs, mesh))
            loss = meshops.flat_psum(loss, mesh, mesh.axis_names)
        _, opt_state, metrics = adamw_update(ocfg, params, grads, opt_state,
                                             mesh=mesh, specs=model.specs)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *,
                      mesh=None, use_kernel: bool = True) -> Callable:
    """``prefill_step(model, batch) -> (last logits [B, 1, V], cache)``
    into a fresh cache of ``shape.seq_len`` positions for the batch's rows
    (under ``mesh``, this rank's, and its kv heads or its block of ``T``,
    ``lm.init_cache``; only the last
    position's logits gathered over ``model``); ``use_kernel=False`` takes
    the kernels' plain versions (the route the reference's dry run
    lowers)."""
    @torch.no_grad()
    def prefill_step(model, batch):
        x = batch.get("tokens", batch.get("embeds"))
        cache = lm.init_cache(cfg, x.shape[0], shape.seq_len,
                              device=x.device, mesh=mesh, specs=model.specs)
        logits, cache, _ = lm.forward(model, tokens=batch.get("tokens"),
                                      embeds=batch.get("embeds"), cache=cache,
                                      use_kernel=use_kernel, mesh=mesh,
                                      local_logits=True)
        return lm.gather_vocab(logits[:, -1:], mesh, cfg.vocab), cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None,
                    use_kernel: bool = True) -> Callable:
    """``serve_step(model, cache, batch) -> (logits [B, 1, V], cache)``,
    one token per sequence, the cache updated in place (under ``mesh``,
    this rank's rows); ``use_kernel`` as in :func:`make_prefill_step`."""
    @torch.no_grad()
    def serve_step(model, cache, batch):
        return lm.serve_step(model, cache, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             use_kernel=use_kernel, mesh=mesh)

    return serve_step


# ---------------------------------------------------------------------------
# cells: a step and stand-ins for its arguments
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One (architecture x input shape x mesh) cell: the step ``fn``, its
    ``args`` (stand-ins on the meta device), the specs its arguments and
    results are placed by (``in_shardings`` / ``out_shardings``, trees of
    specs; None where the reference leaves the placement to XLA), the
    arguments the step may update in place (``donate_argnums``), the
    config with the recipe applied and the mesh."""
    arch: str
    shape: ShapeConfig
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple[int, ...]
    cfg: ModelConfig
    mesh: Any


def _params_standin(cfg: ModelConfig, mesh) -> tuple[lm.LM, dict, dict]:
    """``(model on meta placed under mesh, its specs, its whole leaves on
    meta)``."""
    whole = dict(lm.LM(cfg, device="meta").named_parameters())
    model = lm.LM(cfg, device="meta", mesh=mesh)
    return model, param_specs(whole, mesh, cfg), whole


def _batch_standin(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                   decode: bool) -> tuple[dict, dict]:
    s = 1 if decode else shape.seq_len
    b = shape.global_batch
    out = {}
    if cfg.modality == "text":
        out["tokens"] = torch.empty((b, s), dtype=torch.int32, device="meta")
    else:
        out["embeds"] = torch.empty((b, s, cfg.d_model),
                                    dtype=getattr(torch, cfg.dtype),
                                    device="meta")
    if not decode:
        out["labels"] = torch.empty((b, s), dtype=torch.int32, device="meta")
    specs = batch_specs(out, mesh)
    return with_shardings(out, specs, mesh), specs


def _cache_standin(cfg: ModelConfig, shape: ShapeConfig, mesh):
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")
    specs = cache_specs(cache, mesh, cfg)
    return with_shardings(cache, specs, mesh), specs


def build_cell(arch: str, shape_name, mesh, *, smoke: bool = False,
               recipe: Recipe | None = None, n_layers: int | None = None,
               use_kernel: bool = True) -> Cell:
    """The cell of ``arch`` (``smoke``: its SMOKE config; ``n_layers``: its
    depth cut to that many layers) at input shape ``shape_name`` (a name
    of ``SHAPES`` or a ``ShapeConfig``) over ``mesh``: a train cell
    ``fn(model, opt_state, batch)``, its model's leaves requiring grad, a
    prefill cell ``fn(model, batch)``, a decode cell ``fn(model, cache,
    batch)`` (``use_kernel=False``: on the kernels' plain versions), the
    recipe (``recipe_for``, ``n_micro`` clamped for training) applied to
    the config."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    recipe = recipe or recipe_for(arch, shape)
    if shape.kind == "train":
        recipe = clamp_n_micro(recipe, shape, mesh)
    cfg = _with_recipe(cfg, recipe)
    model, p_specs, whole = _params_standin(cfg, mesh)

    if shape.kind == "train":
        ocfg = AdamWConfig(lr=recipe.lr, moment_dtype=recipe.moment_dtype,
                           factored_v=recipe.factored_v)
        o_specs = {"m": p_specs,
                   "v": opt_v_specs(p_specs, whole, recipe.factored_v),
                   "step": ()}
        o_args = with_shardings(init_opt_state(
            whole, recipe.moment_dtype, recipe.factored_v), o_specs, mesh)
        b_args, b_specs = _batch_standin(cfg, shape, mesh, decode=False)
        fn = make_train_step(cfg, ocfg, recipe, mesh=mesh)
        model.requires_grad_(True)
        return Cell(arch, shape, fn, (model, o_args, b_args),
                    (p_specs, o_specs, b_specs), (p_specs, o_specs, None),
                    (0, 1), cfg, mesh)

    if shape.kind == "prefill":
        b_args, b_specs = _batch_standin(cfg, shape, mesh, decode=False)
        _, c_specs = _cache_standin(cfg, shape, mesh)
        fn = make_prefill_step(cfg, shape, mesh=mesh, use_kernel=use_kernel)
        return Cell(arch, shape, fn, (model, b_args), (p_specs, b_specs),
                    (None, c_specs), (), cfg, mesh)

    # decode: one new token against a seq_len-deep cache
    c_args, c_specs = _cache_standin(cfg, shape, mesh)
    b_args, b_specs = _batch_standin(cfg, shape, mesh, decode=True)
    fn = make_serve_step(cfg, mesh=mesh, use_kernel=use_kernel)
    return Cell(arch, shape, fn, (model, c_args, b_args),
                (p_specs, c_specs, b_specs), (None, c_specs), (1,), cfg,
                mesh)


def input_specs(arch: str, shape_name, mesh, *, smoke: bool = False,
                recipe: Recipe | None = None) -> dict:
    """The stand-ins of every argument of the cell's step, by name."""
    cell = build_cell(arch, shape_name, mesh, smoke=smoke, recipe=recipe)
    names = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "cache", "batch")}[cell.shape.kind]
    return dict(zip(names, cell.args))
