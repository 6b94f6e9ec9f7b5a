"""Carry the JAX package's LM weights, KV caches, gradients and optimizer
states into the port.

The model counterpart of :mod:`repro_torch.core.convert` (which carries
shuffle plans).  Inputs are the reference's pytrees with numpy leaves (a
leaf that converts with ``np.asarray`` will do); nothing of jax is imported.
bfloat16 leaves arrive as numpy arrays of the ``ml_dtypes`` bfloat16 type,
which ``torch.from_numpy`` refuses: they cross as their uint16 bits.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.device import check_device
from repro_torch.launch import shardings

from .config import ModelConfig
from .lm import LM


def to_tensor(a, device) -> torch.Tensor:
    """A copy of array ``a`` on ``device``, bfloat16 bits kept exactly."""
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _layer_trees(tree: dict, n_layers: int) -> list[dict]:
    """Per-layer subtrees: ``block0`` (a MoE model's dense layer 0) if
    present, then the ``blocks`` of a scanned stack unstacked along their
    leading layer axis; or the ``layers`` list as it is.  Every expert of a
    stacked ``[E, ...]`` weight stays at its own index."""
    if "layers" in tree:
        return list(tree["layers"])

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) \
            else np.asarray(t)[i]
    first = [tree["block0"]] if "block0" in tree else []
    return first + [pick(tree["blocks"], i)
                    for i in range(n_layers - len(first))]


def _pairs(module: nn.Module, tree: dict, where: str = ""):
    """``(port name, port tensor, reference leaf)`` for every leaf of
    ``tree`` under ``module``: a subtree goes into the submodule of its
    name, a norm's leaf is that module's ``weight``.  A leaf that is a
    dict of the factored second moment's ``r`` and ``c`` counts as one
    leaf."""
    for name, leaf in tree.items():
        target = getattr(module, name, None)
        if isinstance(leaf, dict) and not _is_factored(leaf):
            yield from _pairs(target, leaf, f"{where}{name}.")
            continue
        if isinstance(target, nn.Module):        # a norm: its weight
            target, name = target.weight, f"{name}.weight"
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"no port parameter for {where}{name}")
        yield f"{where}{name}", target, leaf


def _is_factored(leaf: dict) -> bool:
    return set(leaf) == {"r", "c"}


def _placed(model: LM | None, name: str, src: torch.Tensor,
            mesh) -> torch.Tensor:
    """This rank's shard of the whole array ``src`` of leaf ``name`` by
    the model's spec (``src`` itself for a model not placed)."""
    spec = None if model is None else model.specs.get(name)
    if spec is None or mesh is None:
        return src
    return shardings.shard(src, spec, mesh)


def _copy_into(module: nn.Module, tree: dict, done: set, where: str, *,
               model: LM | None = None, mesh=None) -> None:
    """Copy every leaf of ``tree`` (this rank's shard of it, for a placed
    model) into its tensor under ``module`` (shape and dtype checked),
    adding each tensor's ``id`` to ``done``."""
    for name, target, leaf in _pairs(module, tree, where):
        src = _placed(model, name, to_tensor(leaf, target.device), mesh)
        if src.shape != target.shape or src.dtype != target.dtype:
            raise ValueError(f"{name}: reference {tuple(src.shape)} "
                             f"{src.dtype}, port {tuple(target.shape)} "
                             f"{target.dtype}")
        target.copy_(src)
        done.add(id(target))


def _model_pairs(model: LM, params: dict):
    """:func:`_pairs` over a whole reference tree shaped like
    ``lm.init_lm``'s: the top-level leaves, then each layer's subtree
    (unstacked) into its block."""
    top = {k: v for k, v in params.items()
           if k not in ("blocks", "block0", "layers")}
    yield from _pairs(model, top)
    for i, tree in enumerate(_layer_trees(params, model.cfg.n_layers)):
        yield from _pairs(model.blocks[i], tree, f"blocks.{i}.")


def lm_params_from_reference(cfg: ModelConfig, params: dict, *,
                             device="cuda", mesh=None) -> LM:
    """The port's :class:`~repro_torch.models.lm.LM` holding a copy of every
    array of the reference's ``lm.init_lm`` tree ``params`` (each subtree,
    ``attn`` (GQA or MLA), ``mixer``, ``mlp``, ``moe`` (with its ``shared``
    experts), ``mlstm`` or ``slstm``, into the module of its name; a MoE
    model's dense ``block0`` into layer 0).  Under ``mesh`` the model is
    placed (``lm.LM``) and keeps this rank's shard of each array.  Raises
    if the tree lacks an array of the port's or holds one the port does
    not have."""
    dev = check_device(device)
    model = LM(cfg, device=dev, mesh=mesh)   # empty: every tensor is copied
    done: set = set()
    top = {k: v for k, v in params.items()
           if k not in ("blocks", "block0", "layers")}
    with torch.no_grad():
        _copy_into(model, top, done, "", model=model, mesh=mesh)
        for i, tree in enumerate(_layer_trees(params, cfg.n_layers)):
            _copy_into(model.blocks[i], tree, done, f"blocks.{i}.",
                       model=model, mesh=mesh)
    missing = [n for n, p in model.named_parameters() if id(p) not in done]
    if missing:
        raise KeyError(f"reference params lack {missing}")
    return model


def named_from_reference(model: LM, tree: dict, *, mesh=None) -> dict:
    """``{port parameter name: tensor}`` of a reference tree shaped like
    the parameters (a gradient tree of ``jax.grad``, a moment, a mask
    broadcast to the leaves), by the mapping
    :func:`lm_params_from_reference` uses: each leaf keeps its own dtype,
    and its shape must be the port parameter's.  A factored leaf (``{"r",
    "c"}``) comes over as a dict of both.  For a model placed on ``mesh``
    each leaf is this rank's shard by its spec (a factored leaf's by
    ``shardings.opt_v_specs``).  Keys follow ``model.named_parameters()``;
    on the model's device."""
    dev = model.embed.device
    out = {}
    for name, target, leaf in _model_pairs(model, tree):
        if isinstance(leaf, dict):
            out[name] = {k: to_tensor(v, dev) for k, v in leaf.items()}
            spec = model.specs.get(name)
            if spec is not None and mesh is not None:
                vs = shardings.opt_v_specs({name: spec}, {
                    name: shardings.global_shape(spec, target.shape, mesh)},
                    True)[name]
                if isinstance(vs, dict):
                    out[name] = {k: shardings.shard(t, vs[k], mesh)
                                 for k, t in out[name].items()}
            if not (_factorable(target) and out[name]["r"].shape
                    == target.shape[:-1] and out[name]["c"].shape
                    == target.shape[:-2] + target.shape[-1:]):
                raise ValueError(f"{name}: a factored moment of "
                                 f"{tuple(target.shape)} the port cannot "
                                 f"hold (a stacked 1-D leaf the reference "
                                 f"factors across its layers)")
            continue
        out[name] = _placed(model, name, to_tensor(leaf, dev), mesh)
        if out[name].shape != target.shape:
            raise ValueError(f"{name}: reference {tuple(out[name].shape)}, "
                             f"port {tuple(target.shape)}")
    order = [n for n, _ in model.named_parameters()]
    if set(out) != set(order):
        raise KeyError(f"reference tree lacks {sorted(set(order) - set(out))}")
    return {n: out[n] for n in order}


def _factorable(t: torch.Tensor) -> bool:
    return t.dim() >= 2 and t.shape[-1] > 1 and t.shape[-2] > 1


def opt_state_from_reference(model: LM, opt_state: dict, *,
                             mesh=None) -> dict:
    """The reference's ``init_opt_state`` / ``adamw_update`` state in the
    port's layout: ``{"m": {name: ...}, "v": {name: ... or {"r", "c"}},
    "step": 0-dim int32}`` on the model's device, every leaf in its own
    dtype and each moment in its parameter's memory layout (as
    ``init_opt_state`` makes it; ``unembed`` is a transposed view).  A
    scanned stack's 1-D leaf that the reference factors across its layer
    axis has no per-layer counterpart and raises.  For a model placed on
    ``mesh``, this rank's shards."""
    params = dict(model.named_parameters())

    def laid_out(name, t):
        if isinstance(t, dict):
            return t
        return torch.empty_like(params[name], dtype=t.dtype).copy_(t)
    out = {k: {n: laid_out(n, t) for n, t in
               named_from_reference(model, opt_state[k], mesh=mesh).items()}
           for k in ("m", "v")}
    out["step"] = to_tensor(np.asarray(opt_state["step"], np.int32),
                            model.embed.device)
    return out


def _rank_heads(cfg: ModelConfig, mesh, layer: int, max_len: int,
                specs) -> slice:
    """The kv heads of attention layer ``layer`` (of ``max_len``
    positions) that this rank's cache holds under ``mesh``
    (``shardings.local_kv_heads``): its ``model`` block of them, under KV
    replication every one of its block of ``T``, or (``T`` whole) the one
    its q heads read."""
    n = shardings.local_kv_heads(cfg, mesh, layer, max_len, specs)
    if n == cfg.n_kv_heads:
        return slice(None)
    m, r = mesh.shape["model"], mesh.coord("model")
    first = r * n if n * m == cfg.n_kv_heads else shardings.kv_head_of(
        r, m, cfg.n_kv_heads)
    return slice(first, first + n)


def cache_from_reference(cfg: ModelConfig, cache: dict, *,
                         device="cuda", mesh=None,
                         specs: dict | None = None) -> dict:
    """The port's cache (``{"pos", "layers": [{"k", "v", "len"}]}``, an MLA
    model's layers ``{"latent", "k_rope", "len"}``, a hybrid model's layers
    ``{"attn": {"k", "v", "len"}, "ssm": {"conv", "ssm"}}``, an xLSTM
    model's ``{"state": {...}}``) holding a copy of the reference's
    ``lm.init_cache`` / ``forward`` cache, every leaf in its own dtype.
    Under ``mesh`` a GQA layer whose heads split over ``model`` keeps this
    rank's kv heads (``lm.init_cache``'s layout; ``specs`` the model's, as
    there; a hybrid layer's attention too), a GQA layer that splits by
    positions or under KV replication every kv head of the rank's block of
    ``T`` (and its ``t0``: ``shardings.local_cache_rows``), a hybrid
    layer's Mamba state the rank's channels where its head splits them, an
    MLA layer whose heads split the latent and rope key of its block of
    ``T``, an xLSTM layer the whole state; the rows of the batch stay the
    caller's."""
    dev = check_device(device)

    def ssm(t, i):
        c = slice(None)
        if mesh is not None:
            n = shardings.local_channels(cfg, mesh, i, specs)
            r = mesh.coord("model") if n != cfg.d_model * cfg.ssm.expand \
                else 0
            c = slice(r * n, (r + 1) * n)
        return {"conv": to_tensor(np.asarray(t["conv"])[:, :, c], dev),
                "ssm": to_tensor(np.asarray(t["ssm"])[:, c], dev)}

    def block(t, i, names, heads=()):
        """The leaves ``names`` of layer ``i``'s cache ``t``, each
        ``[B, T, ...]``, at the rank's rows of ``T`` (and ``heads``)."""
        rows = None if mesh is None else shardings.local_cache_rows(
            cfg, mesh, i, np.shape(t[names[0]])[1], specs)
        pos = slice(None) if rows is None else slice(rows[0],
                                                     rows[0] + rows[1])
        out = {k: to_tensor(np.asarray(t[k])[(slice(None), pos, *heads)],
                            dev) for k in names}
        out["len"] = int(np.asarray(t["len"]))
        if rows is not None:
            out["t0"] = rows[0]
        return out

    def attn(t, i):
        heads = slice(None) if mesh is None else _rank_heads(
            cfg, mesh, i, np.shape(t["k"])[1], specs)
        return block(t, i, ("k", "v"), (heads,))

    def layer(t, i):
        if "latent" in t:                    # MLA: the latent and rope key
            return block(t, i, ("latent", "k_rope"))
        if "state" in t:                     # xLSTM: mLSTM or sLSTM state
            return {"state": {k: to_tensor(v, dev)
                              for k, v in t["state"].items()}}
        if "ssm" not in t:
            return attn(t, i)
        return {"attn": attn(t["attn"], i), "ssm": ssm(t["ssm"], i)}
    return {"pos": int(np.asarray(cache["pos"])),
            "layers": [layer(t, i) for i, t in enumerate(
                _layer_trees(cache, cfg.n_layers))]}
