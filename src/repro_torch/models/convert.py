"""Carry the JAX package's LM weights and KV caches into the port.

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


def _copy_into(module: nn.Module, tree: dict, done: set, where: str) -> None:
    for name, leaf in tree.items():
        target = getattr(module, name, None)
        if isinstance(leaf, dict):
            _copy_into(target, leaf, done, f"{where}{name}.")
            continue
        if isinstance(target, nn.Module):        # a norm: its weight
            target = target.weight
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"no port parameter for {where}{name}")
        src = to_tensor(leaf, target.device)
        if src.shape != target.shape or src.dtype != target.dtype:
            raise ValueError(f"{where}{name}: reference {tuple(src.shape)} "
                             f"{src.dtype}, port {tuple(target.shape)} "
                             f"{target.dtype}")
        target.copy_(src)
        done.add(id(target))


def lm_params_from_reference(cfg: ModelConfig, params: dict, *,
                             device="cuda") -> LM:
    """The port's :class:`~repro_torch.models.lm.LM` holding a copy of every
    array of the reference's ``lm.init_lm`` tree ``params`` (each subtree,
    ``attn`` (GQA or MLA), ``mixer``, ``mlp``, ``moe`` (with its ``shared``
    experts), ``mlstm`` or ``slstm``, into the module of its name; a MoE
    model's dense ``block0`` into layer 0).  Raises if the tree lacks an
    array of the port's or holds one the port does not have."""
    dev = check_device(device)
    model = LM(cfg, device=dev)              # empty: every tensor is copied
    done: set = set()
    top = {k: v for k, v in params.items()
           if k not in ("blocks", "block0", "layers")}
    with torch.no_grad():
        _copy_into(model, top, done, "")
        for i, tree in enumerate(_layer_trees(params, cfg.n_layers)):
            _copy_into(model.blocks[i], tree, done, f"blocks.{i}.")
    missing = [n for n, p in model.named_parameters() if id(p) not in done]
    if missing:
        raise KeyError(f"reference params lack {missing}")
    return model


def cache_from_reference(cfg: ModelConfig, cache: dict, *,
                         device="cuda") -> dict:
    """The port's cache (``{"pos", "layers": [{"k", "v", "len"}]}``, an MLA
    model's layers ``{"latent", "k_rope", "len"}``, a hybrid model's layers
    ``{"attn": {"k", "v", "len"}, "ssm": {"conv", "ssm"}}``, an xLSTM
    model's ``{"state": {...}}``) holding a copy of the reference's
    ``lm.init_cache`` / ``forward`` cache, every leaf in its own dtype."""
    dev = check_device(device)

    def attn(t):
        return {"k": to_tensor(t["k"], dev), "v": to_tensor(t["v"], dev),
                "len": int(np.asarray(t["len"]))}

    def layer(t):
        if "latent" in t:                    # MLA: the latent and rope key
            return {"latent": to_tensor(t["latent"], dev),
                    "k_rope": to_tensor(t["k_rope"], dev),
                    "len": int(np.asarray(t["len"]))}
        if "state" in t:                     # xLSTM: mLSTM or sLSTM state
            return {"state": {k: to_tensor(v, dev)
                              for k, v in t["state"].items()}}
        if "ssm" not in t:
            return attn(t)
        return {"attn": attn(t["attn"]),
                "ssm": {k: to_tensor(v, dev) for k, v in t["ssm"].items()}}
    return {"pos": int(np.asarray(cache["pos"])),
            "layers": [layer(t) for t in _layer_trees(cache, cfg.n_layers)]}
