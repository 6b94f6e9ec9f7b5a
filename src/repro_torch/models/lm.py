"""The port's decoder LM: the dense, MoE, hybrid and SSM families with token input.

Counterpart of ``repro.models.lm`` for ``family`` ``"dense"``, ``"moe"``
(DeepSeek-V2's with MLA among them), ``"hybrid"`` (Hymba) and ``"ssm"``
(xLSTM): the same parameters (``embed``, ``final_norm``, ``unembed`` and per
block ``ln1``, ``attn`` (GQA, or MLA when ``cfg.mla`` is set) or a hybrid's
``mixer``, ``ln2`` and ``mlp`` or ``moe``; an xLSTM block ``ln1`` and
``mlstm`` or ``slstm`` alone), the same forward, cache and ``serve_step``.
As in the reference, a MoE model with shared experts keeps a dense FFN of
width ``cfg.d_ff`` in layer 0 (its ``block0``), a hybrid model's attention
is global in ``cfg.global_attn_layers`` and has ``cfg.sliding_window``
elsewhere, and an xLSTM model's every ``cfg.ssm.slstm_every``-th layer is
sLSTM.  The reference's ``lax.scan`` over stacked blocks is an
``nn.ModuleList`` walked in order, and the embedding is a plain lookup.
Logits are computed for every position, as the
reference does.  The vlm and audio configs (pixtral-12b, musicgen-large)
take precomputed embeddings (``embeds``) in place of tokens, cast to the
model's dtype, as the reference's stub frontends hand them over.

:func:`train_loss` is the training objective.  It runs the forward with
``train=True``: the plain paths (``use_kernel=False``), as the
reference's training path takes no Pallas kernel (``use_pallas=False``),
so no kernel of the port runs in it either (none has a backward):
attention without a cache goes through ``layers._attend``, the MoE
experts through the grouped matmul's plain version, sLSTM through its
plain cell loop; with ``cfg.remat`` every block is rematerialised under
``torch.utils.checkpoint`` as the reference's ``jax.checkpoint`` does.
The path is chosen by that argument, never by the device.

Under a mesh (:mod:`repro_torch.launch.mesh`) the model is per-rank SPMD
code: ``forward``, ``serve_step``, ``train_loss`` and each :class:`Block`
take it as an explicit ``mesh=`` keyword (there is no ambient mesh), the
input is this rank's rows of the batch, and a MoE block dispatches over
the EP axes ``ep_axes_for(mesh)`` by its config's template (``teshu`` /
``teshu2``).  A model made under a mesh (``LM``, ``init_lm`` and
``convert`` take ``mesh=``; :func:`place` places one made without) holds
every parameter as this rank's shard by the reference's sharding rules
(``launch.shardings``; the specs in ``model.specs``), and each module
gathers its leaves right before it runs and drops them when it returns
(``shardings.gather``: an all-gather a split dimension, whose gradient
returns as a reduce-scatter), but for the axes it consumes in place
(``shardings.kept_axes``): a routed expert keeps its split over the EP
axes, the dispatch bringing the tokens to it, and is gathered over
``data`` only (on the gspmd dispatch, whole); the ranks along ``model``
split the dense work as the reference's specs do (tensor parallelism):
an MLP on its ``f / m`` columns, GQA attention on its ``h / m`` heads
(where ``model`` divides them; its kv heads too, or the one they read
with every kv head of its block of the cache's ``T``; a hybrid's
attention as well) or, where it does not, by positions (its ``1 / m`` of
the projections' columns, its query rows, its block of the cache's
``T``), MLA on its ``h / m`` heads and its ``1 / m`` of the two
down-projections (their outputs all-gathered; the latent cache the
rank's block of ``T``), Hymba's Mamba head on its ``di / m``
channels (where ``model`` divides them; its state too), the xLSTM
mixers' projections on their ``model`` columns (the outputs gathered,
the cores and states whole) and rows (``w_down``), each ending in one
sum over ``model``, the embedding looked up in the rank's ``d`` slice
and all-gathered, the logits computed on the rank's vocabulary slice
(gathered whole for callers; ``train_loss`` reads the slice).  The
router, the norms and sLSTM's ``w_rec`` are gathered whole.  Under
``cfg.remat`` the gather sits inside the checkpointed block, so the
backward gathers again; without remat autograd keeps the gathered
weights until the backward.  On a ``model`` axis of one rank nothing is
split and no sum is issued: the mesh computes the mesh-free rows bit for
bit.  The training forward runs under a mesh as well: the dispatch's
collectives carry their adjoints, and under ``cfg.remat`` each rank
recomputes a block, and reissues its collectives, in the same order.
:func:`train_loss` then returns this rank's share of the reference's
global loss.  The gspmd dispatch routes a rank's own rows with their own
capacity and aux loss, where the reference's routes the global batch, so
it trains only on a mesh of one batch shard.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core import meshops
from repro_torch.device import check_device
from repro_torch.launch import shardings
from repro_torch.launch.mesh import batch_axes
from repro_torch.launch.shardings import ep_axes_for

from . import layers
from .config import ModelConfig
from .hybrid import HymbaMixer, init_ssm_cache
from .layers import (MLA, MLP, Attention, RMSNorm, dtype_of, embed_init,
                     init_attention_cache, init_mla_cache, param, rms_norm)
from .moe import MoE
from .ssm import (MLSTM, SLSTM, init_mlstm_state, init_slstm_state,
                  mlstm_chunked, mlstm_step, slstm_forward)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    if cfg.family not in ("dense", "moe", "hybrid", "ssm"):
        raise ValueError(f"unknown family {cfg.family!r}")


def is_dense_layer(cfg: ModelConfig, layer: int) -> bool:
    """DeepSeek-style: with shared experts, layer 0 keeps a dense FFN."""
    return cfg.family == "moe" and cfg.moe.num_shared > 0 and layer == 0


def is_slstm(cfg: ModelConfig, layer: int) -> bool:
    """xLSTM: every ``cfg.ssm.slstm_every``-th layer (the last of each
    group) is sLSTM, the rest mLSTM."""
    k = cfg.ssm.slstm_every if cfg.ssm else 0
    return bool(k) and layer % k == k - 1


def layer_window(cfg: ModelConfig, layer: int) -> int:
    """The attention window of ``layer``: a hybrid model's global layers
    have none (0), every other layer ``cfg.sliding_window``."""
    if cfg.family == "hybrid" and layer in tuple(cfg.global_attn_layers):
        return 0
    return cfg.sliding_window


class Block(nn.Module):
    """One transformer block: pre-norm attention (GQA, or MLA when
    ``cfg.mla`` is set; a hybrid model's ``mixer``: attention and Mamba
    side by side), then a pre-norm MLP, or
    MoE FFN (``moe``) in a MoE model's routed layers.  An xLSTM block is a
    pre-norm ``mlstm`` or ``slstm`` and its residual, with no MLP."""

    def __init__(self, cfg: ModelConfig, layer: int, *, device, gen=None):
        super().__init__()
        dt = dtype_of(cfg)
        window = layer_window(cfg, layer)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        if cfg.family == "ssm":
            if is_slstm(cfg, layer):
                self.slstm = SLSTM(cfg, device=device, gen=gen)
            else:
                self.mlstm = MLSTM(cfg, device=device, gen=gen)
            return
        if cfg.family == "hybrid":
            self.mixer = HymbaMixer(cfg, device=device, gen=gen, window=window)
        elif cfg.mla is not None:
            self.attn = MLA(cfg, device=device, gen=gen)
        else:
            self.attn = Attention(cfg, device=device, gen=gen, window=window)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        if cfg.family == "moe" and not is_dense_layer(cfg, layer):
            self.moe = MoE(cfg, device=device, gen=gen)
        else:
            self.mlp = MLP(cfg, device=device, gen=gen)

    def forward(self, x, positions, *, cache=None, use_kernel=True,
                mesh=None):
        """``(x, aux)``: ``aux`` the router's load-balance loss, or None.
        A MoE block under ``mesh`` dispatches over ``ep_axes_for(mesh)``."""
        if self.cfg.family == "ssm":
            return x + self._xlstm(self.ln1(x), cache, use_kernel, mesh), None
        mix = self.mixer if hasattr(self, "mixer") else self.attn
        out, _ = mix(self.ln1(x), positions, cache=cache,
                     use_kernel=use_kernel, mesh=mesh)
        x = x + out
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(x), use_kernel=use_kernel, mesh=mesh,
                              mesh_axes=() if mesh is None
                              else ep_axes_for(mesh))
            return x + y, aux
        return x + self.mlp(self.ln2(x), mesh), None

    def _xlstm(self, h, cache, use_kernel, mesh):
        """The xLSTM mixer's output; a given cache's ``state`` is updated in
        place.  With a cache, one token takes ``mlstm_step`` and any other
        length ``mlstm_chunked`` from the cached state; sLSTM always runs
        ``slstm_forward`` (from the cached state, if any).  ``mesh`` is
        needed only where the projections arrive as this rank's
        ``model`` shards (``ssm``'s docstring)."""
        cfg, state = self.cfg, None if cache is None else cache["state"]
        if hasattr(self, "slstm"):
            with record_function("xlstm.slstm"):    # names it in a profile
                out, new = slstm_forward(self.slstm, cfg, h, state,
                                         use_kernel=use_kernel, mesh=mesh)
        else:
            with record_function("xlstm.mlstm"):
                if state is not None and h.shape[1] == 1:
                    out, new = mlstm_step(self.mlstm, cfg, h, state,
                                          mesh=mesh)
                else:
                    out, new = mlstm_chunked(self.mlstm, cfg, h, state,
                                             mesh=mesh)
        if state is not None:
            for k, v in new.items():
                state[k].copy_(v)
        return out


def _device(device) -> torch.device:
    """``check_device``, and the meta device for stand-ins."""
    return torch.device("meta") if str(device) == "meta" \
        else check_device(device)


class LM(nn.Module):
    """Made from ``gen`` with the reference's distributions, or empty (for
    :func:`repro_torch.models.convert.lm_params_from_reference` to fill;
    on the meta device, a stand-in); under ``mesh`` each leaf is drawn
    whole and kept as this rank's shard, each block as it is built."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", gen=None,
                 mesh=None):
        super().__init__()
        check_supported(cfg)
        dev = _device(device)
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.specs: dict = {}             # {name: spec} once placed
        self.mesh_shape: dict | None = None
        self._split: set = set()          # leaves held in part
        self._plans: dict = {}
        self.embed = param(embed_init(gen, cfg.vocab, cfg.d_model, dt, dev))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dt, dev)
        # [d_model, vocab] as in the reference (a transposed view)
        unembed = None if cfg.tie_embeddings else param(
            embed_init(gen, cfg.vocab, cfg.d_model, dt, dev).t())
        self.register_parameter("unembed", unembed)
        if mesh is not None:
            _place_leaves(self, self, "", mesh)     # before the blocks
        blocks = []
        for i in range(cfg.n_layers):
            block = Block(cfg, i, device=dev, gen=gen)
            if mesh is not None:
                _place_leaves(self, block, f"blocks.{i}.", mesh)
            blocks.append(block)
        self.blocks = nn.ModuleList(blocks)
        if mesh is not None:
            self.mesh_shape = dict(mesh.shape)

    def _gathers(self, mesh) -> dict:
        """``{prefix: {name under it: gather spec}}`` of the leaves a
        forward under ``mesh`` gathers (``""`` the top-level leaves,
        ``"blocks.i."`` block i's), without the axes each leaf's module
        consumes in place (``shardings.kept_axes``: a routed expert's EP
        axes, a tensor-parallel leaf's ``model``)."""
        if mesh is None:
            if self._split:
                raise ValueError(f"the model is placed on a mesh of "
                                 f"{self.mesh_shape}: pass that mesh")
            return {}
        if self.mesh_shape != dict(mesh.shape):
            raise ValueError(f"the model is placed on {self.mesh_shape}, "
                             f"not on {dict(mesh.shape)}: make it with "
                             f"mesh= or place() it")
        plan = self._plans.get(mesh)
        if plan is None:
            plan = {}
            for n, spec in self.specs.items():
                g = shardings.gather_spec(spec, mesh, shardings.kept_axes(
                    n, spec, mesh, self.cfg))
                if any(g):
                    pre = "" if not n.startswith("blocks.") else \
                        ".".join(n.split(".")[:2]) + "."
                    plan.setdefault(pre, {})[n[len(pre):]] = g
            self._plans[mesh] = plan
        return plan

    def _leaf(self, name: str, top: dict, mesh) -> torch.Tensor:
        p = self.get_parameter(name)
        return shardings.gather(p, top[name], mesh) if name in top else p

    def forward(self, tokens: torch.Tensor | None = None, *, embeds=None,
                positions=None, cache=None, use_kernel: bool = True,
                train: bool = False, mesh=None, local_logits: bool = False):
        """``tokens [B, S]`` (or ``embeds [B, S, D]``, cast to the model's
        dtype) -> ``(logits [B, S, vocab], cache, aux)``.  A given cache is
        updated in place (every layer's rows ``[pos, pos + S)`` and
        ``pos``), not copied; ``aux`` is the float32 sum of the MoE layers'
        router losses (0 for a dense model).  ``train=True`` takes the
        plain paths (``use_kernel=False``) and no cache, each block
        rematerialised when ``cfg.remat``.  Under ``mesh`` (the one the
        model is placed on) the batch is this rank's rows, and each module
        gathers its placed leaves right before it runs, but for those it
        consumes as its ``model`` shard; the logits are gathered whole over
        ``model`` where the unembedding splits the vocabulary, unless
        ``local_logits`` (this rank's ``V / m`` of them: the vocabulary
        slice of its ``model`` coordinate).  A MoE model on the gspmd
        dispatch trains under it only where it has one batch shard (else it
        raises)."""
        plan = self._gathers(mesh)
        top = plan.get("", {})
        if tokens is not None:
            b, s = tokens.shape
            table = self._leaf("embed", top, mesh)
            x = F.embedding(tokens, table)
            if table.shape[1] != self.cfg.d_model:    # this rank's d slice
                x = meshops.all_gather(x, mesh, "model", axis=2)
        elif embeds is not None:
            b, s = embeds.shape[:2]
            x = embeds.to(self.embed.dtype)
        else:
            raise ValueError("forward needs tokens or embeds")
        if train and cache is not None:
            raise ValueError("the training forward takes no cache")
        if train and mesh is not None and self.cfg.moe is not None and (
                self.cfg.moe.dispatch == "gspmd" or not ep_axes_for(mesh)) \
                and mesh.axis_size(batch_axes(mesh)) > 1:
            raise NotImplementedError(
                "the gspmd dispatch routes each rank's rows with their own "
                "capacity and aux loss, where the reference routes the "
                "global batch: train over several batch shards on teshu or "
                "teshu2")
        if positions is None:
            base = cache["pos"] if cache is not None else 0
            positions = (base + torch.arange(s, device=x.device)).expand(b, s)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        use_kernel = use_kernel and not train
        for i, block in enumerate(self.blocks):
            leaves = plan.get(f"blocks.{i}.")
            if train and self.cfg.remat:
                x, aux = checkpoint(_run_block, block, leaves, x, positions,
                                    use_reentrant=False, use_kernel=False,
                                    mesh=mesh)
            else:
                x, aux = _run_block(block, leaves, x, positions,
                                    use_kernel=use_kernel, cache=None
                                    if cache is None else cache["layers"][i],
                                    mesh=mesh)
            if aux is not None:
                aux_total = aux_total + aux
        x = rms_norm(x, self._leaf("final_norm.weight", top, mesh),
                     self.final_norm.eps)
        unembed = self._leaf("embed", top, mesh).t() if self.unembed is None \
            else self._leaf("unembed", top, mesh)
        logits = x @ unembed                  # [B, S, V / m] where split
        del unembed
        if cache is not None:
            cache["pos"] += s
        if not local_logits:
            logits = gather_vocab(logits, mesh, self.cfg.vocab)
        return logits, cache, aux_total


def _run_block(block: Block, leaves: dict | None, x, positions, *, mesh,
               **kw):
    """``block(x, positions, ...)`` with each leaf of ``leaves`` (``{name
    under the block: gather spec}``) gathered whole for the call (the
    gathered copies dropped when it returns); without leaves the block as
    it is."""
    if not leaves:
        return block(x, positions, mesh=mesh, **kw)
    whole = {n: shardings.gather(block.get_parameter(n), spec, mesh)
             for n, spec in leaves.items()}
    return functional_call(block, whole, (x, positions),
                           dict(kw, mesh=mesh))


def _place_leaves(model: LM, module: nn.Module, prefix: str, mesh) -> None:
    """Each parameter of ``module`` (named ``prefix + name`` in ``model``)
    replaced, one at a time, by this rank's shard by its spec; the specs
    recorded on ``model``."""
    for n, p in module.named_parameters():
        name = prefix + n
        spec = shardings.leaf_spec(name, p.shape, mesh, model.cfg)
        model.specs[name] = spec
        whole = p.data
        local = shardings.shard(whole, spec, mesh)
        if local is not whole:
            p.data = local
            model._split.add(name)


def place(model: LM, mesh) -> LM:
    """Place a model made without a mesh on ``mesh``: every parameter kept
    as this rank's shard by its spec, in place (on one rank, or wherever
    every axis a spec names has size 1, the tensors stay as they are).
    Returns the model."""
    if model.mesh_shape is not None:
        raise ValueError(f"the model is already placed on "
                         f"{model.mesh_shape}")
    _place_leaves(model, model, "", mesh)
    model.mesh_shape = dict(mesh.shape)
    model._plans.clear()
    return model


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda",
            mesh=None) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (normal draws scaled as ``dense_init`` / ``embed_init``;
    norms ones, biases zeros).  Under ``mesh`` each leaf is drawn whole, in
    the same order, and this rank keeps its shard: every mesh holds the
    same global weights."""
    dev = check_device(device)
    return LM(cfg, device=dev, mesh=mesh,
              gen=torch.Generator(device=dev).manual_seed(seed))


def gather_vocab(logits: torch.Tensor, mesh, vocab: int) -> torch.Tensor:
    """Logits whole over the vocabulary: the ``model`` ranks' slices
    all-gathered on the last dimension where ``logits`` holds ``V / m``
    of ``vocab``, else ``logits`` itself."""
    if logits.shape[-1] == vocab:
        return logits
    return meshops.all_gather(logits, mesh, "model", axis=logits.dim() - 1)


def forward(model: LM, *, tokens=None, embeds=None, positions=None,
            cache=None, use_kernel: bool = True, train: bool = False,
            mesh=None, local_logits: bool = False):
    """Returns ``(logits, cache, aux)`` as the reference's ``forward``
    (``local_logits``: see :meth:`LM.forward`)."""
    return model(tokens, embeds=embeds, positions=positions, cache=cache,
                 use_kernel=use_kernel, train=train, mesh=mesh,
                 local_logits=local_logits)


def _gold_logit(logits: torch.Tensor, labels: torch.Tensor, mesh
                ) -> torch.Tensor:
    """Each position's logit of its label from this rank's vocabulary
    slice ``logits [.., V / m]`` (the ``model`` rank that owns the label
    gives it, the others 0), summed over ``model``."""
    v, first = logits.shape[-1], mesh.coord("model") * logits.shape[-1]
    own = (labels >= first) & (labels < first + v)
    idx = (labels - first).clamp(0, v - 1)
    gold = logits.gather(-1, idx[..., None])[..., 0]
    return layers.tp_sum(torch.where(own, gold, 0.0), mesh)


def _logz_gold(logits: torch.Tensor, labels: torch.Tensor, mesh, vocab: int):
    """``(logsumexp, gold logit)`` of float32 ``logits`` over the
    vocabulary, each position's ``labels`` (>= 0).  Where ``logits`` is
    this rank's slice of a vocabulary split over ``model``: the max over
    ``model`` (a MAX all-reduce, no gradient), the sum of exponentials
    summed over ``model``, the gold logit from the rank that owns it."""
    if logits.shape[-1] == vocab:
        return torch.logsumexp(logits, dim=-1), \
            logits.gather(-1, labels[..., None])[..., 0]
    top = meshops.psum(logits.detach().amax(-1), mesh, ("model",),
                       op=dist.ReduceOp.MAX)
    sumexp = layers.tp_sum((logits - top[..., None]).exp().sum(-1), mesh)
    return top + sumexp.log(), _gold_logit(logits, labels, mesh)


def train_loss(model: LM, batch: dict, *, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy plus ``0.01 *`` the router's aux loss, as
    the reference's ``train_loss``: ``batch`` holds ``tokens`` or
    ``embeds``, and ``labels [B, S]`` (positions with a label < 0 are
    masked); float32 logits, the mean over the unmasked positions.  Runs
    the training forward (``train=True``).

    Under ``mesh`` the batch is this rank's rows and the result is this
    rank's share of the reference's global loss; the shares of all ranks
    sum to it.  The NLL's share is the rank's masked sum over the global
    count of unmasked positions (a sum over the batch axes ``("pod",
    "data")``), divided by the number of ranks that hold the same rows (the
    mesh's other axes: the tokens are replicated over ``model``); the aux's
    is the aux, the same on every rank (the EP dispatch's ``pmean``, or the
    gspmd dispatch's on one batch shard), over the number of ranks.  Where
    the unembedding splits the vocabulary over ``model`` each rank reads
    its own slice of the logits (:func:`_logz_gold`).
    The gradient of the sum over ranks, which the mesh's step forms by
    summing each leaf's gradient over the axes it is replicated on, is the
    reference's under ``shard_map``."""
    logits, _, aux = forward(model, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), train=True,
                             mesh=mesh, local_logits=True)
    labels = batch["labels"].long()
    logz, gold = _logz_gold(logits.float(), labels.clamp(min=0), mesh,
                            model.cfg.vocab)
    mask = (labels >= 0).float()
    count, replicas, ranks = mask.sum(), 1, 1
    if mesh is not None:
        rows = batch_axes(mesh)
        if rows:
            count = meshops.psum(count, mesh, rows)
        replicas, ranks = mesh.size // mesh.axis_size(rows), mesh.size
    nll = ((logz - gold) * mask).sum() / torch.clamp(count, min=1.0)
    return nll / replicas + 0.01 * aux / ranks


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", mesh=None, specs: dict | None = None) -> dict:
    """``{"pos": 0, "layers": [{"k", "v", "len"}, ...]}``, an MLA model's
    layers ``{"latent", "k_rope", "len"}``, a hybrid model's layers
    ``{"attn": {"k", "v", "len"}, "ssm": {"conv", "ssm"}}``, an xLSTM
    model's ``{"state": {"C", "n", "m"}}`` (mLSTM) or ``{"state": {"c",
    "n", "h", "m"}}`` (sLSTM); keys, values, the latent, the rope key and
    the conv tail are bfloat16 whatever the model's dtype, the scan and
    xLSTM states float32, as in the reference (an xLSTM cache does not
    grow: ``max_len`` is unused).  Under ``mesh`` a GQA layer whose heads
    split over ``model`` keeps this rank's kv heads
    (``shardings.local_kv_heads``, by ``specs``, the model's, where
    given: a model placed with other specs than the rules' keeps its
    own); a GQA layer that splits by positions (``"positions"``: its heads
    do not divide ``model``) or under KV replication (its kv heads fewer
    than ``model``'s ranks) keeps every kv head of this rank's block of
    ``T`` (``shardings.local_cache_rows``: ``max_len / m`` rows from
    ``t0``, held as the layer's ``t0``), as the reference's ``cache_spec``
    splits ``T``; an MLA layer whose heads split keeps its latent and rope
    key for the rank's block of ``T`` alike (the reference's specs split the
    latent's ``r`` over ``model``: the same bytes).  A hybrid layer's attention cache keeps its
    rank's kv heads alike, and its Mamba state (``conv``, ``ssm``) the
    rank's channels where the head splits them
    (``shardings.local_channels``), as the reference's ``cache_spec``
    splits them; its attention cache keeps its block of ``T`` where it
    splits by positions.  The xLSTM states are whole on every rank, whose cores
    run whole (the reference's split ``C``'s key dimension and the sLSTM
    state's ``d`` over ``model``)."""
    check_supported(cfg)
    dev = _device(device)

    def one(layer):
        if cfg.family == "ssm":
            init = init_slstm_state if is_slstm(cfg, layer) \
                else init_mlstm_state
            return {"state": init(cfg, batch, device=dev)}
        rows = None if mesh is None else shardings.local_cache_rows(
            cfg, mesh, layer, max_len, specs)
        if cfg.mla is not None:
            return init_mla_cache(cfg, batch, max_len, device=dev, rows=rows)
        attn = init_attention_cache(
            cfg, batch, max_len, device=dev, kv_heads=None if mesh is None
            else shardings.local_kv_heads(cfg, mesh, layer, max_len, specs),
            rows=rows)
        if cfg.family == "hybrid":
            return {"attn": attn, "ssm": init_ssm_cache(
                cfg, batch, device=dev, channels=None if mesh is None
                else shardings.local_channels(cfg, mesh, layer, specs))}
        return attn
    return {"pos": 0, "layers": [one(i) for i in range(cfg.n_layers)]}


def serve_step(model: LM, cache: dict, tokens=None, embeds=None, *,
               use_kernel: bool = True, mesh=None,
               local_logits: bool = False):
    """Decode one token per sequence: ``(logits [B, 1, V], cache)``, the
    cache updated in place (``local_logits``: see :meth:`LM.forward`)."""
    logits, cache, _ = forward(model, tokens=tokens, embeds=embeds,
                               cache=cache, use_kernel=use_kernel, mesh=mesh,
                               local_logits=local_logits)
    return logits, cache
