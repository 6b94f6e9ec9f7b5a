"""Sharding rules: parameter, optimizer, cache and batch specs, and the
placement of a leaf on a mesh of ranks.

Counterpart of ``repro.launch.shardings``, with the same rules:

* input-projection matrices ``[.., d_in, d_out]`` -> ``(.., fsdp, 'model')``
  (FSDP over the ``fsdp_axes()``, column-parallel over ``model``),
* output projections (``wo`` / ``w_down`` / ``w_out``) -> ``(.., 'model',
  fsdp)``, the embedding ``[V, D]`` -> ``(None, 'model')``, the
  unembedding ``(fsdp, 'model')``,
* routed experts ``[.., E, d, f]`` -> experts over the EP axes
  (``ep_axes_for``), ``f`` over ``data``; the router replicated,
* caches: the batch over ``("pod", "data")`` where it divides, else the
  sequence over ``data``; heads, latent or state over ``model``,
* norms, biases and scalars replicated.

Every assignment is checked for divisibility (:func:`_fit`) and dropped,
the dimension replicated, where the axes' sizes do not divide it.  A spec
is a tuple with one entry a dimension (an axis name, a tuple of names or
None), as a ``PartitionSpec`` reads; a tuple of axes on one dimension is
linearised as JAX linearises it, the first axis major.

The reference stacks a scanned group's leaves ``[L, ...]``; the port keeps
one leaf a layer, so a per-layer leaf's spec is the stacked leaf's with the
layer entry dropped (:func:`leaf_spec`).  Where that entry is not None the
reference splits the stack over layers and the port cannot: the leaf keeps
its trailing split and is replicated over the dropped axes
(:func:`lost_layer_splits`; norms and biases).

Placement.  Under a mesh a leaf is held as this rank's shard by its spec
(:func:`shard`), a plain local tensor in the whole leaf's memory order, and
gathered right before the module that uses it (:func:`gather`: an
all-gather a split dimension in JAX's order, its adjoint a reduce-scatter
over the same axes), as ZeRO-3 does over each leaf's own axes, but for the
axes the module consumes in place (:func:`kept_axes`): a routed expert's
EP axes, and ``model`` for the tensor-parallel leaves (the MLP's and
shared experts' column- and row-parallel matrices, GQA attention's
projections where :func:`attention_split` splits them by heads or by
positions (a hybrid's too), MLA's five
matrices where :func:`mla_split` splits its heads, Hymba's Mamba head on
its channels and the xLSTM mixers' projections where :func:`mixer_split`
splits them, the embedding's ``d`` slice, the unembedding's vocabulary
slice), whose modules end a row-parallel product in one sum over
``model``.  Over axes of total size 1
:func:`gather` returns the leaf itself.
:func:`to_placements` states a spec as ``torch.distributed.tensor``
placements on the mesh's ``DeviceMesh``, and :func:`with_shardings` and
:func:`global_view` make ``DTensor`` views (stand-ins on the meta device,
or the global view of a rank's shard).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import meshops

from .mesh import Mesh

# FSDP axes of the parameters: ("data",) keeps them replicated across pods;
# ("pod", "data") shards them across pods too (the reference's knob)
_FSDP_AXES: tuple = ("data",)


def set_fsdp_axes(axes: tuple) -> None:
    global _FSDP_AXES
    _FSDP_AXES = tuple(axes)


def fsdp_axes() -> tuple:
    return _FSDP_AXES


_IN_PROJ = ("wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b", "w_gate", "w_up",
            "w_in", "w_rec", "w_bcdt", "w_ifo", "proj")
_OUT_PROJ = ("wo", "w_down", "w_out")


def _fit(axes, dim: int, mesh: Mesh) -> Any:
    """Return ``axes`` if its total size divides ``dim``, else None
    (replicate)."""
    if axes is None:
        return None
    tup = axes if isinstance(axes, tuple) else (axes,)
    size = 1
    for a in tup:
        if a not in mesh.shape:
            return None
        size *= mesh.shape[a]
    if size == 0 or dim % size:
        return None
    return axes


def _spec(shape, trailing, mesh) -> tuple:
    """A spec: ``trailing`` covers the last dimensions, the leading ones
    replicate."""
    trailing = list(trailing)[-len(shape):] if shape else []
    lead = len(shape) - len(trailing)
    return (None,) * lead + tuple(
        _fit(a, shape[lead + i], mesh) for i, a in enumerate(trailing))


def ep_axes_for(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "model") if a in mesh.shape)


def param_spec(path: str, shape: tuple[int, ...], mesh, cfg) -> tuple:
    """The reference's spec of its leaf ``path`` (``/``-joined, as
    ``blocks/attn/wq``) of ``shape``."""
    name = path.rsplit("/", 1)[-1]
    if len(shape) <= 1:
        return (None,) * len(shape)                   # norms, biases, scalars
    fa = _FSDP_AXES if all(a in mesh.shape for a in _FSDP_AXES) else ("data",)
    if "experts/" in path or path.endswith("experts"):
        ep = ep_axes_for(mesh)
        if name in ("w_gate", "w_up"):                # [.., E, d, f]
            return _spec(shape, (ep, None, "data"), mesh)
        if name == "w_down":                          # [.., E, f, d]
            return _spec(shape, (ep, "data", None), mesh)
    if "shared/" in path:                             # few shared experts
        if name in ("w_gate", "w_up"):
            return _spec(shape, (None, fa, "model"), mesh)
        if name == "w_down":
            return _spec(shape, (None, "model", fa), mesh)
    if name == "embed":
        return _spec(shape, (None, "model"), mesh)
    if name == "unembed":
        return _spec(shape, (fa, "model"), mesh)
    if name == "router":
        return (None,) * len(shape)
    if name == "conv":                                # [K, di]
        return _spec(shape, (None, "model"), mesh)
    if name == "log_a":                               # [di, n]
        return _spec(shape, ("model", None), mesh)
    if name in _OUT_PROJ:
        return _spec(shape, ("model", fa), mesh)
    if name in _IN_PROJ:
        return _spec(shape, (fa, "model"), mesh)
    return _spec(shape, (fa, "model"), mesh)          # FSDP x TP


def _uniform_scan(cfg) -> bool:
    return cfg.scan_layers and cfg.family in ("dense", "moe")


def _first_stacked(cfg) -> int:
    """The first layer of the reference's stack: 1 where a MoE model with
    shared experts keeps a dense ``block0``."""
    return int(cfg.family == "moe" and cfg.moe.num_shared > 0)


def _path_str(name: str, cfg) -> tuple[str, int]:
    """``(reference path, stacked layers)`` of the port's parameter
    ``name`` (``blocks.3.attn.wq``, a norm's ``.weight``): the reference's
    ``blocks/attn/wq`` with the number of layers its stack holds, its
    ``block0/...`` or ``layers/3/...`` with 0."""
    name = name.removesuffix(".weight")      # a norm: the reference's leaf
    parts = name.split(".")
    if parts[0] != "blocks":
        return "/".join(parts), 0
    layer, rest = int(parts[1]), "/".join(parts[2:])
    if not _uniform_scan(cfg):
        return f"layers/{layer}/{rest}", 0
    start = _first_stacked(cfg)
    if layer < start:
        return f"block0/{rest}", 0
    return f"blocks/{rest}", cfg.n_layers - start


def _stacked(name: str, shape, mesh, cfg) -> tuple[tuple, Any]:
    """``(spec, dropped entry)``: the port leaf's spec and the layer entry
    of the reference's stacked spec (None for a leaf that is not
    stacked)."""
    path, layers = _path_str(name, cfg)
    if not layers:
        return param_spec(path, tuple(shape), mesh, cfg), None
    full = param_spec(path, (layers,) + tuple(shape), mesh, cfg)
    return full[1:], full[0]


def leaf_spec(name: str, shape, mesh, cfg) -> tuple:
    """The spec of the port's parameter ``name`` of (whole) ``shape``: the
    reference's, a per-layer leaf's that of its stacked leaf with the layer
    entry dropped."""
    return _stacked(name, shape, mesh, cfg)[0]


def param_specs(shapes: dict, mesh, cfg) -> dict:
    """``{name: spec}`` of ``{name: tensor or shape}``, whole shapes."""
    return {n: leaf_spec(n, getattr(s, "shape", s), mesh, cfg)
            for n, s in shapes.items()}


def lost_layer_splits(cfg, mesh) -> dict:
    """``{port parameter name: axes}`` of the per-layer leaves whose
    reference stack is split over its layer axis (``axes`` the dropped
    entry): the port replicates each over those axes."""
    from repro_torch.models.lm import LM
    out = {}
    for n, p in LM(cfg, device="meta").named_parameters():
        _, dropped = _stacked(n, p.shape, mesh, cfg)
        if dropped is not None:
            out[n] = dropped
    return out


def batch_spec(shape: tuple[int, ...], mesh) -> tuple:
    """The batch's leading dimension over ``("pod", "data")`` where their
    sizes divide it, else replicated; the other dimensions replicated."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return (_fit(axes, shape[0], mesh),) + (None,) * (len(shape) - 1)


def batch_specs(batch: dict, mesh) -> dict:
    """``{key: spec}`` of a batch of tensors (or shapes)."""
    return {k: batch_spec(tuple(getattr(v, "shape", v)), mesh)
            for k, v in batch.items()}


def cache_spec(path: str, shape: tuple[int, ...], mesh, cfg) -> tuple:
    """The reference's spec of its cache leaf ``path`` of ``shape``
    (``blocks/...`` stacked over layers)."""
    name = path.rsplit("/", 1)[-1]
    if len(shape) == 0:
        return ()
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    lead = 1 if path.startswith("blocks") else 0      # scan-stacked caches
    body = shape[lead:]

    def with_lead(trailing) -> tuple:
        return _spec(shape, ([None] * lead) + list(trailing), mesh)

    b_ok = body and _fit(dp, body[0], mesh) is not None
    if name in ("k", "v"):                            # [B, T, kvh, dh]
        kvh_ok = len(body) > 2 and _fit("model", body[2], mesh) is not None
        if b_ok and kvh_ok:
            return with_lead([dp, None, "model", None])
        if b_ok:                                      # few kv heads (GQA):
            return with_lead([dp, "model", None, None])   # T over model
        if kvh_ok:
            return with_lead([None, "data", "model", None])
        return with_lead([None, ("data", "model"), None, None])
    if name == "latent":                              # [B, T, r]
        if b_ok:
            return with_lead([dp, None, "model"])
        return with_lead([None, "data", "model"])
    if name == "k_rope":                              # [B, T, dr]
        if b_ok:
            return with_lead([dp, "model", None])
        return with_lead([None, "data", None])
    if name == "C":                                   # mLSTM [B, h, dh, dh]
        return with_lead([dp, None, "model", None] if b_ok
                         else [None, None, "model", None])
    if name in ("n", "conv"):                         # [B,h,dh] / [B,K-1,di]
        return with_lead([dp, None, "model"] if b_ok
                         else [None, None, "model"])
    if name == "ssm":                                 # mamba [B, di, n]
        return with_lead([dp, "model", None] if b_ok
                         else [None, "model", None])
    if name in ("m", "c", "h"):                       # [B, h] / sLSTM [B, D]
        return with_lead([dp, "model"] if b_ok else [None, "model"])
    if name in ("len", "pos", "step"):
        return (None,) * len(shape)
    if body:                                          # batch-first
        return with_lead([dp if b_ok else None] + [None] * (len(body) - 1))
    return (None,) * len(shape)


def cache_specs(cache: dict, mesh, cfg) -> dict:
    """The port cache's specs (``lm.init_cache``'s tree: ``pos`` and one
    dict a layer), each per-layer leaf's the reference's stacked leaf's
    with the layer entry dropped; an integer leaf (``pos``, ``len``)
    ``()``."""
    start = _first_stacked(cfg)

    def leaf(t, sub: str, layer: int | None):
        shape = tuple(getattr(t, "shape", ()))
        if layer is None:
            return cache_spec(sub, shape, mesh, cfg)
        if not _uniform_scan(cfg):
            return cache_spec(f"layers/{layer}/{sub}", shape, mesh, cfg)
        if layer < start:
            return cache_spec(f"block0/{sub}", shape, mesh, cfg)
        stacked = (cfg.n_layers - start,) + shape
        return cache_spec(f"blocks/{sub}", stacked, mesh, cfg)[1:]

    def walk(t, sub: str, layer: int | None):
        if isinstance(t, dict):
            return {k: walk(v, f"{sub}{k}/" if isinstance(v, dict)
                            else f"{sub}{k}", layer) for k, v in t.items()}
        return leaf(t, sub, layer)

    out = {k: walk(v, k, None) for k, v in cache.items() if k != "layers"}
    out["layers"] = [walk(t, "", i) for i, t in enumerate(cache["layers"])]
    return out


def opt_v_specs(specs: dict, shapes: dict, factored: bool) -> dict:
    """The second moment's specs: the parameters', or for a factored
    leaf ``{"r": spec without its last entry, "c": spec without its
    second to last}``."""
    if not factored:
        return dict(specs)

    def one(spec: tuple, shape) -> Any:
        shape = tuple(getattr(shape, "shape", shape))
        if len(shape) < 2 or shape[-1] <= 1 or shape[-2] <= 1:
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        return {"r": tuple(parts[:-1]), "c": tuple(parts[:-2] + [parts[-1]])}

    return {n: one(s, shapes[n]) for n, s in specs.items()}


# ---------------------------------------------------------------------------
# placement on a mesh of ranks
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: tuple, mesh) -> tuple[str, ...]:
    """The axes ``spec`` names, in mesh order."""
    named = {a for e in spec for a in _axes(e)}
    return tuple(a for a in mesh.axis_names if a in named)


def split_leaves(specs: dict, mesh) -> dict:
    """``{name: the axes its spec names, in mesh order}`` of the leaves
    held in part under ``mesh``.  A spec naming an axis of size 1 counts:
    the gradient sums follow the layout, whatever the axes' sizes."""
    out = {}
    for n, spec in (specs or {}).items():
        axes = spec_axes(spec, mesh)
        if axes:
            out[n] = axes
    return out


def local_shape(spec: tuple, shape, mesh) -> tuple[int, ...]:
    """The shape of a rank's shard of a leaf of ``shape`` (reads only
    ``mesh.shape``)."""
    out = []
    for d, n in enumerate(shape):
        k = 1
        for a in _axes(spec[d] if d < len(spec) else None):
            k *= mesh.shape[a]
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {spec[d]} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


def global_shape(spec: tuple, local, mesh) -> tuple[int, ...]:
    """The whole shape of a leaf whose shard by ``spec`` has shape
    ``local``."""
    out = []
    for d, n in enumerate(local):
        for a in _axes(spec[d] if d < len(spec) else None):
            n *= mesh.shape[a]
        out.append(n)
    return tuple(out)


def shard_slices(spec: tuple, shape, mesh) -> tuple[slice, ...]:
    """This rank's block of a leaf of ``shape``: on each dimension the
    block of its index over the dimension's axes, the first axis major."""
    local = local_shape(spec, shape, mesh)
    out = []
    for d, n in enumerate(local):
        axes = _axes(spec[d] if d < len(spec) else None)
        i = mesh.index(axes) if axes else 0
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def _dim_order(t: torch.Tensor) -> list[int]:
    """The dimensions of ``t`` from the outermost in memory."""
    return sorted(range(t.dim()), key=lambda i: (-t.stride(i), i))


def _laid_out_like(like: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose dimensions lie in memory in ``like``'s
    order (a transposed leaf, such as ``unembed``, stays transposed)."""
    order = _dim_order(like)
    inv = [order.index(i) for i in range(t.dim())]
    out = torch.empty([t.shape[i] for i in order], dtype=t.dtype,
                      device=t.device).permute(inv)
    return out.copy_(t)


def shard(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the whole leaf ``x`` by ``spec``, in ``x``'s
    memory order; ``x`` itself where the shard is all of it."""
    sl = shard_slices(spec, x.shape, mesh)
    if all(s.stop - s.start == n for s, n in zip(sl, x.shape)):
        return x
    return _laid_out_like(x, x[sl])


def gather_spec(spec: tuple, mesh, keep: tuple[str, ...] = ()) -> tuple:
    """The part of ``spec`` that a use of the leaf gathers: each entry
    without the axes in ``keep`` (a routed expert's EP axes, which the
    dispatch serves in place), None where its axes' sizes multiply to 1.
    An entry ``keep`` covers in part raises."""
    out = []
    for e in spec:
        axes = _axes(e)
        left = tuple(a for a in axes if a not in keep)
        if left and len(left) != len(axes):
            raise ValueError(f"spec entry {e} is kept in part: {keep}")
        size = 1
        for a in left:
            size *= mesh.shape[a]
        out.append(left if size > 1 else None)
    return tuple(out)


_MLP_LEAVES = (".mlp.w_gate", ".mlp.w_up", ".mlp.w_down", ".moe.shared.w_gate",
               ".moe.shared.w_up", ".moe.shared.w_down")
_ATTN_LEAVES = (".attn.wq", ".attn.wk", ".attn.wv", ".attn.wo")
_MLA_LEAVES = (".attn.wq_a", ".attn.wq_b", ".attn.wkv_a", ".attn.wkv_b",
               ".attn.wo")
_MAMBA_LEAVES = (".mamba.w_in", ".mamba.conv", ".mamba.log_a", ".mamba.w_out")
_XLSTM_LEAVES = (".mlstm.w_up", ".mlstm.wq", ".mlstm.wk", ".mlstm.wv",
                 ".mlstm.w_ifo", ".mlstm.w_down", ".slstm.w_in",
                 ".slstm.w_down")


def attention_split(cfg, mesh) -> str | None:
    """How a GQA layer splits over ``model`` (reads only ``mesh.shape``):

    * ``"heads"`` where ``m = mesh.shape["model"]`` divides both head
      counts (each rank its ``h/m`` q and ``kvh/m`` kv heads);
    * ``"replicate"`` where ``m`` divides ``n_heads`` and ``n_kv_heads``
      divides ``m`` (each rank its ``h/m`` q heads and the one kv head they
      read, Megatron's KV replication; its cache every kv head of its
      block of ``T``, :func:`local_cache_rows`);
    * ``"positions"`` on any other ``m > 1`` where ``m`` divides the
      projections' widths ``h dh`` and ``kvh dh`` (Qwen2.5-14B's 40 heads
      and Hymba's 25 on 16): each rank computes its ``1/m`` of the columns
      of ``wq``, ``wk`` and ``wv`` and all-gathers them, attends for its
      query rows (:func:`position_blocks`) in a prefill or in training and
      over its block of the cache's ``T`` (:func:`local_cache_rows`) in a
      decode step, and ends in its ``1/m`` of ``wo``'s rows and one sum
      (``layers.Attention``);
    * else None: the layer runs whole.

    The dense, MoE and hybrid families' GQA attention splits this way
    (Hymba's is the same layer with a window; MLA: :func:`mla_split`)."""
    m = mesh.shape.get("model")
    if m is None or cfg.family not in ("dense", "moe", "hybrid") \
            or cfg.mla is not None:
        return None
    if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0:
        return "heads"
    if cfg.n_heads % m == 0 and m % cfg.n_kv_heads == 0:
        return "replicate"
    qh, kvh = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    return "positions" if m > 1 and qh % m == 0 and kvh % m == 0 else None


def position_blocks(s: int, m: int) -> list[tuple[tuple[int, int], ...]]:
    """The query rows each of ``m`` ``model`` ranks attends for in a
    prefill or a training step of ``s`` positions under the
    ``"positions"`` split: ``s`` cut at ``floor(i s / 2m)`` into ``2m``
    blocks (their sizes differ by at most one; none is dropped), rank
    ``r`` given blocks ``r`` and ``2m - 1 - r``.  Under a causal mask each
    rank then attends for as many query-key pairs as every other (exactly
    where ``2m`` divides ``s``): a block's pairs grow with its end, and
    the two ends of a rank's blocks add up alike.  ``[((a, b), (c, d)),
    ...]`` a rank, in rank order."""
    cut = [i * s // (2 * m) for i in range(2 * m + 1)]
    return [((cut[r], cut[r + 1]), (cut[2 * m - 1 - r], cut[2 * m - r]))
            for r in range(m)]


def mla_split(cfg, mesh) -> bool:
    """Whether an MLA layer splits its heads over ``model`` (reads only
    ``mesh.shape``): where ``m = mesh.shape["model"]`` divides ``n_heads``.
    Each rank then computes its ``h/m`` heads from its columns of ``wq_b``
    and ``wkv_b`` and its rows of ``wo``, and its ``1/m`` of the two
    down-projections ``wq_a`` and ``wkv_a``, whose outputs it all-gathers
    (``layers.MLA``); its latent cache holds the rank's block of ``T``
    (:func:`local_cache_rows`)."""
    m = mesh.shape.get("model")
    return cfg.mla is not None and m is not None and cfg.n_heads % m == 0


def mixer_split(cfg, mesh) -> bool:
    """Whether a hybrid's or an xLSTM model's mixer splits over ``model``
    (reads only ``mesh.shape``):

    * Hymba's Mamba head, where ``m = mesh.shape["model"]`` divides its
      ``di`` channels: each rank computes its ``2 di / m`` columns of
      ``w_in``, all-gathers them and takes its ``di / m`` channels of ``x``
      and of ``z``; it keeps those channels of ``conv`` and ``log_a``, takes
      them of the whole ``d_skip`` and the rows of the whole ``w_bcdt``
      (whose partial product it sums over ``model``), scans them, and ends
      in ``w_out``'s rows and one sum;
    * the xLSTM mixers on any ``model`` axis: each in-projection (mLSTM's
      ``w_up``, ``wq``, ``wk``, ``wv``, ``w_ifo``; sLSTM's ``w_in``) on its
      ``model`` columns where its spec names ``model``, the output
      all-gathered; the core (the mLSTM chunks and state, the sLSTM
      recurrence over the whole ``w_rec``) whole on every rank; the
      down-projection ``w_down`` on its ``model`` rows, then one sum.

    Where it is False the mixer runs whole (its leaves gathered)."""
    m = mesh.shape.get("model")
    if m is None or cfg.ssm is None:
        return False
    if cfg.family == "ssm":
        return True
    return cfg.family == "hybrid" and (cfg.d_model * cfg.ssm.expand) % m == 0


def kv_head_of(rank: int, m: int, n_kv_heads: int) -> int:
    """The kv head that the q heads of ``model`` rank ``rank`` read under
    KV replication (``n_kv_heads`` dividing ``m``): ``rank // (m /
    n_kv_heads)``."""
    return rank // (m // n_kv_heads)


def kept_axes(name: str, spec: tuple, mesh, cfg) -> tuple[str, ...]:
    """The axes of ``spec`` that the module of the port's parameter
    ``name`` consumes in place, so that a forward under ``mesh`` does not
    gather the leaf over them (a pure function of its arguments; reads only
    ``mesh.shape``):

    * a routed expert: its EP axes (``ep_axes_for``), where the dispatch
      is not gspmd (the dispatch brings the tokens to the experts);
    * ``model``, where the spec names it, for the tensor-parallel leaves:
      an MLP's (a dense FFN's, a MoE model's layer-0 FFN and shared
      experts) ``w_gate`` / ``w_up`` (column-parallel) and ``w_down``
      (row-parallel); a GQA layer's ``wq`` and ``wo`` where
      :func:`attention_split` splits its heads, and ``wk`` / ``wv`` where
      it splits the kv heads too (under KV replication they are gathered
      whole and the rank takes its kv head's columns); an MLA layer's
      ``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b`` (column-parallel) and ``wo``
      (row-parallel) where :func:`mla_split` splits its heads; a GQA
      layer's ``wq``, ``wk``, ``wv`` and ``wo`` where it splits by
      positions (each rank its ``1/m`` of their columns and rows); a hybrid's
      Mamba ``w_in``, ``conv``, ``log_a`` and ``w_out``, and the xLSTM
      mixers' ``w_up``, ``wq``, ``wk``, ``wv``, ``w_ifo``, ``w_in`` and
      ``w_down``, where :func:`mixer_split` splits them; the embedding (its
      ``d`` slice; not where it is tied to the unembedding) and the
      unembedding (its vocabulary slice).

    Every other leaf (sLSTM's ``w_rec``, Mamba's ``w_bcdt`` and ``d_skip``,
    of which the module takes its rows, the router, the norms, the biases)
    is gathered whole."""
    named = {a for e in spec for a in _axes(e)}
    if ".moe.experts." in name:
        if cfg.moe.dispatch == "gspmd":
            return ()
        return tuple(a for a in ep_axes_for(mesh) if a in named)
    if "model" not in named:
        return ()
    if cfg.mla is not None and name.endswith(_MLA_LEAVES):
        return ("model",) if mla_split(cfg, mesh) else ()
    if name.endswith(_MAMBA_LEAVES + _XLSTM_LEAVES):
        return ("model",) if mixer_split(cfg, mesh) else ()
    if name == "embed":
        return () if cfg.tie_embeddings else ("model",)
    if name == "unembed" or name.endswith(_MLP_LEAVES):
        return ("model",)
    if name.endswith(_ATTN_LEAVES):
        split = attention_split(cfg, mesh)
        if split is None or (split == "replicate"
                             and name.endswith((".wk", ".wv"))):
            return ()
        return ("model",)
    return ()


def _attn_name(cfg, layer: int) -> str:
    """The port's name of attention layer ``layer``'s ``wq`` (a hybrid
    block's attention is its mixer's)."""
    return f"blocks.{layer}.{'mixer.' if cfg.family == 'hybrid' else ''}attn.wq"


def _attn_kept(cfg, mesh, layer: int, specs: dict | None) -> bool:
    """Whether attention layer ``layer``'s ``wq`` is kept as its ``model``
    shard (by ``specs``, the model's, else by the rules)."""
    name = _attn_name(cfg, layer)
    spec = specs.get(name) if specs is not None else leaf_spec(
        name, (cfg.d_model, cfg.n_heads * cfg.d_head), mesh, cfg)
    return spec is not None and "model" in kept_axes(name, spec, mesh, cfg)


def local_kv_heads(cfg, mesh, layer: int, max_len: int,
                   specs: dict | None = None) -> int:
    """The kv heads a rank's cache of attention layer ``layer`` (of
    ``max_len`` positions) holds under ``mesh``: ``n_kv_heads / m`` where
    the layer splits its kv heads; under KV replication every kv head of
    the rank's block of ``T`` (:func:`local_cache_rows`), or where ``m``
    does not divide ``max_len`` the one kv head its q heads read, for all
    of ``T``; all of them where it runs whole or splits by positions (by
    ``specs``, the model's, else by the rules; reads only ``mesh.shape``).
    A hybrid block's attention is its mixer's
    (``blocks.{layer}.mixer.attn.wq``)."""
    if not _attn_kept(cfg, mesh, layer, specs) \
            or attention_split(cfg, mesh) == "positions":
        return cfg.n_kv_heads
    m = mesh.shape["model"]
    if cfg.n_kv_heads % m == 0:
        return cfg.n_kv_heads // m
    return cfg.n_kv_heads if local_cache_rows(
        cfg, mesh, layer, max_len, specs) is not None else 1


def _mla_kept(cfg, mesh, layer: int, specs: dict | None) -> bool:
    """Whether MLA layer ``layer``'s ``wkv_b`` is kept as its ``model``
    shard (by ``specs``, the model's, else by the rules)."""
    m = cfg.mla
    name = f"blocks.{layer}.attn.wkv_b"
    spec = specs.get(name) if specs is not None else leaf_spec(
        name, (m.kv_lora_rank, cfg.n_heads * (m.nope_head_dim
                                              + m.v_head_dim)), mesh, cfg)
    return spec is not None and "model" in kept_axes(name, spec, mesh, cfg)


def local_cache_rows(cfg, mesh, layer: int, max_len: int,
                     specs: dict | None = None) -> tuple[int, int] | None:
    """``(t0, rows)``: the positions ``[t0, t0 + rows)`` of a ``max_len``
    cache that this rank's cache of layer ``layer`` holds, or None for all
    of them.  A block where ``model`` (of more than one rank) splits the
    layer and :func:`cache_spec` puts ``T`` on it: a GQA layer split by
    positions or under KV replication, whose kv heads do not divide
    ``model`` (the entry on ``T`` of the layer's ``k``), and an MLA layer
    whose heads split (:func:`mla_split`; the entry on ``T`` of its
    ``k_rope``, the latent's rows laid out alike: the reference splits the
    latent's ``r``, the same bytes).  ``t0`` is the rank's ``model``
    coordinate times ``max_len / m``; all of ``T`` where ``m`` does not
    divide ``max_len``.  The batch is taken as split over ``("pod",
    "data")``: where the reference's batch does not divide them its spec
    names ``data`` on ``T``, and the port keeps the ``data`` part as it
    holds the rows, on every rank, and splits ``T`` over ``model`` alone
    (by ``specs``, the model's, else by the rules)."""
    m = mesh.shape.get("model", 1)
    if m == 1:
        return None
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh.shape.get(a, 1)
    if cfg.mla is not None:
        if not mla_split(cfg, mesh) or not _mla_kept(cfg, mesh, layer, specs):
            return None
        spec = cache_spec(f"layers/{layer}/k_rope",
                          (dp, max_len, cfg.mla.rope_head_dim), mesh, cfg)
    else:
        if attention_split(cfg, mesh) not in ("positions", "replicate") \
                or not _attn_kept(cfg, mesh, layer, specs):
            return None
        spec = cache_spec(f"layers/{layer}/k", (dp, max_len, cfg.n_kv_heads,
                                                cfg.d_head), mesh, cfg)
    if "model" not in _axes(spec[1]):
        return None
    rows = max_len // m
    return mesh.coord("model") * rows, rows


def local_channels(cfg, mesh, layer: int, specs: dict | None = None) -> int:
    """The Mamba channels a rank's state of hybrid layer ``layer`` holds
    under ``mesh``: ``di / m`` where the head splits them
    (:func:`mixer_split`), else all ``di`` (by ``specs``, the model's,
    else by the rules; reads only ``mesh.shape``)."""
    di = cfg.d_model * cfg.ssm.expand
    name = f"blocks.{layer}.mixer.mamba.conv"
    spec = specs.get(name) if specs is not None else leaf_spec(
        name, (cfg.ssm.conv_dim, di), mesh, cfg)
    if spec is None or "model" not in kept_axes(name, spec, mesh, cfg):
        return di
    return di // mesh.shape["model"]


class _Gather(torch.autograd.Function):
    """The whole leaf from this rank's shard: a tiled all-gather on each
    split dimension in order; backward, the tiled reduce-scatter of each
    in reverse order (the sum over the dimension's axes, this rank's
    block kept)."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.args = (spec, mesh)
        out = x
        for d, axes in enumerate(spec):
            if axes:
                out = meshops._all_gather(out, mesh, axes, d)
        return out if _dim_order(out) == _dim_order(x) \
            else _laid_out_like(x, out)

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.args
        for d in reversed(range(len(spec))):
            if spec[d]:
                g = meshops._scatter_sum(g, mesh, spec[d], d)
        return g, None, None


def gather(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from this rank's shard ``x``, ``spec`` a
    :func:`gather_spec` (every entry a tuple of axes of size over 1, or
    None): one all-gather a split dimension through ``meshops`` (counted),
    the result in ``x``'s memory order; its gradient returns as a
    reduce-scatter.  With nothing to gather, ``x`` itself: no copy, no
    collective, the identity's gradient."""
    if not any(spec):
        return x
    return _Gather.apply(x, spec, mesh)


def to_placements(spec: tuple, mesh) -> tuple:
    """``spec`` as ``torch.distributed.tensor`` placements, one a mesh
    axis: ``Shard(d)`` for an axis that splits dimension ``d``, else
    ``Replicate()``.  Consecutive ``Shard(d)`` linearise the first mesh
    axis major, as JAX does a tuple of axes; a tuple out of mesh order
    raises (it is not reordered)."""
    from torch.distributed.tensor import Replicate, Shard
    dims: dict = {}
    for d, e in enumerate(spec):
        axes = _axes(e)
        for a in axes:
            if a not in mesh.shape:
                raise KeyError(f"no axis {a!r} in mesh {mesh.shape}")
            if a in dims:
                raise ValueError(f"axis {a!r} twice in spec {spec}")
            dims[a] = d
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e} is out of mesh order "
                             f"{mesh.axis_names}")
    return tuple(Shard(dims[a]) if a in dims else Replicate()
                 for a in mesh.axis_names)


def global_view(x: torch.Tensor, spec: tuple, mesh):
    """A ``DTensor`` whose local tensor is this rank's shard ``x``
    (``run_check=False``: nothing is exchanged)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh.device_mesh, to_placements(spec, mesh),
                              run_check=False)


def with_shardings(tree, specs, mesh):
    """Stand-ins of a tree of tensors (whole shapes and dtypes, any
    device): each leaf a ``DTensor`` over a meta tensor of the rank's
    local shape, placed by its spec in ``specs`` (a tree of the same
    keys; a factored moment's ``{"r", "c"}`` of specs matches its
    dict)."""
    if not isinstance(tree, (dict, list, torch.Tensor)):
        return tree                       # an integer leaf (a cache's len)
    if isinstance(specs, tuple):
        local = torch.empty(local_shape(specs, tree.shape, mesh),
                            dtype=tree.dtype, device="meta")
        return global_view(local, specs, mesh)
    if isinstance(tree, list):
        return [with_shardings(t, s, mesh) for t, s in zip(tree, specs)]
    return {k: with_shardings(v, specs[k], mesh) for k, v in tree.items()}
