"""AdamW with decoupled weight decay, cosine schedule and global-norm clipping.

Counterpart of ``repro.optim.adamw``: plain functions over dicts of tensors
keyed as ``model.named_parameters()`` keys them (``"blocks.0.attn.wq"``),
not an ``nn.Module`` optimizer.  ``torch.optim.AdamW`` would keep bf16 state
for bf16 parameters, do its math in bf16 and apply the steps in another
order; this module follows the reference's arithmetic instead, in float32
tensors: clip by the global norm (each gradient cast back to its dtype
after scaling), the cosine schedule with warmup, the bias corrections
``1 - b ** step`` in float32, decoupled decay under :func:`_decay_mask`,
optional bf16 moments (the math stays float32, cast on store) and a
factored second moment.  There are no master weights: the update is
computed in float32 and cast to the parameter's dtype.

:func:`adamw_update` writes the new parameters and moments into the tensors
it is given, as the reference's jitted step donates both buffers
(``donate_argnums=(0, 1)``): a full-width model has no room for a second
copy.  A leaf's update runs over slices of at most ``CHUNK`` elements, each
element's chain of operations unchanged, so that its float32 temporaries
stay small.

Under a mesh every leaf is this rank's shard by its spec
(``launch.shardings``), and so are its gradient, already summed over the
mesh, and its moments.  The global norm sums each leaf's squares over the
axes its spec names (each replicated leaf counts once), so that every rank
clips by the reference's norm and the replicas stay equal; a factored
second moment sums its row and column means over the axes that split the
dimension they reduce.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import meshops
from repro_torch.launch.shardings import split_leaves

F32 = torch.float32
CHUNK = 1 << 25            # elements per slice of a leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # bf16 moments halve the optimizer's memory; the update math stays
    # float32 (cast on store only)
    moment_dtype: str = "float32"
    # Adafactor-style factored second moment for >= 2-D leaves: v ~ r (x) c
    # / mean(r), O(d_in + d_out) in place of O(d_in * d_out)
    factored_v: bool = False


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * lr``, float32."""
    step = torch.as_tensor(step).to(F32)
    dev = step.device
    warm = torch.minimum(_f32(1.0, dev),
                         step / _f32(max(1.0, cfg.warmup_steps), dev))
    prog = torch.clamp((step - _f32(cfg.warmup_steps, dev))
                       / _f32(max(1.0, cfg.total_steps - cfg.warmup_steps),
                              dev), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * prog))
    frac = _f32(cfg.min_lr_frac, dev) + _f32(1.0 - cfg.min_lr_frac, dev) * cos
    return _f32(cfg.lr, dev) * warm * frac


def _can_factor(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def init_opt_state(params: dict, moment_dtype: str = "float32",
                   factored_v: bool = False) -> dict:
    """``{"m": {name: zeros}, "v": {name: zeros, or {"r", "c"} float32 when
    factored}, "step": 0-dim int32}`` on the parameters' device."""
    dt = getattr(torch, moment_dtype)
    dev = next(iter(params.values())).device if params else None

    def v_for(p):
        if factored_v and _can_factor(p.shape):
            # the factors stay float32 (they are small); m keeps moment_dtype
            return {"r": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                     device=p.device)}
        return torch.zeros_like(p, dtype=dt)    # p's strides

    return {"m": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
            "v": {k: v_for(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict, *, mesh=None,
                split: dict | None = None) -> torch.Tensor:
    """The float32 norm of every leaf together (each leaf's sum of squares
    first, then their sum).  Under ``mesh``, ``split`` maps the name of a
    leaf that is this rank's shard to the axes it is split over
    (``shardings.split_leaves``): the shards' squares are summed over
    those axes (one all-reduce an axis set), and every other leaf counts
    once."""
    split = split or {}

    def sq(x):
        return x.detach().float().square().sum()
    whole = [sq(x) for k, x in tree.items() if k not in split]
    total = torch.stack(whole).sum() if whole else torch.zeros(
        (), dtype=F32, device=next(iter(tree.values())).device)
    parts: dict = {}
    for k, axes in split.items():
        parts.setdefault(tuple(axes), []).append(sq(tree[k]))
    for axes, sums in parts.items():
        total = total + meshops.psum(torch.stack(sums).sum(), mesh, axes)
    return total.sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(_f32(1.0, norm.device),
                         _f32(max_norm, norm.device) / (norm + _f32(1e-9, norm.device)))


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """``({name: g * scale cast back to g's dtype}, norm)`` with ``scale =
    min(1, max_norm / (norm + 1e-9))``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


_NO_DECAY_SUBSTRINGS = ("norm", "ln1", "ln2", "bias", "b_ifo", "bq", "bk", "bv",
                        "scale", "dt_bias", "d_skip")


def _decay_mask(params: dict) -> dict:
    """``{name: True where weight decay applies}``: not for a name holding
    one of the reference's substrings, nor for a leaf of at most one
    dimension."""
    def decays(name: str, p: torch.Tensor) -> bool:
        low = name.lower()
        return not (any(s in low for s in _NO_DECAY_SUBSTRINGS)
                    or p.dim() <= 1)

    return {k: decays(k, p) for k, p in params.items()}


def _slices(n: int):
    for start in range(0, n, CHUNK):
        yield slice(start, min(n, start + CHUNK))


def _entry(spec: tuple, d: int) -> tuple:
    """The axes of ``spec``'s entry for dimension ``d`` (negative)."""
    e = spec[d] if len(spec) >= -d else None
    return () if e is None else e if isinstance(e, tuple) else (e,)


def _mean(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """``x.mean(dim)``, the dimension split over ``axes`` of ``mesh``:
    the local sum summed over them, over the whole length."""
    if not axes:
        return x.mean(dim)
    return meshops.psum(x.sum(dim), mesh, axes) / (
        x.shape[dim] * mesh.axis_size(axes))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 state: dict, *, mesh=None,
                 specs: dict | None = None) -> tuple[dict, dict, dict]:
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``, the
    parameters and the state updated in place (the same dicts).  Each
    gradient is clipped, used and released in turn (``grads`` is
    emptied).  Each moment must lie in its parameter's layout, as
    :func:`init_opt_state` makes it.  Under ``mesh`` the gradients are
    already summed over the mesh, and ``specs`` (the model's) places each
    leaf (:func:`global_norm`; the factored moment's means)."""
    specs = specs if mesh is not None else None
    norm = global_norm(grads, mesh=mesh, split=split_leaves(specs, mesh)
                       if specs else None)
    dev = norm.device
    scale = _clip_scale(norm, cfg.grad_clip)
    state["step"] = state["step"] + 1
    step = state["step"].to(F32)
    lr = cosine_schedule(cfg, step)
    b1t = 1.0 - _f32(cfg.b1, dev) ** step
    b2t = 1.0 - _f32(cfg.b2, dev) ** step
    decay = _decay_mask(params)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)

    def clipped(g):
        return (g.float() * scale).to(g.dtype).float()

    def new_p(p, mh, vh, dmask):
        p32 = p.float()
        delta = mh / (torch.sqrt(vh) + eps) + wd * dmask * p32
        return (p32 - lr * delta).to(p.dtype)

    def step_of(p, g, m, v, dmask):
        """The unfactored update of one leaf (or slice): the new values
        of p, m and v in their dtypes."""
        g32 = clipped(g)
        m2 = b1 * m.float() + c1 * g32
        v2 = b2 * v.float() + c2 * torch.square(g32)
        return (new_p(p, m2 / b1t, v2 / b2t, dmask), m2.to(m.dtype),
                v2.to(v.dtype))

    for name, p in params.items():
        g = grads.pop(name)
        m, v = state["m"][name], state["v"][name]
        dmask = _f32(1.0 if decay[name] else 0.0, dev)
        if isinstance(v, dict):                       # factored second moment
            spec = (specs or {}).get(name, ())
            last, second = (_entry(spec, d) for d in (-1, -2))
            g32 = clipped(g)
            m2 = b1 * m.float() + c1 * g32
            g2 = torch.square(g32)
            r2 = b2 * v["r"] + c2 * _mean(g2, -1, last, mesh)
            c2_ = b2 * v["c"] + c2 * _mean(g2, -2, second, mesh)
            r_mean = _mean(r2, -1, second, mesh)[..., None]
            vh = (r2[..., :, None] * c2_[..., None, :]
                  / torch.clamp(r_mean[..., None], min=1e-30)) / b2t
            p.copy_(new_p(p, m2 / b1t, vh, dmask))
            m.copy_(m2.to(m.dtype))
            v["r"].copy_(r2)
            v["c"].copy_(c2_)
            continue
        # flat views in p's storage order (a transposed parameter, such as
        # ``unembed``, is walked as it lies in memory), updated by slice
        perm = sorted(range(p.dim()), key=lambda i: -p.stride(i))
        flat = [t.permute(perm) for t in (p, m, v)]
        if not all(t.is_contiguous() for t in flat):
            raise ValueError(f"{name}: the moments must share the "
                             f"parameter's layout (init_opt_state's)")
        pf, mf, vf = (t.view(-1) for t in flat)
        gf = g.permute(perm).reshape(-1)
        for sl in _slices(gf.numel()):
            pf[sl], mf[sl], vf[sl] = step_of(pf[sl], gf[sl], mf[sl], vf[sl],
                                             dmask)
        del g, gf
    return params, state, {"grad_norm": norm, "lr": lr}
