"""How far a model's gradients move between dtypes at full width, on the
CPU: the comparison ``chip_smoke.py``'s training phases make on the card
(``_grad_check``), run here to set and explain their bounds.

For ``--arch`` cut to ``--layers`` layers at full width, the weights as
``lm.init_lm(cfg, seed)`` draws them (bf16), and one batch of 1 x ``--seq``
Markov tokens (``SyntheticLMDataset``, the seed's ``batch_at(0)``), it
prints for each seed the worst ``1 - cos`` and ``|norm ratio - 1|`` over
the parameters (one-element leaves apart, as ``norm_one``) and the loss's
relative difference, of the bf16 model's gradients against a float32
copy's and of the float32 copy's against a float64 copy's (the same
weights, cast); ``--leaves`` prints every leaf's.  ``--reference`` instead
carries the JAX package's ``init_lm`` weights into the port and prints,
leaf by leaf, ``1 - cos`` of the port's bf16 gradients and of the JAX
package's own bf16 gradients (``jax.value_and_grad`` of its
``train_loss``) against the port's float32 ones.  A MoE model's copies
route their own tokens.  No card; minutes at full width:

    PYTHONPATH=src python dev/grad_spread.py --arch xlstm-350m --layers 8 --seq 1024 --seeds 0 1 2
    PYTHONPATH=src JAX_PLATFORMS=cpu python dev/grad_spread.py --arch xlstm-350m --layers 8 --seq 1024 --reference
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch
from repro_torch.models import lm


def spread(a: dict, b: dict, la: float, lb: float) -> tuple[dict, dict]:
    """``(worst, per leaf)``: ``1 - cos`` and ``|norm ratio - 1|`` of
    gradients ``a`` against ``b`` in float64, the loss's relative
    difference."""
    worst = {"cos": (0.0, ""), "norm": (0.0, ""), "norm_one": (0.0, ""),
             "loss": (abs(la - lb) / abs(lb), "")}
    leaves = {}
    for n, y in b.items():
        x, y = a[n].double().flatten(), y.double().flatten()
        nx, ny = float(x.norm()), float(y.norm())
        c = 1.0 if nx == 0 or ny == 0 else 1 - float(x @ y) / (nx * ny)
        r = abs(nx / ny - 1) if ny else float(nx > 0)
        key = "norm_one" if y.numel() == 1 else "norm"
        worst["cos"] = max(worst["cos"], (c, n))
        worst[key] = max(worst[key], (r, n))
        leaves[n] = (c, r)
    return worst, leaves


def grads(model, batch) -> tuple[float, dict]:
    model.requires_grad_(True)
    loss = lm.train_loss(model, batch)
    names = [n for n, _ in model.named_parameters()]
    g = torch.autograd.grad(loss, list(model.parameters()),
                            allow_unused=True, materialize_grads=True)
    return float(loss.detach()), dict(zip(names, g))


def copy(model, cfg, dtype: str):
    out = lm.LM(dataclasses.replace(cfg, dtype=dtype), device="cpu")
    with torch.no_grad():
        for (_, p), (_, q) in zip(model.named_parameters(),
                                  out.named_parameters()):
            q.copy_(p)
    return out


def batch_of(cfg, seq: int, seed: int) -> dict:
    return make_global_batch(SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=1, seed=seed)).batch_at(
            0), "cpu")


def own(args, cfg) -> None:
    for seed in args.seeds:
        t0 = time.perf_counter()
        bf = lm.init_lm(cfg, seed=seed, device="cpu")
        batch = batch_of(cfg, args.seq, seed)
        l64, g64 = grads(copy(bf, cfg, "float64"), batch)
        l32, g32 = grads(copy(bf, cfg, "float32"), batch)
        l16, g16 = grads(bf, batch)
        for name, (w, leaves) in (("bf16 ~ float32", spread(g16, g32, l16,
                                                             l32)),
                                  ("float32 ~ float64", spread(g32, g64, l32,
                                                               l64))):
            print(f"{args.arch} seed {seed} {name}: {w}", flush=True)
            if args.leaves:
                for n, (c, r) in leaves.items():
                    print(f"  {n:40s} 1-cos {c:.3e} norm {r:.3e}")
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)


def reference(args, cfg) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config as ref_config
    from repro.models import lm as jlm
    from repro_torch.models.convert import (lm_params_from_reference,
                                            named_from_reference)

    rcfg = dataclasses.replace(ref_config(args.arch), n_layers=args.layers)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), rcfg))
    batch = batch_of(cfg, args.seq, 0)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jlm.train_loss(
        p, rcfg, jb)))(jax.tree.map(jnp.asarray, params))
    bf = lm_params_from_reference(cfg, params, device="cpu")
    l32, g32 = grads(copy(bf, cfg, "float32"), batch)
    l16, g16 = grads(bf, batch)
    gref = named_from_reference(bf, jax.tree.map(
        lambda a: np.asarray(a, np.float32), jg))
    _, port = spread(g16, g32, l16, l32)
    _, ref = spread(gref, g32, float(jl), l32)
    print(f"{args.arch} loss: float32 {l32!r}, port bf16 {l16!r}, "
          f"reference bf16 {float(jl)!r}")
    for n in g32:
        print(f"  {n:40s} 1-cos port bf16 {port[n][0]:.2e}, reference "
              f"bf16 {ref[n][0]:.2e}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    (reference if args.reference else own)(args, cfg)


if __name__ == "__main__":
    main()
