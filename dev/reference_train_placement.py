"""The JAX package's ``train()`` against its own replicated step, on the
CPU over 8 forced host devices.

``repro.launch.train.train(arch, mesh=...)`` places the parameters with
``param_specs`` before it jits ``make_train_step``.  This script runs it on
a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh for three SMOKE steps and
beside it the same step jitted under ``with mesh:`` with the parameters
replicated (the form ``tests/test_distributed.py`` runs and the port's
mesh training is held to), from the same ``init_lm`` weights on the same
``batch_at(n)`` batches, and prints each step's loss and gradient norm from
both with their relative differences.  It needs jax and no card:

    PYTHONPATH=src JAX_PLATFORMS=cpu python dev/reference_train_placement.py
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticLMDataset  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.shardings import ep_axes_for  # noqa: E402
from repro.launch.steps import Recipe, make_train_step  # noqa: E402
from repro.launch.train import train  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.optim import AdamWConfig, init_opt_state  # noqa: E402

ARCHS = ("deepseek-v2-236b", "qwen3-moe-235b-a22b")
KW = dict(smoke=True, steps=3, global_batch=8, seq_len=16, n_micro=2,
          lr=1e-2, seed=0)


def replicated(arch: str, mesh) -> list[dict]:
    """``train()``'s loop with the parameters left replicated."""
    cfg = get_config(arch, smoke=True)
    ocfg = AdamWConfig(lr=KW["lr"], total_steps=max(KW["steps"], 2),
                       warmup_steps=max(1, KW["steps"] // 10))
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=KW["seq_len"],
                                       global_batch=KW["global_batch"],
                                       seed=KW["seed"]))
    out = []
    with mesh:
        params = lm.init_lm(jax.random.key(KW["seed"]), cfg)
        opt = init_opt_state(params)
        step = jax.jit(make_train_step(cfg, ocfg, ep_axes_for(mesh), Recipe(
            n_micro=KW["n_micro"], lr=KW["lr"])))
        for n in range(KW["steps"]):
            batch = {k: jnp.asarray(v) for k, v in ds.batch_at(n).items()}
            params, opt, m = step(params, opt, batch)
            out.append({k: float(v) for k, v in m.items()})
    return out


def main() -> int:
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    for arch in sys.argv[1:] or ARCHS:
        placed = train(arch, mesh=mesh, log_every=KW["steps"], **KW)
        for n, (a, b) in enumerate(zip(placed["history"],
                                       replicated(arch, mesh))):
            print(f"{arch} step {n}: train() loss {a['loss']!r} grad_norm "
                  f"{a['grad_norm']!r}; replicated loss {b['loss']!r} "
                  f"grad_norm {b['grad_norm']!r}; relative "
                  f"{abs(a['loss'] / b['loss'] - 1):.3e}, "
                  f"{abs(a['grad_norm'] / b['grad_norm'] - 1):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
