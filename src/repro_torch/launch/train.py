"""Training entry point of the port: checkpointed, restartable, journalled.

Counterpart of ``repro.launch.train``: the same loop, with the model's
parameters and the AdamW state as dicts of tensors, on one device or, with
``mesh=``, as one rank of a mesh (SPMD: every rank calls ``train`` with its
own mesh view).  It makes
the model (``lm.init_lm`` from ``seed``, or the caller's), makes it
trainable, restores the latest complete checkpoint of ``ckpt_dir`` if there
is one, replays the data from the restored step (batch ``n`` depends only
on ``(seed, n)``), runs :func:`repro_torch.launch.steps.make_train_step`
per step with the step's start and end journalled through a
``ShuffleManager``, saves asynchronously every ``ckpt_every`` steps and
waits for the last write at the end.  A training step runs no kernel of
the port: ``lm.train_loss`` takes the plain paths, which autograd
differentiates (the kernels have no backward).

Under a mesh each rank holds its shard of every parameter and moment by
the reference's sharding rules (the model placed on the mesh,
``launch.shardings``; the moments by ``opt_v_specs``), reads its own rows
of each batch (``data.rank_rows``) and runs the mesh's step
(``steps.make_train_step(..., mesh=mesh)``), so that every rank's shards
stay the reference's.  A checkpoint holds the reference's whole arrays:
each placed leaf is gathered over every dimension it is split on, one leaf
at a time, copied to rank 0's host memory, and rank 0 writes them; a
restore onto another mesh reads each rank's block of every leaf.  Only
rank 0 writes the ``ShuffleManager`` journal and the log.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b --smoke --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import flatten, to_host
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.manager import ShuffleManager
from repro_torch.core.plancache import PlanCache
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.device import check_device
from repro_torch.launch.shardings import (gather, gather_spec, global_shape,
                                         opt_v_specs, shard_slices)
from repro_torch.launch.steps import Recipe, make_train_step
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, init_opt_state


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _state_tree(model, opt_state) -> dict:
    return {"params": dict(model.named_parameters()), "opt_state": opt_state}


def _placed_paths(model, opt_state, mesh) -> dict:
    """``{checkpoint path: spec}`` of every parameter and moment under
    ``mesh`` (a factored moment's ``r`` and ``c`` each by its own);
    empty without a mesh."""
    if mesh is None:
        return {}
    whole = {n: global_shape(model.specs[n], p.shape, mesh)
             for n, p in model.named_parameters()}
    v = opt_v_specs(model.specs, whole, True)
    return flatten({"params": model.specs, "opt_state": {
        "m": model.specs, "v": {n: v[n] if isinstance(t, dict)
                                else model.specs[n]
                                for n, t in opt_state["v"].items()}}})


@torch.no_grad()
def _host_state(model, opt_state, mesh, placed: dict, lead: bool) -> dict:
    """Rank 0's host snapshot of the state as the reference holds it,
    ``{checkpoint path: to_host(leaf)}`` (empty on the other ranks): each
    placed leaf is gathered over every dimension it is split on and
    copied to the host before the next, so that a device holds one
    gathered leaf at a time.  Every rank must call it."""
    host = {}
    for p, x in flatten(_state_tree(model, opt_state)).items():
        if p in placed:
            x = gather(x, gather_spec(placed[p], mesh), mesh)
        if lead:
            host[p] = to_host(x)
    return host


def train(arch: str, *, smoke: bool = True, steps: int = 20,
          global_batch: int = 8, seq_len: int = 128,
          ckpt_dir: str | None = None, ckpt_every: int = 10, n_micro: int = 1,
          lr: float = 3e-4, log_every: int = 1, seed: int = 0,
          device="cuda", params: lm.LM | None = None, mesh=None) -> dict:
    """Train ``arch`` for ``steps`` steps (counted from 0, a restored run
    going on from its checkpoint's step): returns ``{"history": [{"loss",
    "grad_norm", "lr", "seconds"} per step run], "params": the model,
    "opt_state", "manager", "plan_cache": its stats}``.  ``params``
    defaults to :func:`lm.init_lm` of ``arch``'s config (``smoke`` picks
    SMOKE) with ``seed`` on ``device``; given ``params`` bring their own
    config (a model cut in depth), which must be ``arch``'s, and are
    trained in place.  ``seconds`` is each step's wall time, the
    device synchronised.

    With ``mesh`` (a mesh on ``device``'s type) this rank trains its part
    of the model over it: ``params`` (by default ``init_lm(...,
    mesh=mesh)``) are placed on that mesh, each batch is its rows
    (``global_batch`` must split into ``n_micro`` microbatches that divide
    over the batch axes), and ``loss`` and ``grad_norm`` are the global
    ones, the same on every rank."""
    dev = check_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh, device {dev}")
    if params is None:
        params = lm.init_lm(get_config(arch, smoke=smoke), seed=seed,
                            device=dev, mesh=mesh)
    model, cfg = params, params.cfg
    if cfg.name.removesuffix("-smoke") != arch:
        raise ValueError(f"params are a {cfg.name!r} model, not {arch!r}")
    if model.embed.device.type != dev.type:
        raise ValueError(f"params on {model.embed.device}, device {dev}")
    dev = model.embed.device
    lead = mesh is None or dist.get_rank() == 0
    recipe = Recipe(n_micro=n_micro, lr=lr)
    if mesh is not None and model.mesh_shape != dict(mesh.shape):
        raise ValueError(f"params are placed on {model.mesh_shape}, not "
                         f"on {dict(mesh.shape)}: build them with "
                         f"mesh={mesh}")
    ocfg = AdamWConfig(lr=lr, total_steps=max(steps, 2),
                       warmup_steps=max(1, steps // 10),
                       moment_dtype=recipe.moment_dtype)

    # the run's shuffle control plane: the loop journals step records
    # through it, and a shuffle service attached to it shares its PlanCache
    # (the training step itself shuffles nothing, so the cache's counters
    # stay zero unless such a service is wired in)
    manager = ShuffleManager(
        journal_path=f"{ckpt_dir}/shuffle_journal.jsonl"
        if ckpt_dir and lead else None,
        plan_cache=PlanCache(capacity=64))

    model.requires_grad_(True)
    named = dict(model.named_parameters())
    opt_state = init_opt_state(named, recipe.moment_dtype)

    placed = _placed_paths(model, opt_state, mesh)
    start_step = 0
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if ckpt and ckpt.latest() is not None:
        state = flatten(_state_tree(model, opt_state))
        tree, meta = ckpt.restore(_state_tree(model, opt_state), blocks={
            p: shard_slices(spec, global_shape(spec, state[p].shape, mesh),
                            mesh) for p, spec in placed.items()})
        src = flatten(tree)         # copied into the tensors in place,
        with torch.no_grad():       # so that their layouts stay
            for path, t in state.items():
                t.copy_(src[path])
        start_step = meta.get("step", ckpt.latest())
        if lead:
            print(f"[train] restored step {start_step} from {ckpt_dir}")

    dc = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                    global_batch=global_batch, seed=seed,
                    modality=cfg.modality, d_model=cfg.d_model)
    pipe = DataPipeline(dc, dev, start_step=start_step, mesh=mesh,
                        n_micro=recipe.n_micro)
    step_fn = make_train_step(cfg, ocfg, recipe, mesh=mesh)

    history = []
    t0 = time.time()
    _sync(dev)
    t_step = time.perf_counter()
    for step, batch in pipe:
        if step >= steps:
            break
        manager.record_start(0, step, "train_step")
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        _sync(dev)
        now = time.perf_counter()
        metrics["seconds"], t_step = now - t_step, now
        manager.record_end(0, step, "train_step")
        history.append(metrics)
        if step % log_every == 0 and lead:
            dt = (time.time() - t0) / max(1, len(history))
            print(f"[train] step={step} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} "
                  f"lr={metrics['lr']:.2e} {dt*1e3:.0f}ms/step", flush=True)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.wait()                   # one host snapshot at a time
            host = _host_state(model, opt_state, mesh, placed, lead)
            if lead:
                ckpt.write_async(step + 1, host,
                                 {"step": step + 1, "arch": arch})
            del host
    pipe.close()
    if ckpt:
        ckpt.wait()
        if mesh is not None:          # rank 0's last write is complete
            dist.barrier(group=mesh.group(mesh.axis_names).pg)
    return {"history": history, "params": model, "opt_state": opt_state,
            "manager": manager, "plan_cache": manager.plan_cache.stats()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-14b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                global_batch=args.batch, seq_len=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                n_micro=args.n_micro, lr=args.lr, device=args.device)
    losses = [h["loss"] for h in out["history"]]
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
