"""Serving entry point of the port: prefill a fresh KV cache, then greedy-decode.

Counterpart of ``repro.launch.serve``: on one device, or per rank over a
mesh (``mesh=``, :mod:`repro_torch.launch.mesh`), where each rank holds
its shard of every parameter (``launch.shardings``), serves the rows of
its ``("pod", "data")`` coordinate (all of them where the batch does not
divide), a MoE model's blocks dispatch over the EP axes
(``teshu`` / ``teshu2``, :mod:`repro_torch.models.moe`) and every rank
returns the tokens of the whole batch.  The prompts are the reference's
(``np.random.default_rng(seed)`` integers), so the same weights give the
same tokens in both packages.  On the card the
prefill's attention runs the flash kernel and every decode step the decode
kernel (:mod:`repro_torch.kernels`), each with the layer's sliding window
(Hymba), and a MoE model's expert FFN the grouped-matmul kernel in both
(DeepSeek-V2: the routed and the shared experts, layer 0 a dense FFN);
``use_kernel=False`` runs their plain versions, the yardstick the kernels
are held against.  DeepSeek-V2's multi-head latent attention runs as
tensor ops, as the reference's does on XLA: the materialised form in the
prefill, the absorbed form over the latent cache in every decode step.  A
hybrid model's Mamba heads run as tensor ops.  An
xLSTM model (xlstm-350m) keeps a fixed-size state per layer in place of a
KV cache: its mLSTM layers run as tensor ops (chunkwise in the prefill, the
recurrent step in decode), its sLSTM layers' recurrence the sLSTM kernel
(``slstm_scan``) in the prefill and in every decode step.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import meshops
from repro_torch.device import check_device
from repro_torch.launch.shardings import batch_spec
from repro_torch.models import lm


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens: int
    # last-position logits [rows, vocab] on the device (under a mesh, this
    # rank's rows): the prefill's, then every decode step's
    logits: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.decode_s if self.decode_s else 0.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rows(batch: int, mesh) -> tuple[slice, tuple | None]:
    """This rank's rows of the batch and the axes they are split over
    (``batch_spec``'s rule: ``("pod", "data")`` where their sizes divide
    ``batch``, else every row on every rank, and None)."""
    axes = batch_spec((batch,), mesh)[0] if mesh is not None else None
    if not axes:
        return slice(None), None
    n = batch // mesh.axis_size(axes)
    return slice(mesh.index(axes) * n, (mesh.index(axes) + 1) * n), axes


@torch.no_grad()
def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_len: int = 16, max_len: int = 128,
          device="cuda", seed: int = 0, params: lm.LM | None = None,
          use_kernel: bool = True, forced: np.ndarray | None = None,
          mesh=None):
    """Serve ``batch`` random prompts greedily: returns ``(tokens [batch,
    gen_len] int32, ServeStats)``.  ``params`` defaults to
    :func:`lm.init_lm` of ``arch``'s config (``smoke`` picks SMOKE) with
    ``seed`` on ``device``; given ``params`` bring their own config (a model
    cut in depth gets a cache of its own depth), which must be ``arch``'s.
    ``forced [batch, gen_len]`` feeds those tokens to the decode steps
    instead of the greedy ones (teacher forcing, for holding one run's
    logits against another's).  Runs under ``torch.no_grad()``, so that
    a model fresh from training (its parameters requiring grad) serves
    without building a graph.  Under ``mesh`` (on ``device``'s type) the
    prompts are drawn on every rank, the rank runs its rows with a cache
    of those rows, ``params`` must be placed on that mesh (``init_lm`` /
    ``convert`` with the same mesh, or ``lm.place``: each leaf the rank's
    shard, gathered at use or consumed in place over ``model``), the cache
    holds the rank's kv heads where its attention splits them, each
    step's last-position logits are gathered over ``model`` before the
    argmax where the unembedding splits the vocabulary, and the tokens are
    gathered over the batch axes."""
    if prompt_len + gen_len > max_len:
        raise ValueError(f"prompt_len + gen_len = {prompt_len + gen_len} "
                         f"exceeds max_len = {max_len}")
    dev = check_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh serving on {dev}")
    if params is None:
        params = lm.init_lm(get_config(arch, smoke=smoke), seed=seed,
                            device=dev, mesh=mesh)
    cfg = params.cfg
    if cfg.name.removesuffix("-smoke") != arch:
        raise ValueError(f"params are a {cfg.name!r} model, not {arch!r}")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    rows, axes = _rows(batch, mesh)
    prompts = prompts[rows]
    stats = ServeStats(0.0, 0.0, batch * gen_len)

    _sync(dev)
    t0 = time.perf_counter()
    cache = lm.init_cache(cfg, prompts.shape[0], max_len, device=dev,
                          mesh=mesh, specs=params.specs)
    logits, cache, _ = lm.forward(params, tokens=torch.from_numpy(prompts).to(dev),
                                  cache=cache, use_kernel=use_kernel,
                                  mesh=mesh, local_logits=True)
    stats.logits.append(lm.gather_vocab(logits[:, -1].clone(), mesh,
                                        cfg.vocab))
    del logits
    _sync(dev)
    stats.prefill_s = time.perf_counter() - t0

    out = []
    tok = stats.logits[-1].argmax(-1).to(torch.int32)[:, None]
    t0 = time.perf_counter()
    for i in range(gen_len):
        out.append(tok)
        step_in = tok if forced is None else torch.from_numpy(
            np.asarray(forced[rows, i:i + 1], np.int32)).to(dev)
        logits, cache = lm.serve_step(params, cache, tokens=step_in,
                                      use_kernel=use_kernel, mesh=mesh,
                                      local_logits=True)
        stats.logits.append(lm.gather_vocab(logits[:, -1].clone(), mesh,
                                            cfg.vocab))
        tok = stats.logits[-1].argmax(-1).to(torch.int32)[:, None]
    _sync(dev)
    stats.decode_s = time.perf_counter() - t0
    if not out:
        return np.zeros((batch, 0), np.int32), stats
    gen = torch.cat(out, dim=1)
    if axes is not None:
        gen = meshops.all_gather(gen, mesh, axes, axis=0)
    return gen.cpu().numpy(), stats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced SMOKE config")
    args = ap.parse_args()
    gen, stats = serve(args.arch, smoke=args.smoke, batch=args.batch,
                       prompt_len=args.prompt_len, gen_len=args.gen_len,
                       device=args.device)
    print(f"[serve] generated {gen.shape} tokens on {args.device}; prefill "
          f"{stats.prefill_s:.2f}s decode {stats.tokens_per_s:.1f} tok/s")
    print("[serve] first row:", gen[0][:16].tolist())


if __name__ == "__main__":
    main()
