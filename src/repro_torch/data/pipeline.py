"""Training data pipeline with host prefetch.

Counterpart of ``repro.data.pipeline``, on one device or one rank of a
mesh.  ``DataConfig`` and
``SyntheticLMDataset`` are copies of the reference's (pure numpy): batch
``n`` depends only on ``(seed, n)``, so a restart from a step-``k``
checkpoint replays exactly the batches ``k, k+1, ...`` it would have seen.
:class:`DataPipeline` generates batch ``n + 1`` on a prefetch thread while
step ``n`` computes, and hands each batch over as tensors on its device
(:func:`make_global_batch`, the one-device form of the reference's reshard
onto the mesh): ``{"tokens": [B, S], "labels": [B, S]}`` int32, or
``{"embeds": [B, S, D] float32, "labels"}`` for the vlm / audio stub
frontends.  Under a mesh each rank gets only its rows of the global batch
(:func:`rank_rows`), microbatch by microbatch: the counterpart of the
reference's ``make_global_batch``, whose batch the reference's
``microbatch_grads`` reshapes into ``[n_micro, B / n_micro]`` before
``shard_map`` splits each microbatch over ``("pod", "data")``.
:func:`batch_specs` gives a batch's stand-ins under a mesh (``DTensor``
views of meta tensors, for the dry run).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import check_device

from .tokens import markov_tokens, zipf_tokens


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"          # markov | zipf
    modality: str = "text"        # text | vlm | audio (embeds stub input)
    d_model: int = 0              # required for embeds modalities
    prefetch: int = 2


class SyntheticLMDataset:
    """Deterministic per-step batch generator (step -> numpy batch)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        shape = (cfg.global_batch, cfg.seq_len + 1)
        if cfg.kind == "zipf":
            toks = zipf_tokens(rng, shape, cfg.vocab)
        else:
            toks = markov_tokens(rng, shape, cfg.vocab)
        out: dict[str, np.ndarray] = {"labels": toks[:, 1:].astype(np.int32)}
        if cfg.modality == "text":
            out["tokens"] = toks[:, :-1].astype(np.int32)
        else:
            # stub frontend: precomputed frame/patch embeddings derived from ids
            ids = toks[:, :-1].astype(np.int64)
            emb = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32)
            out["embeds"] = emb[ids % cfg.vocab] * 0.02
        return out


def _batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def rank_rows(x: np.ndarray, mesh, n_micro: int = 1) -> np.ndarray:
    """This rank's rows of a global batch array ``x [B, ...]``: for each
    microbatch ``j`` of ``n_micro``, the rows ``[j B / n + r b, j B / n +
    (r + 1) b)`` with ``b = B / (n shards)`` and ``r`` the rank's index
    over the batch axes ``("pod", "data")`` (``shards`` their size),
    concatenated in ``j``; ranks that differ only on other axes get the
    same rows.  Raises unless ``B`` divides into ``n_micro`` microbatches
    that divide over the shards (see ``steps.clamp_n_micro``)."""
    axes = _batch_axes(mesh)
    shards = mesh.axis_size(axes)
    b = x.shape[0]
    if n_micro < 1 or b % n_micro or (b // n_micro) % shards:
        raise ValueError(f"a batch of {b} rows in {n_micro} microbatches "
                         f"does not divide over the {shards} batch shards "
                         f"of {dict(mesh.shape)} (steps.clamp_n_micro picks "
                         f"an n_micro that does)")
    per = b // n_micro // shards
    r = mesh.index(axes) if axes else 0
    return x.reshape(n_micro, shards, per, *x.shape[1:])[:, r].reshape(
        n_micro * per, *x.shape[1:])


def batch_specs(cfg: DataConfig, mesh, batch_axes=("pod", "data")) -> dict:
    """Stand-ins of a global batch under ``mesh``: ``DTensor`` views of
    meta tensors of each rank's rows, the batch dimension over ``batch_axes``
    (those in the mesh) and nothing else split; ``labels`` and ``tokens``
    int32 ``[B, S]``, or ``embeds`` bfloat16 ``[B, S, D]`` for the vlm /
    audio stub frontends."""
    from repro_torch.launch.shardings import with_shardings
    axes = tuple(a for a in batch_axes if a in mesh.shape)
    b_axis = axes if axes else None
    b, s = cfg.global_batch, cfg.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    out = {"labels": meta((b, s), torch.int32)}
    specs = {"labels": (b_axis, None)}
    if cfg.modality == "text":
        out["tokens"], specs["tokens"] = meta((b, s), torch.int32), \
            (b_axis, None)
    else:
        out["embeds"] = meta((b, s, cfg.d_model), torch.bfloat16)
        specs["embeds"] = (b_axis, None, None)
    return with_shardings(out, specs, mesh)


def make_global_batch(batch_np: dict[str, np.ndarray], device, *,
                      mesh=None, n_micro: int = 1) -> dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: whole without a mesh, else
    this rank's rows (:func:`rank_rows`)."""
    dev = check_device(device)
    if mesh is not None:
        batch_np = {k: rank_rows(v, mesh, n_micro)
                    for k, v in batch_np.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch_np.items()}


class DataPipeline:
    """Background-thread prefetch over :class:`SyntheticLMDataset`.

    ``iter(pipeline)`` yields ``(step, batch)`` from ``start_step`` on, the
    batch's tensors on ``device`` (the card unless the caller asks for the
    CPU); generation of batch ``n + prefetch`` overlaps compute on batch
    ``n``.  Under ``mesh`` a batch is this rank's rows for ``n_micro``
    microbatches (:func:`rank_rows`).
    """

    def __init__(self, cfg: DataConfig, device="cuda", start_step: int = 0,
                 *, mesh=None, n_micro: int = 1):
        self.cfg = cfg
        self.device = check_device(device)
        self.mesh, self.n_micro = mesh, n_micro
        if mesh is not None:              # refuse an indivisible batch now
            rank_rows(np.empty((cfg.global_batch, 0)), mesh, n_micro)
        self.dataset = SyntheticLMDataset(cfg)
        self.start_step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _producer(self) -> None:
        step = self.start_step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict[str, torch.Tensor]]]:
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        try:
            while True:
                step, batch_np = self._q.get()
                yield step, make_global_batch(batch_np, self.device,
                                              mesh=self.mesh,
                                              n_micro=self.n_micro)
        finally:
            self.close()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            while not self._q.empty():       # unblock the producer
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=5.0)
            self._thread = None
