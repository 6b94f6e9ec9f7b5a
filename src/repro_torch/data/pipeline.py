"""Training data pipeline with host prefetch.

Counterpart of ``repro.data.pipeline`` on one device.  ``DataConfig`` and
``SyntheticLMDataset`` are copies of the reference's (pure numpy): batch
``n`` depends only on ``(seed, n)``, so a restart from a step-``k``
checkpoint replays exactly the batches ``k, k+1, ...`` it would have seen.
:class:`DataPipeline` generates batch ``n + 1`` on a prefetch thread while
step ``n`` computes, and hands each batch over as tensors on its device
(:func:`make_global_batch`, the one-device form of the reference's reshard
onto the mesh): ``{"tokens": [B, S], "labels": [B, S]}`` int32, or
``{"embeds": [B, S, D] float32, "labels"}`` for the vlm / audio stub
frontends.  The reference's ``batch_specs`` (mesh stand-ins for the dry
run) waits for the port's DTensor placements.
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


def make_global_batch(batch_np: dict[str, np.ndarray],
                      device) -> dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (the batch is whole: one
    device, no mesh)."""
    dev = check_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch_np.items()}


class DataPipeline:
    """Background-thread prefetch over :class:`SyntheticLMDataset`.

    ``iter(pipeline)`` yields ``(step, batch)`` from ``start_step`` on, the
    batch's tensors on ``device`` (the card unless the caller asks for the
    CPU); generation of batch ``n + prefetch`` overlaps compute on batch
    ``n``.
    """

    def __init__(self, cfg: DataConfig, device="cuda", start_step: int = 0):
        self.cfg = cfg
        self.device = check_device(device)
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
                yield step, make_global_batch(batch_np, self.device)
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
