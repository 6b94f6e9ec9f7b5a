"""Gradient accumulation over microbatches.

Counterpart of ``repro.optim.accumulate``: the batch is split into
``n_micro`` slices along its leading dimension, and each slice's gradients,
taken with ``torch.autograd.grad`` in the parameters' dtype, are divided by
``n_micro`` in that dtype (as JAX divides) and added into buffers of
``accum_dtype``.  ``.grad`` is not used: it would add bf16 gradients in
bf16.  The reference's ``lax.scan`` over the slices is a Python loop.
"""
from __future__ import annotations

from typing import Callable

import torch


def _grad(loss, leaves):
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def microbatch_grads(loss_fn: Callable, params: dict, batch: dict,
                     n_micro: int, accum_dtype: str = "float32"):
    """``(mean loss, {name: grad})`` of ``loss_fn(params, microbatch)`` over
    ``n_micro`` slices; ``params`` is a dict of tensors that require grad.
    With ``n_micro <= 1`` there is one backward and the gradients keep the
    parameters' dtype; otherwise they are ``accum_dtype`` and the loss the
    float32 sum of each slice's ``loss / n_micro``.  Every array of
    ``batch`` must have a leading dimension divisible by ``n_micro``.  A
    parameter the loss does not reach gets zeros, as under ``jax.grad``
    (the token embedding of a model fed embeddings)."""
    names = list(params)
    leaves = [params[k] for k in names]
    if n_micro <= 1:
        loss = loss_fn(params, batch)
        grads = _grad(loss, leaves)
        return loss.detach(), dict(zip(names, grads))

    def piece(x, i):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])[i]

    adt = getattr(torch, accum_dtype)
    dev = leaves[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    acc: dict = {}
    for i in range(n_micro):
        mb = {k: piece(v, i) for k, v in batch.items()}
        loss = loss_fn(params, mb)
        grads = _grad(loss, leaves)
        for k, g in zip(names, grads):
            part = (g / n_micro).to(adt)
            if k in acc:
                acc[k] += part
            else:                       # zeros + part, without the zeros
                acc[k] = part
        del grads
        loss_acc = loss_acc + loss.detach() / n_micro
    return loss_acc, acc
