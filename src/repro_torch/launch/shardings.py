"""The sharding rules that serving needs: which axes a batch is split over,
and the expert-parallel axes.

Counterpart of the part of ``repro.launch.shardings`` that the port's
per-rank serving reads: ``ep_axes_for`` and ``batch_spec`` with its
divisibility rule (``_fit``: an assignment of axes is dropped, the
dimension replicated, when their sizes do not divide it).  A spec is a
tuple with one entry a dimension, an axis name, a tuple of names or None,
as a ``PartitionSpec`` reads.  The parameter, cache and optimizer specs
wait for the port's DTensor placements.
"""
from __future__ import annotations

from typing import Any

from .mesh import Mesh


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


def ep_axes_for(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "model") if a in mesh.shape)


def batch_spec(shape: tuple[int, ...], mesh: Mesh) -> tuple:
    """The batch's leading dimension over ``("pod", "data")`` where their
    sizes divide it, else replicated; the other dimensions replicated."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return (_fit(axes, shape[0], mesh),) + (None,) * (len(shape) - 1)
