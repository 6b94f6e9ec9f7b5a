"""Meshes of ranks and their process groups.

Counterpart of ``repro.launch.mesh``.  The reference builds a
``jax.sharding.Mesh`` over devices and runs one program over all of them;
the port runs one process per rank (SPMD), so a :class:`Mesh` here is this
rank's view of the layout: the axis names and sizes (``shape``, a dict as
in JAX), its own coordinate on each axis (the counterpart of
``lax.axis_index``) and a process group for one axis or a tuple of axes,
the members of a collective that JAX would run over those axes.

Ranks are laid out row-major, as ``jax.devices()[:n].reshape(shape)``
lays out devices.  A tuple of axes is linearised as JAX linearises it, the
first axis named the major one: chunk ``j`` of an all-to-all over
``("pod", "model")`` goes to the rank whose index ``pod * size(model) +
model`` is ``j``, whatever order ``torch.distributed`` gives the group's
members (it sorts them by global rank).  :class:`AxisGroup` keeps both
orders.

A mesh on ``cuda`` needs a NCCL world, one on ``cpu`` a gloo world, and
either may sit on a fake world (``torch.distributed``'s ``"fake"``
backend, whose collectives move nothing), where a dry run builds stand-ins;
a mesh on ``meta`` (tensors with shapes and no data) sits on a fake world
only, where the dry run (:mod:`repro_torch.launch.dryrun`) runs its steps;
``torch.distributed.init_process_group`` is the caller's, with its address,
world size and rank.  The reference's ``TPU_PERF_FLAGS`` (XLA flags for
the latency-hiding scheduler) have no counterpart.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks that share every coordinate but those of ``axes``: ``pg``
    their process group, ``ranks`` their global ranks in JAX's order (the
    first axis major), ``index`` this rank's place in that order and
    ``order[g]`` the JAX index of group rank ``g``."""
    axes: tuple[str, ...]
    pg: dist.ProcessGroup
    ranks: tuple[int, ...]
    index: int
    order: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def in_jax_order(self) -> bool:
        return self.order == tuple(range(self.size))


class Mesh:
    """This rank's view of a mesh of ranks ``ranks`` (an integer array,
    one global rank per device slot) with axis names ``axes``, on
    ``device_type`` (``"cuda"``: NCCL, ``"cpu"``: gloo, ``"meta"``: a fake
    world).  Built over ``torch.distributed``'s :class:`DeviceMesh`
    (``device_mesh``), whose
    per-axis groups it hands out; a tuple of several axes gets a group of
    its own, made the first time it is asked for (every rank of the world
    must ask, in the same order, as for any new process group)."""

    def __init__(self, ranks: np.ndarray, axes: tuple[str, ...],
                 device_type: str = "cuda"):
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs torch.distributed initialised "
                               "(init_process_group with its world size "
                               "and rank)")
        if device_type not in (*BACKEND, "meta"):
            raise ValueError(f"device_type must be cuda, cpu or meta: "
                             f"{device_type!r}")
        backend = dist.get_backend()
        want = BACKEND.get(device_type, "fake")
        if backend not in (want, "fake"):
            raise ValueError(f"a {device_type} mesh needs a {want} world, "
                             f"not {backend}")
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh of shape {ranks.shape} with axes {axes}")
        self.ranks, self.axis_names = ranks, tuple(axes)
        self.device_type = device_type
        self.shape = dict(zip(axes, ranks.shape))
        self.size = int(ranks.size)
        if ranks.size == dist.get_world_size() and np.array_equal(
                ranks.reshape(-1), np.arange(ranks.size)):
            self.device_mesh = init_device_mesh(
                device_type, ranks.shape, mesh_dim_names=self.axis_names)
        else:
            self.device_mesh = DeviceMesh(device_type, torch.from_numpy(ranks),
                                          mesh_dim_names=self.axis_names)
        me = np.argwhere(ranks == dist.get_rank())
        self._coord = dict(zip(axes, map(int, me[0]))) if len(me) else None
        self._pgs: dict[frozenset, dist.ProcessGroup] = {}
        self._groups: dict[tuple, AxisGroup] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"

    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise KeyError(f"no axis {a!r} in mesh {self.shape}")
        return axes

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        if self._coord is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in {self}")
        return self._coord[self._axes(axis)[0]]

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or a tuple)."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def index(self, axes) -> int:
        """This rank's index over ``axes`` linearised as JAX does: the
        first axis the major one."""
        out = 0
        for a in self._axes(axes):
            out = out * self.shape[a] + self.coord(a)
        return out

    def group(self, axes) -> AxisGroup:
        """The group of this rank over ``axes`` (a name or a tuple)."""
        axes = self._axes(axes)
        if axes in self._groups:
            return self._groups[axes]
        key = frozenset(axes)
        if key not in self._pgs:
            self._pgs[key] = self.device_mesh.get_group(axes[0]) \
                if len(axes) == 1 else self._new_groups(axes)
        # the members in JAX's order: the other axes held at this rank's
        # coordinates, ``axes`` row-major in the order they are named
        sub = self.ranks[tuple(slice(None) if a in axes else self.coord(a)
                               for a in self.axis_names)]
        kept = [a for a in self.axis_names if a in axes]
        ranks = [int(r) for r in np.transpose(
            sub, [kept.index(a) for a in axes]).reshape(-1)]
        self._groups[axes] = AxisGroup(
            axes, self._pgs[key], tuple(ranks), ranks.index(dist.get_rank()),
            tuple(ranks.index(r) for r in sorted(ranks)))
        return self._groups[axes]

    def _new_groups(self, axes) -> dist.ProcessGroup:
        """One process group for each coordinate of the other axes; this
        rank's.  Every rank of the world takes part."""
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        moved = np.moveaxis(self.ranks, keep, list(range(-len(keep), 0)))
        lists = moved.reshape(-1, int(np.prod([self.shape[a]
                                                for a in axes])))
        mine, _ = dist.new_subgroups_by_enumeration(
            [sorted(map(int, r)) for r in lists],
            backend=None if dist.get_backend() == "fake"
            else BACKEND[self.device_type])
        return mine


def _world_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                device_type: str) -> Mesh:
    n = int(np.prod(shape))
    if dist.is_initialized() and dist.get_world_size() < n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}, have "
                           f"{dist.get_world_size()}")
    return Mesh(np.arange(n).reshape(shape), axes, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` with ``pod``
    in front: the reference's production meshes, over the first 256 or 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _world_mesh(shape, axes, device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda") -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks, row-major
    (``jax.devices()[:n].reshape(shape)``)."""
    return _world_mesh(tuple(shape), tuple(axes), device_type)


def _elastic_layout(n_devices: int, model_parallel: int = 16,
                    pod_size: int = 256) -> tuple[tuple[int, ...],
                                                  tuple[str, ...]]:
    """The shape and axes :func:`elastic_mesh` builds (the reference's
    arithmetic, unchanged)."""
    if n_devices < model_parallel:
        raise ValueError(f"need at least {model_parallel} devices")
    data_total = n_devices // model_parallel
    pods = max(1, data_total * model_parallel // pod_size)
    data_per_pod = data_total // pods
    if pods > 1:
        return (pods, data_per_pod, model_parallel), ("pod", "data", "model")
    return (data_per_pod, model_parallel), ("data", "model")


def elastic_mesh(n_devices: int, *, model_parallel: int = 16,
                 pod_size: int = 256, device_type: str = "cuda") -> Mesh:
    """The largest usable mesh of ``n_devices`` ranks after failures: the
    ``model`` axis kept at ``model_parallel``, ``data`` (and ``pod``, in
    pods of at most ``pod_size``) shrunk to whole multiples.  One rank:
    ``elastic_mesh(1, model_parallel=1)`` is ``(1, 1)`` ``("data",
    "model")``."""
    shape, axes = _elastic_layout(n_devices, model_parallel, pod_size)
    return _world_mesh(shape, axes, device_type)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (batch is sharded over these)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def ep_axes(mesh: Mesh) -> tuple[str, ...]:
    """Expert-parallel axes: the fast ``model`` axis, plus ``pod`` when
    multi-pod (the two-level exchange stages over exactly these)."""
    return tuple(a for a in ("pod", "model") if a in mesh.shape)
