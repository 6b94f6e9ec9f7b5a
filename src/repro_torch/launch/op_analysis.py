"""Per-op counting of one step on a rank: FLOPs, HBM bytes, collective wire
bytes and peak memory.

Counterpart of ``repro.launch.hlo_analysis``.  The reference lowers a
cell's step to optimized HLO and parses the text: XLA's own cost analysis
counts each ``while`` body once, so the reference walks the call graph and
scales each loop body by its trip count.  Torch runs eagerly and has no
HLO, so there is no text to parse.  Instead the step is *run*, on meta
stand-ins under a fake process group (:mod:`repro_torch.launch.dryrun`) or
on real tensors, inside :class:`OpCounter`, a ``TorchDispatchMode`` that
sees every aten and ``c10d`` operation the rank issues, loops unrolled as
they run.  Its totals are per rank, like the reference's ``HloCost``:

* **FLOPs**: ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, the SDPA ops, convolutions); the reference's
  ``_dot_flops`` counts dots only, and elementwise work is counted by
  neither.
* **HBM bytes**: eager torch's traffic model, one kernel an op: its tensor
  inputs plus its outputs.  These count 0 (the counterpart of
  ``_SKIP_BYTES_OPS``): views and metadata (every op whose schema returns
  an alias of an input, ``_unsafe_view``, the ``sym_*`` queries, ``set_``)
  and the factories that write nothing (``empty``, ``empty_like``,
  ``empty_strided``, ``empty_permuted``, ``new_empty``,
  ``new_empty_strided``).  A copy into a tensor (``copy_``) reads its
  source and writes its destination; a fill (``fill_``, ``zero_``) writes
  it; a gather of rows (``embedding``, ``index``, ``index_select``,
  ``gather``) reads its indices and the rows it takes and writes them, and a
  scatter into rows (``index_put_``, ``index_copy_``, ``index_add_``,
  ``scatter_``, ``scatter_add_``) reads its indices and values and writes
  the values' rows (the reference's rule for ``gather`` and
  ``dynamic-update-slice``).
* **Collectives**: each ``c10d`` operation's wire bytes by the ring factors
  of ``repro.launch.roofline`` (all-gather ``out (g-1)/g``, all-reduce ``2
  in (g-1)/g``, reduce-scatter and all-to-all ``in (g-1)/g``, a send its
  bytes), ``g`` the group's size; a group whose ranks
  (``dist.get_process_group_ranks``) straddle a multiple of ``boundary``
  (the counterpart of ``pod_size``: the ranks one NVLink domain joins)
  counts as ``dcn``, else ``ici``.  A group of one rank moves nothing.  A
  ``c10d`` operation without a ring factor here raises (a barrier moves
  nothing).
* **Kernel-adjusted memory**: the bytes of the non-matmul operations
  issued inside the plain blocked attention
  (:func:`repro_torch.models.blocked_attention.in_attention_scope`, the
  reference's ``flash_xla`` scope): the traffic the flash kernel keeps on
  chip.
* **Kernels**: launched through ``ctypes``, they never reach the
  dispatcher; each LM kernel's wrapper reports its own bytes and FLOPs
  (:mod:`repro_torch.kernels.work`) to :meth:`OpCounter.kernel`, on a CUDA
  and on a meta tensor alike.
* **Memory**: a tracker inside the mode (not ``MemTracker``).  The step's
  arguments' storages are its argument bytes; every storage an operation
  makes is live from that operation until torch frees it (a
  ``weakref.finalize`` on the storage), and the peak of their sum is the
  step's own bytes.  The counterpart of ``memory_analysis()``'s argument +
  temp + output - alias is argument + that peak.

An op of the table :attr:`OpCounter.ops` is its name and its tensor
inputs' shapes, with its calls and, for each, its FLOPs and bytes (the
counterpart of ``perf.top_items``; ``flash`` marks the attention scope).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work
from repro_torch.launch.roofline import NVLINK_DOMAIN
from repro_torch.models.blocked_attention import in_attention_scope

_aten = torch.ops.aten
_NO_BYTES = {
    _aten._unsafe_view, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset, _aten.set_, _aten.empty, _aten.empty_like,
    _aten.empty_strided, _aten.empty_permuted, _aten.new_empty,
    _aten.new_empty_strided, _aten.is_same_size}
_WRITE_ONLY = {_aten.fill_, _aten.zero_}
_GATHERS = {_aten.embedding, _aten.index, _aten.index_select, _aten.gather}
_SCATTERS = {_aten.index_put_, _aten.index_copy_, _aten.index_add_,
             _aten.scatter_, _aten.scatter_add_}
_NAMES: dict = {}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() \
        if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list[torch.Tensor]:
    """The tensors of an operation's arguments or results: a tensor, or
    tuples, lists and dicts of them (one level deep and more)."""
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    stack = [x]
    while stack:
        y = stack.pop()
        if isinstance(y, torch.Tensor):
            out.append(y)
        elif isinstance(y, (tuple, list)):
            stack.extend(reversed(y))
        elif isinstance(y, dict):
            stack.extend(reversed(list(y.values())))
    return out


_VIEWS: dict = {}


def _is_view(func) -> bool:
    if func not in _VIEWS:
        rets = func._schema.returns
        _VIEWS[func] = bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in rets)
    return _VIEWS[func]


def op_bytes(func, args, kwargs, out) -> int:
    """The HBM bytes of one aten operation by the rules of the module's
    docstring."""
    packet = func.overloadpacket
    if packet in _NO_BYTES or _is_view(func):
        return 0
    if packet is _aten.copy_:
        return _nbytes(args[0]) + _nbytes(args[1])
    if packet in _WRITE_ONLY:
        return _nbytes(args[0])
    ins = _tensors((args, kwargs))
    if packet in _GATHERS:
        src = args[0]
        return sum(_nbytes(t) for t in ins if t is not src) \
            + 2 * sum(_nbytes(t) for t in _tensors(out))
    if packet in _SCATTERS:
        dst = args[0]
        rest = [t for t in ins if t is not dst]
        values = max(rest, key=_nbytes) if rest else None
        return sum(_nbytes(t) for t in rest) + _nbytes(values)
    return sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                              for t in _tensors(out))


def _group(args) -> dist.ProcessGroup | None:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:          # a ReduceOp, not a group
                continue
    return None


def collective_wire(name: str, args, g: int) -> tuple[str, float, float]:
    """``(kind, wire bytes a rank, HBM bytes)`` of one ``c10d`` operation
    over a group of ``g`` ranks (the ring factors)."""
    f = (g - 1) / g
    if name == "_allgather_base_":
        out, inp = args[0], args[1]
        return "all-gather", _nbytes(out) * f, _nbytes(out) + _nbytes(inp)
    if name == "allgather_":
        out, inp = _tensors(args[0]), _tensors(args[1])
        size = sum(map(_nbytes, out))
        return "all-gather", size * f, size + sum(map(_nbytes, inp))
    if name == "allreduce_":
        size = sum(map(_nbytes, _tensors(args[0])))
        return "all-reduce", 2 * size * f, 2 * size
    if name == "_reduce_scatter_base_":
        out, inp = args[0], args[1]
        return "reduce-scatter", _nbytes(inp) * f, _nbytes(out) + _nbytes(inp)
    if name == "alltoall_base_":
        out, inp = args[0], args[1]
        return "all-to-all", _nbytes(inp) * f, _nbytes(out) + _nbytes(inp)
    if name == "send":
        size = sum(map(_nbytes, _tensors(args[0])))
        return "collective-permute", size, size
    if name == "recv_":
        return "collective-permute", 0.0, sum(map(_nbytes,
                                                  _tensors(args[0])))
    if name == "broadcast_":
        size = sum(map(_nbytes, _tensors(args[0])))
        return "broadcast", size * f, size
    if name in ("barrier", "monitored_barrier_"):
        return "barrier", 0.0, 0.0
    raise NotImplementedError(f"c10d.{name}: no ring factor for this "
                              "collective")


@dataclasses.dataclass
class Op:
    calls: int = 0
    flops: float = 0.0
    nbytes: float = 0.0


class OpCounter(TorchDispatchMode):
    """Counts what the operations issued inside it do on this rank (see
    the module's docstring).  ``args``: the step's arguments (tensors, a
    module, or trees of them), whose storages are its argument bytes and
    are not counted as made by the step; ``boundary``: the ranks of one
    NVLink domain, the ICI/DCN line.  Active counters also take the LM
    kernels' reports (:meth:`kernel`)."""

    def __init__(self, *, boundary: int = NVLINK_DOMAIN, args=()):
        super().__init__()
        self.boundary = boundary
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ici_bytes = 0.0
        self.dcn_bytes = 0.0
        self.collective_count = 0
        self.flash_bytes = 0.0
        self.by_op: dict = {}           # (kind, "ici" | "dcn") -> wire bytes
        self.bytes_by_op: dict = {}     # op name -> HBM bytes
        self.ops: dict = {}             # (name, shapes, flash) -> Op
        self.kernel_calls: dict = {}    # kernel name -> calls
        self._known: dict[int, int] = {}     # storage id -> bytes
        self.argument_bytes = 0
        for t in _argument_tensors(args):
            self._remember(t, argument=True)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.output_bytes = 0           # live when the step returned

    # -- memory ----------------------------------------------------------
    def _remember(self, t: torch.Tensor, argument: bool = False) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known:
            return
        size = st.nbytes()
        self._known[key] = size
        weakref.finalize(st, self._forget, key, argument)
        if argument:
            self.argument_bytes += size
        else:
            self.live_bytes += size
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _forget(self, key: int, argument: bool) -> None:
        size = self._known.pop(key, 0)
        if not argument:
            self.live_bytes -= size

    @property
    def memory(self) -> dict:
        """Bytes a rank holds, in GB: the arguments, the peak of the
        step's own live storages, those live when it returned
        (:attr:`output_bytes`, its outputs) and the peak of the sum."""
        gb = 1e9
        return {"argument_gb": self.argument_bytes / gb,
                "temp_gb": self.peak_bytes / gb,
                "output_gb": self.output_bytes / gb,
                "alias_gb": 0.0,
                "total_gb": (self.argument_bytes + self.peak_bytes) / gb}

    # -- counting --------------------------------------------------------
    def _add(self, name: str, shapes, flops: float, nbytes: float,
             flash: bool) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nbytes
        if flash:
            self.flash_bytes += nbytes
        op = self.ops.setdefault((name, shapes, flash), Op())
        op.calls += 1
        op.flops += flops
        op.nbytes += nbytes

    def kernel(self, name: str, nbytes: float, flops: float, shapes) -> None:
        """One launch of an LM kernel, as its wrapper reports it."""
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self._add(f"kernel.{name}", tuple(shapes), flops, nbytes, False)

    def _collective(self, func, args) -> None:
        name = func._opname
        pg = _group(args)
        ranks = dist.get_process_group_ranks(pg) if pg is not None else [0]
        kind, wire, nbytes = collective_wire(name, args, len(ranks))
        self._add(f"c10d.{name}", tuple(tuple(t.shape)
                                        for t in _tensors(args)),
                  0.0, nbytes, False)
        if wire <= 0:
            return
        crosses = len({r // self.boundary for r in ranks}) > 1
        link = "dcn" if crosses else "ici"
        self.collective_count += 1
        self.by_op[(kind, link)] = self.by_op.get((kind, link), 0.0) + wire
        if crosses:
            self.dcn_bytes += wire
        else:
            self.ici_bytes += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._remember(t)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        packet = func.overloadpacket
        counter = flop_registry.get(packet)
        flops = float(counter(*args, **kwargs, out_val=out)) \
            if counter is not None else 0.0
        nbytes = op_bytes(func, args, kwargs, out)
        if flops or nbytes:
            shapes = tuple(tuple(t.shape) for t in _tensors((args, kwargs)))
            self._add(_NAMES.get(packet) or _NAMES.setdefault(
                packet, str(packet)), shapes, flops, nbytes,
                not flops and in_attention_scope())
        return out

    def __enter__(self):
        work.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def top(self, n: int = 12) -> list:
        """The ``n`` ops of :attr:`ops` with the most bytes: ``(bytes,
        calls, name, shapes, flash)``."""
        rows = [(op.nbytes, op.calls, name, shapes, flash)
                for (name, shapes, flash), op in self.ops.items()]
        return sorted(rows, key=lambda r: -r[0])[:n]


def _argument_tensors(args) -> list[torch.Tensor]:
    out = []
    for a in tree_leaves(args, is_leaf=lambda x: isinstance(
            x, torch.nn.Module)):
        if isinstance(a, torch.nn.Module):
            out.extend(a.parameters())
            out.extend(a.buffers())
        elif isinstance(a, torch.Tensor):
            out.append(a)
    return out
