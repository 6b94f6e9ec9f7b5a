"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/repro_torch_kernels/<name>-<hash>.so`` under the checkout
(the hash covers the source, every ``csrc/*.cuh`` header it may include and
the flags, so an edited source or header rebuilds).
The first call to :func:`library` builds every missing library at once, one
``nvcc`` process per source, all started together, and loads them.  Nothing
is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("partition", "combine", "fold", "flash_attention",
           "decode_attention", "gmm", "slstm")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# what the last build did: seconds spent, and nvcc's -Xptxas -v report
# (registers, shared memory, spills) per source
BUILD_INFO: dict = {"seconds": None, "ptxas": {}}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build "
                           "the repro_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Build (in parallel) and load every kernel library not loaded yet."""
    with _LOCK:
        missing = [n for n in SOURCES if n not in _LIBS]
        if not missing:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in missing:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_INFO["ptxas"][name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        if procs:
            BUILD_INFO["seconds"] = time.perf_counter() - t0
        for name in missing:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_autograd(what: str, *tensors) -> None:
    """Raise if autograd would record a launch on ``tensors``: the kernels
    have no backward, and an output made through a raw pointer carries no
    ``grad_fn``, so the gradient would be lost without a word.  The
    training path (``lm.train_loss``) runs the plain versions instead."""
    import torch
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if isinstance(t, torch.Tensor)):
        raise RuntimeError(
            f"{what}: the kernel has no backward and an input requires "
            f"grad; run under torch.no_grad(), or take the training path "
            f"(train=True), which runs the plain version")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def _traced_kernels(fn, attempts: int, pad: float = 0.05) -> list[str]:
    """The names of the device kernels one call of ``fn`` launched, read
    from a torch.profiler trace of that call.  The session stays open
    ``pad`` seconds before the call and after it ends: the profiler drops a
    device event whose time, mapped onto the host's clock, falls outside
    the session, and that mapping is off by up to a millisecond or more
    (``dev/profiler_sessions.py``).  A trace that holds no device kernel at
    all is taken again, up to ``attempts`` calls in all."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.name not in (
                     "Activity Buffer Request", "Command Buffer Full")]
        if names:
            return names
    return []


def flash_kernel_ran(fn, attempts: int = 3) -> str:
    """Which of the three flash kernels one call of ``fn`` launched."""
    import re
    names = _traced_kernels(fn, attempts)
    ran = {m.group(0) for n in names
           for m in [re.search(r"flash_(wgmma|mma|fwd)", n)] if m}
    if len(ran) != 1:
        raise RuntimeError(f"one flash kernel per call, traced {ran} "
                           f"among {len(names)} device events")
    return ran.pop()


def decode_kernel_ran(fn, attempts: int = 3) -> tuple[str, ...]:
    """The device kernels one call of ``fn`` launched, in order, each named
    by its decode kernel (``decode_tma``, ``decode_split``,
    ``decode_combine``) or else by its full name: ``("decode_tma",)`` for
    the one-launch kernel."""
    import re
    names = _traced_kernels(fn, attempts)
    if not names:
        raise RuntimeError("the trace holds no device kernel")
    return tuple(m.group(0) if m else n for n in names
                 for m in [re.search(r"decode_(tma|split|combine)", n)])
