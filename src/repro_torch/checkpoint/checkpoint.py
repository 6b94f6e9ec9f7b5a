"""Atomic checkpointing of dicts of tensors.

Counterpart of ``repro.checkpoint.checkpoint`` with its on-disk layout (one
directory per step)::

    <dir>/step_00000042/
        manifest.json          # step, leaf paths, entries, metadata
        arr_00000.npy ...      # one file per leaf (np.save; bf16 as uint16)

* **Atomicity**: writes go to ``step_XXXXXXXX.tmp-<pid>``, which is renamed
  into place only after ``manifest.json`` is fsynced; a crash mid-save
  never leaves a directory that counts as complete.
* **Restore by path**: a tree is a dict of tensors, nested dicts allowed,
  and its leaves are named by their ``/``-joined keys (``"params/embed"``,
  ``"opt_state/m/blocks.0.attn.wq"``).  A restore reads each leaf of the
  target from the entry of the same path, checks its shape, and puts it on
  the target leaf's device.  The reference's jax treedef has no
  counterpart: the path is the structure.
* **Another mesh**: a checkpoint holds whole arrays.  A restore may read
  a block of an entry (``blocks``: a slice a dimension), the shard a rank
  of another mesh holds: the counterpart of the reference's restore onto
  other shardings.
* **Async**: :meth:`CheckpointManager.save_async` copies every leaf to host
  memory at once (training may then update the tensors in place) and
  writes on a background thread.
* **Retention**: keep-last-k garbage collection.

numpy has no bfloat16: such leaves are stored as uint16 with the true dtype
in the manifest, as the reference stores them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{path: leaf}`` of a nested dict, paths ``/``-joined, in the dict's
    order."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def tree_paths(tree: dict) -> list[str]:
    return list(flatten(tree))


def _unflatten_like(target: dict, leaves: dict, prefix: str = "") -> dict:
    return {k: _unflatten_like(v, leaves, f"{prefix}{k}/")
            if isinstance(v, dict) else leaves[f"{prefix}{k}"]
            for k, v in target.items()}


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def to_host(x) -> tuple[np.ndarray, str]:
    """A host copy of ``x`` (a tensor, or an array already on the host)
    that later writes to ``x`` do not reach, and its dtype's name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        dtype = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), dtype
        return t.numpy(), dtype
    arr = np.array(x, copy=True)
    return arr, str(arr.dtype)


def _write(directory: str, step: int, host: dict, metadata: dict | None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, (arr, dtype) in enumerate(host.values()):
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        entries.append({"file": fname, "shape": list(arr.shape), "dtype": dtype})
    manifest = {"step": step, "paths": list(host), "entries": entries,
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree: dict,
                    metadata: dict | None = None) -> str:
    """Write one atomic checkpoint; returns the final directory path."""
    host = {p: to_host(x) for p, x in flatten(tree).items()}
    return _write(directory, step, host, metadata)


def _complete_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name and \
                os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int | None, target: dict,
                       blocks: dict | None = None) -> tuple[dict, dict]:
    """``(tree, metadata)``: a tree shaped like ``target`` whose every leaf
    is read from the checkpoint's entry of the same path, in the stored
    dtype, on the target leaf's device (a leaf without a device: the
    CPU).  ``blocks`` maps a path to a tuple of slices, one a dimension
    (``shardings.shard_slices``): that leaf is the entry's block.  Raises
    if the leaf counts differ, a path is missing, a block falls outside
    its entry or a shape differs."""
    blocks = blocks or {}
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = flatten(target)
    if len(want) != len(manifest["entries"]):
        raise ValueError(f"checkpoint has {len(manifest['entries'])} leaves, "
                         f"target has {len(want)}")
    stored = dict(zip(manifest["paths"], manifest["entries"]))
    out = {}
    for p, leaf in want.items():
        if p not in stored:
            raise KeyError(f"checkpoint at {path} has no leaf {p!r}")
        entry = stored[p]
        arr = np.load(os.path.join(path, entry["file"]))
        if p in blocks:
            sl = blocks[p]
            if len(sl) != arr.ndim or any(
                    s.stop > n for s, n in zip(sl, arr.shape)):
                raise ValueError(f"block {sl} of {p} {arr.shape}")
            arr = np.ascontiguousarray(arr[sl])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {p} ({entry['file']}): "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        t = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        else:
            t = t.to(getattr(torch, entry["dtype"]))
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out[p] = t.to(dev)
    return _unflatten_like(target, out), manifest["metadata"]


class CheckpointManager:
    """Retention and async writes around save / restore."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: dict, metadata: dict | None = None) -> str:
        path = save_checkpoint(self.directory, step, tree, metadata)
        self._gc()
        return path

    def save_async(self, step: int, tree: dict,
                   metadata: dict | None = None) -> None:
        """Snapshot to host memory now; write on a background thread."""
        self.wait()
        self.write_async(step, {p: to_host(x)
                                for p, x in flatten(tree).items()}, metadata)

    def write_async(self, step: int, host: dict,
                    metadata: dict | None = None) -> None:
        """Write a snapshot the caller made (``{path: to_host(leaf)}``) on
        a background thread."""
        self.wait()

        def write():
            _write(self.directory, step, host, metadata)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, target: dict, step: int | None = None,
                blocks: dict | None = None) -> tuple[dict, dict]:
        self.wait()
        return restore_checkpoint(self.directory, step, target, blocks)

    def latest(self) -> int | None:
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = _complete_steps(self.directory)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
