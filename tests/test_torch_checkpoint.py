"""The port's checkpoints on the CPU: the counterparts of the reference's
checkpoint tests (a bf16 round trip, atomicity, retention, async writes, a
shape mismatch), the reference's on-disk layout, and restores by path onto
the target's device."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint,
                                    tree_paths)


def _tree():
    return {"a": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.float32),
                  "d": torch.zeros((), dtype=torch.int32)},
            "t": torch.arange(6.0).reshape(2, 3).t()}       # a transposed view


def _same(x, y) -> bool:
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree, {"note": "hi"})
    cm = CheckpointManager(str(tmp_path))
    restored, meta = cm.restore(tree)
    assert meta["note"] == "hi"
    assert _same(restored["a"], tree["a"])
    assert _same(restored["b"]["c"], tree["b"]["c"])
    assert _same(restored["b"]["d"], tree["b"]["d"])
    assert _same(restored["t"], tree["t"])


def test_checkpoint_layout_is_the_references(tmp_path):
    path = save_checkpoint(str(tmp_path), 42, _tree(), {"step": 42})
    assert os.path.basename(path) == "step_00000042"
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 42 and man["metadata"] == {"step": 42}
    assert man["paths"] == ["a", "b/c", "b/d", "t"] == tree_paths(_tree())
    assert [e["dtype"] for e in man["entries"]] == ["bfloat16", "float32",
                                                    "int32", "float32"]
    a = np.load(os.path.join(path, man["entries"][0]["file"]))
    assert a.dtype == np.uint16 and a.shape == (3, 4)       # bf16 as uint16
    assert np.array_equal(a, _tree()["a"].view(torch.int16).numpy()
                          .view(np.uint16))


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    # a crash mid-save: a partial tmp dir without a manifest
    os.makedirs(tmp_path / "step_00000002.tmp-999")
    (tmp_path / "step_00000002.tmp-999" / "arr_00000.npy").write_bytes(b"junk")
    assert latest_step(str(tmp_path)) == 1
    assert not any(".tmp" in n for n in os.listdir(tmp_path)
                   if n.startswith("step_00000001"))


def test_checkpoint_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree())
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_checkpoint_async_snapshots_at_once(tmp_path):
    """save_async copies to host memory before it returns: an in-place
    update afterwards does not reach the checkpoint."""
    cm = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = {"a": tree["a"].clone(), "c": tree["b"]["c"].clone()}
    cm.save_async(7, tree)
    tree["a"].add_(1)
    tree["b"]["c"].mul_(3)
    cm.wait()
    restored, _ = cm.restore(tree)
    assert _same(restored["a"], want["a"])
    assert _same(restored["b"]["c"], want["c"])
    assert cm.latest() == 7


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros((2, 2), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        CheckpointManager(str(tmp_path)).restore(bad)


def test_restore_by_path_and_missing_paths(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    tree = _tree()
    reordered = {"t": tree["t"], "b": {"d": tree["b"]["d"],
                                       "c": tree["b"]["c"]}, "a": tree["a"]}
    got, _ = restore_checkpoint(str(tmp_path), None, reordered)
    assert list(got) == ["t", "b", "a"] and _same(got["b"]["d"], tree["b"]["d"])
    renamed = dict(reordered, z=reordered.pop("a"))
    with pytest.raises(KeyError, match="no leaf 'z'"):
        restore_checkpoint(str(tmp_path), 3, renamed)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 3, {"a": tree["a"]})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), None, tree)
