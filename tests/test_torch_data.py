"""The port's data pipeline on the CPU, held against the JAX package's.

``repro_torch.data`` keeps a copy of the reference's numpy generators, so a
batch is the reference's bit for bit (Markov and Zipf tokens, and the
embeddings the vlm / audio stub frontends take); the prefetching pipeline
replays from a start step and hands its tensors over on the device asked
for.
"""
import jax
import numpy as np
import pytest

from repro.data import DataConfig as RefDataConfig
from repro.data import DataPipeline as RefPipeline
from repro.data import SyntheticLMDataset as RefDataset

torch = pytest.importorskip("torch")

from repro_torch.data import (DataConfig, DataPipeline,  # noqa: E402
                              SyntheticLMDataset, make_global_batch)


@pytest.mark.parametrize("kind", ["markov", "zipf"])
@pytest.mark.parametrize("modality", ["text", "vlm", "audio"])
def test_batch_at_equals_reference_bit_for_bit(kind, modality):
    kw = dict(vocab=300, seq_len=24, global_batch=3, seed=5, kind=kind,
              modality=modality, d_model=16 if modality != "text" else 0)
    ref, port = RefDataset(RefDataConfig(**kw)), SyntheticLMDataset(
        DataConfig(**kw))
    for step in (0, 1, 7):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert ("tokens" in b) == (modality == "text")


def test_dataset_determinism_and_shapes():
    ds = SyntheticLMDataset(DataConfig(vocab=128, seq_len=16, global_batch=4))
    a, b = ds.batch_at(3), ds.batch_at(3)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (4, 16)
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not np.array_equal(a["tokens"], ds.batch_at(4)["tokens"])


def test_make_global_batch_puts_the_batch_on_the_device():
    batch = SyntheticLMDataset(DataConfig(vocab=64, seq_len=8, global_batch=2,
                                          modality="vlm", d_model=8)).batch_at(0)
    out = make_global_batch(batch, "cpu")
    assert out["labels"].dtype == torch.int32
    assert out["embeds"].dtype == torch.float32
    for k in batch:
        assert out[k].device == torch.device("cpu")
        assert np.array_equal(out[k].numpy(), batch[k])


def test_pipeline_replay_from_step():
    """Restart replay: pipeline(start_step=k) yields the same batch k as a
    run from 0, and as the reference's pipeline."""
    dc = dict(vocab=128, seq_len=16, global_batch=2)
    p1 = DataPipeline(DataConfig(**dc), "cpu", start_step=0)
    it = iter(p1)
    batches = {s: b["tokens"].clone() for s, b in (next(it) for _ in range(4))}
    p1.close()
    assert sorted(batches) == [0, 1, 2, 3]
    p2 = DataPipeline(DataConfig(**dc), "cpu", start_step=2)
    s, b = next(iter(p2))
    p2.close()
    assert s == 2 and b["tokens"].device == torch.device("cpu")
    assert torch.equal(b["tokens"], batches[2])

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref = RefPipeline(RefDataConfig(**dc), mesh, start_step=2)
    rs, rb = next(iter(ref))
    ref.close()
    assert rs == 2
    assert np.array_equal(np.asarray(rb["tokens"]), b["tokens"].numpy())


def test_pipeline_close_stops_the_producer():
    p = DataPipeline(DataConfig(vocab=32, seq_len=4, global_batch=1), "cpu")
    it = iter(p)
    next(it)
    thread = p._thread
    p.close()
    assert p._thread is None and not thread.is_alive()
