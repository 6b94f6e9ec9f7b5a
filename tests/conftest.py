"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must see
the real (single) CPU device; only launch/dryrun.py forces 512 placeholders."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips on a host without one")

from repro.core import (HASH_PART, SUM, Msgs, TeShuService, datacenter)


@pytest.fixture
def small_topology():
    """2 racks x 2 servers x 2 workers, oversubscribed 4:1 (paper-shaped)."""
    return datacenter(workers_per_server=2, servers_per_rack=2, racks=2,
                      oversubscription=4.0)


@pytest.fixture
def service(small_topology):
    return TeShuService(small_topology)


@pytest.fixture
def skewed_bufs(small_topology):
    """Zipf-keyed buffers: heavy key duplication (combiner-friendly)."""
    rng = np.random.default_rng(7)
    nw = small_topology.num_workers
    ranks = np.arange(1, 65)
    w = ranks ** -1.2
    cdf = np.cumsum(w) / np.sum(w)
    return {
        wid: Msgs(np.searchsorted(cdf, rng.random(400)).astype(np.int64),
                  rng.random((400, 1)))
        for wid in range(nw)
    }


def total_payload(bufs) -> float:
    return float(sum(m.vals.sum() for m in bufs.values()))
