"""The port's Pregel engine and its shuffle_cache and doctor entry points,
against the JAX package's.

* ``rmat_graph`` gives the reference's graph bit for bit from one seed.
* PageRank (SUM) and SSSP (MIN) on the port's service (``device="cpu"``,
  the torch executor) end in the final vertex states of the reference's
  engine on the reference's service, bit for bit, and every cached
  superstep replays on torch.
* ``shuffle_cache.run`` counts the reference's cache hits, misses and
  sampling bytes.
* ``doctor`` gives the reference's report on a journal that the port's
  manager wrote.
"""
import json

import numpy as np
import pytest

from repro.apps.graph import PageRank as RefPageRank
from repro.apps.graph import PregelEngine as RefEngine
from repro.apps.graph import SSSP as RefSSSP
from repro.apps.graph import rmat_graph as ref_rmat
from repro.core import TeShuService, datacenter
from repro.launch import doctor as ref_doctor
from repro.launch import shuffle_cache as ref_shuffle_cache

torch = pytest.importorskip("torch")

import repro_torch.core as port  # noqa: E402
from repro_torch.apps.graph import (SSSP, PageRank, PregelEngine,  # noqa: E402
                                    rmat_graph)
from repro_torch.launch import doctor, shuffle_cache  # noqa: E402


@pytest.mark.parametrize("nv,ne,seed", [(256, 2000, 1), (1000, 9000, 7),
                                        (1 << 12, 1 << 15, 0)])
def test_rmat_graph_is_the_reference_graph(nv, ne, seed):
    g, r = rmat_graph(nv, ne, seed=seed), ref_rmat(nv, ne, seed=seed)
    assert g.num_vertices == r.num_vertices
    assert g.src.dtype == r.src.dtype == np.int64
    np.testing.assert_array_equal(g.src, r.src)
    np.testing.assert_array_equal(g.dst, r.dst)
    np.testing.assert_array_equal(g.out_degree(), r.out_degree())


class _Recording:
    """A service that keeps every superstep's result (the engine keeps only
    its decisions)."""

    def __init__(self, svc):
        self.svc, self.topology, self.results = svc, svc.topology, []

    def shuffle(self, *a, **kw):
        self.results.append(self.svc.shuffle(*a, **kw))
        return self.results[-1]


@pytest.mark.parametrize("program", ["pagerank", "sssp"])
@pytest.mark.parametrize("template", ["vanilla_push", "network_aware"])
def test_graph_program_matches_the_reference(template, program):
    nv, ne = 512, 6000
    make = {"pagerank": (lambda: PageRank(supersteps=8),
                         lambda: RefPageRank(supersteps=8)),
            "sssp": (lambda: SSSP(source=0, supersteps=6),
                     lambda: RefSSSP(source=0, supersteps=6))}[program]
    svc = _Recording(port.TeShuService(
        port.datacenter(2, 2, 2, oversubscription=4.0), device="cpu"))
    got = PregelEngine(rmat_graph(nv, ne, seed=3), svc,
                       template_id=template, rate=0.05).run(make[0]())
    ref_svc = TeShuService(datacenter(2, 2, 2, oversubscription=4.0))
    want = RefEngine(ref_rmat(nv, ne, seed=3), ref_svc, template_id=template,
                     rate=0.05).run(make[1]())
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    cached = [r for r in svc.results if r.cached]
    assert cached                                   # else the check is vacuous
    for r in cached:
        assert r.engine == "torch" and r.fallback_reason is None


def test_shuffle_cache_counts_the_references_hits():
    got = shuffle_cache.run("fat_tree", "network_aware", 4, "auto",
                            device="cpu")
    want = ref_shuffle_cache.run("fat_tree", "network_aware", 4, "auto")
    keys = [k for k in want if k.startswith("cache_")] + [
        "topology", "template", "workers", "sample_bytes_per_shuffle"]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["cache_hits"] == 3 and got["cache_misses"] == 1
    assert got["replay_engines"] == ["torch"] and not got["replay_fallbacks"]


def test_shuffle_cache_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shuffle_cache.run("datacenter", "network_aware", 2, "auto")


def test_doctor_reads_the_ports_journal(tmp_path, capsys):
    journal = str(tmp_path / "journal.jsonl")
    sv = port.TeShuService(port.datacenter(2, 2, 2, oversubscription=4.0),
                           journal_path=journal, resilience="recover",
                           device="cpu")
    ws = list(range(8))
    rng = np.random.default_rng(5)
    bufs = {w: port.Msgs(rng.integers(0, 64, 293).astype(np.int64),
                         rng.random((293, 2))) for w in ws}
    for _ in range(2):
        sv.shuffle("vanilla_push", {w: m.copy() for w, m in bufs.items()},
                   ws, ws, comb_fn=port.SUM)
    sv.inject_fault(3, after_stage=-1)
    rec = sv.shuffle("vanilla_push", {w: m.copy() for w, m in bufs.items()},
                     ws, ws, comb_fn=port.SUM)
    assert rec.attempts == 2
    sv.manager.close()
    reports = doctor.diagnose(journal)
    assert reports == ref_doctor.diagnose(journal)
    assert [r["shuffle_id"] for r in reports] == [1, 2, 3]
    assert reports[2]["status"] == "recovered"
    assert reports[2]["failures"][0]["dead"] == [3]
    assert doctor.main([journal, "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_doctor.main([journal, "--json"]) == 0
    assert got == json.loads(capsys.readouterr().out)
    assert doctor.render(reports) == ref_doctor.render(reports)
