"""Operator CLI: validate plan-cache behavior for a deployment scenario.

Drives repeated shuffles of a representative workload through a chosen topology
and prints, per template: fresh-instantiation wall time, cached wall time, the
hit/miss/invalidation counters, and the sampling bytes the cache eliminated.
This is the control-plane analogue of ``launch/dryrun.py`` — before deploying
TeShu for an iterative workload (graph supersteps, MoE dispatch per layer,
per-step gradient buckets), run this to confirm the plan cache reaches a steady
hit state on your topology and that cached executions are byte-equivalent.
The cached replays run on the card (the torch executor) unless ``--device
cpu`` asks for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.shuffle_cache --topology fat_tree \
        --iters 20 [--template network_aware] [--execution auto] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (SUM, Msgs, TeShuService, datacenter, fat_tree,
                              multipod_dcn)

TOPOLOGIES = {
    "datacenter": lambda: datacenter(4, 4, 2, oversubscription=10.0),
    "fat_tree": lambda: fat_tree(2, 2, 2, 2, edge_oversubscription=4.0,
                                 core_oversubscription=4.0),
    "multipod_dcn": lambda: multipod_dcn(4, 2, 2),
}


def skewed_bufs(nw: int, n_per: int = 5000, keys: int = 2000, *,
                seed: int = 0) -> dict[int, Msgs]:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, keys + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -0.9) / np.sum(ranks ** -0.9)
    return {w: Msgs(np.searchsorted(cdf, rng.random(n_per)).astype(np.int64),
                    rng.random((n_per, 1))) for w in range(nw)}


def run(topology: str, template: str, iters: int, execution: str,
        device: str = "cuda") -> dict:
    topo = TOPOLOGIES[topology]()
    svc = TeShuService(topo, execution=execution, device=device)
    nw = topo.num_workers
    base = skewed_bufs(nw)
    workers = list(range(nw))

    results = []

    def one() -> float:
        bufs = {w: m.copy() for w, m in base.items()}
        t0 = time.perf_counter()
        results.append(svc.shuffle(template, bufs, workers, workers,
                                   comb_fn=SUM, rate=0.01))
        return time.perf_counter() - t0

    fresh_s = one()                       # miss: instantiate + compile
    cached = [one() for _ in range(max(1, iters - 1))]
    stats = svc.cache_stats()
    replays = [r for r in results if r.cached]
    out = {
        "topology": topology, "template": template, "workers": nw,
        "fresh_ms": fresh_s * 1e3,
        "cached_ms": float(np.median(cached)) * 1e3,
        "speedup": fresh_s / max(float(np.median(cached)), 1e-12),
        "sample_bytes_per_shuffle": svc.stats()["sample_bytes"] / max(1, iters),
        **{f"cache_{k}": v for k, v in stats.items()},
        # where the cached replays ran, and why any left the card
        "replay_engines": sorted({r.engine for r in replays}),
        "replay_fallbacks": sorted({r.fallback_reason for r in replays
                                    if r.fallback_reason is not None}),
    }
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", choices=sorted(TOPOLOGIES), default="fat_tree")
    ap.add_argument("--template", default="network_aware")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--execution", choices=("auto", "threaded", "fresh"),
                    default="auto")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    out = run(args.topology, args.template, args.iters, args.execution,
              args.device)
    w = max(len(k) for k in out)
    for k, v in out.items():
        print(f"{k:<{w}}  {v:.4g}" if isinstance(v, float) else f"{k:<{w}}  {v}")


if __name__ == "__main__":
    main()
