#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TeShu on one NVIDIA card.

    python3 chip_smoke.py                    # the smoke run (one card)
    python3 chip_smoke.py --profile DIR      # also trace one hit per template

Run from the root of a checkout.  It needs a CUDA device: without one it
exits non-zero and prints no result.  In order it

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the three CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and prints the build seconds;
3. holds each kernel against its plain PyTorch version on the card at the
   replay's shapes, and times kernel, plain version and the one-call library
   yardstick (``index_add_``) with CUDA events (median of several launches);
4. drives the port's main path, the cached-plan replay of the shuffle
   service, at the paper-shaped 40-worker deployment: Zipf(0.9) keys over
   1M keys, 200k rows of width 8 per worker (8M rows, 576 MB), SUM on
   ``network_aware`` and ``vanilla_push``: one miss, then hits.  The kernel
   launch counters are zeroed just before the hits and read just after;
   outputs are held against the port's own vectorized replay;
5. prints the ``kernels`` JSON line, then the ``ok`` line last.

The card's peaks used for the bounds are NVIDIA's H100 SXM data-sheet
numbers: 3.35 TB/s of HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64
outside the tensor cores.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
U32 = 2.0 ** -24                     # float32 unit roundoff

WORKERS = 40                         # datacenter(4, 5, 2): the paper's shape
ROWS_PER_WORKER = 200_000
KEYS = 1_000_000
ALPHA = 0.9
WIDTH = 8
HITS = 3
TEMPLATES = ("network_aware", "vanilla_push")
FOLD_MAX_SEG = 64                    # longest fold segment in the kernel phase


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, one pair of CUDA events around
    each call (inputs are hundreds of MB, past the 50 MB L2)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` operations at ``ops_rate``."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def zipf_keys(n: int, keys: int, alpha: float, gen, device):
    """Zipf(alpha) keys over [0, keys) by inverse CDF, drawn on ``device``."""
    import torch
    w = torch.arange(1, keys + 1, dtype=torch.float64, device=device) ** -alpha
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
    return torch.searchsorted(cdf, u).clamp_(max=keys - 1)


def zipf_shards(seed: int):
    """Per-worker Msgs for the slice: the generator of the JAX package's
    benchmarks (``benchmarks/common.py:zipf_shards``), here at width 8."""
    import numpy as np

    from repro_torch.core import Msgs
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, KEYS + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -ALPHA)
    cdf /= cdf[-1]
    return {w: Msgs(np.searchsorted(cdf, rng.random(ROWS_PER_WORKER))
                    .astype(np.int64), rng.random((ROWS_PER_WORKER, WIDTH)))
            for w in range(WORKERS)}


def copy_bufs(bufs):
    return {w: m.copy() for w, m in bufs.items()}


# ---------------------------------------------------------------------------
# 3. kernel phase
# ---------------------------------------------------------------------------

def _segment_layout(keys, ndst: int):
    """The global stage's layout: rows sorted destination-major, key
    ascending, with compacted (destination, key) segment ids -- exactly what
    ``torchplan.kernel_global_stage`` hands COMB."""
    import torch

    from repro_torch.core import torchplan
    slot = torchplan._slot_of(("hash",), keys, ndst)
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(slot[order], stable=True).indices]
    sk, ss = keys[order], slot[order]
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = (sk[1:] != sk[:-1]) | (ss[1:] != ss[:-1])
    return order, head, torch.cumsum(head, 0) - 1


def kernel_phase(dev) -> dict:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.combine import segment_combine
    from repro_torch.kernels.fold import segmented_fold
    from repro_torch.kernels.partition import partition_permute

    n, d = WORKERS * ROWS_PER_WORKER, WIDTH
    gen = torch.Generator(device=dev).manual_seed(1)
    vals = torch.rand((n, d), dtype=torch.float32, device=dev, generator=gen)
    rows = {}

    # ---- PART as the replay calls it: a permutation, n = 8M, d = 8 --------
    perm = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    got = partition_permute(perm, vals, num_out=n, unique_slots=True)
    plain = ref.partition_permute_ref(perm, vals, num_out=n)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    assert torch.equal(got, plain), "PART (permutation) differs from plain"
    lib_out, perm64 = torch.zeros_like(vals), perm.long()
    tb = bound(4 * n + 4 * n * d + 4 * n * d, 0, F32_OPS_PER_S)
    rows["partition_permute"] = dict(
        max_abs_err=err, tolerance="exact",
        ms=time_ms(lambda: partition_permute(perm, vals, num_out=n,
                                             unique_slots=True)),
        plain_ms=time_ms(lambda: ref.partition_permute_ref(perm, vals,
                                                           num_out=n)),
        library_ms=time_ms(lambda: lib_out.index_add_(0, perm64, vals)),
        bound_ms=tb[0], bound_by=tb[1])
    log(f"kernel PART permutation n={n} d={d} f32: exact, "
        f"{json.dumps(rows['partition_permute'])}")

    # ---- PART with collisions (-1 and >= num_out dropped) -----------------
    m = n // 8
    slots = torch.randint(-1, m + 1, (n,), device=dev, generator=gen,
                          dtype=torch.int32)
    got = partition_permute(slots, vals, num_out=m)
    plain = ref.partition_permute_ref(slots, vals, num_out=m)
    ok = (slots >= 0) & (slots < m)
    cnt = torch.bincount(slots[ok].long(), minlength=m).double()[:, None]
    absum = torch.zeros((m, d), dtype=torch.float64, device=dev).index_add_(
        0, slots[ok].long(), vals[ok].double().abs())
    # both sides are float32 sums of the same rows: each within
    # cnt * 2^-24 * sum|v| of the exact sum, so within twice that of each other
    tol = 2 * cnt * U32 * absum
    diff = (got.double() - plain.double()).abs()
    assert bool((diff <= tol).all()), "PART (collisions) outside the f32 bound"
    tb = bound(4 * n + 4 * n * d + 4 * m * d, n * d, F32_OPS_PER_S)
    log(f"kernel PART collisions n={n} num_out={m} d={d} f32: "
        f"max_abs_err={float(diff.max())!r} (bound 2*len*2^-24*sum|v|), "
        f"ms={time_ms(lambda: partition_permute(slots, vals, num_out=m))!r}, "
        f"plain_ms={time_ms(lambda: ref.partition_permute_ref(slots, vals, num_out=m))!r}, "
        f"bound_ms={tb[0]!r}")

    # ---- COMB on the replay's sorted, compacted ids -----------------------
    keys = zipf_keys(n, KEYS, ALPHA, gen, dev)
    order, head, seg = _segment_layout(keys, WORKERS)
    ids = seg.to(torch.int32)
    s_count = int(seg[-1]) + 1
    routed = vals[order].contiguous()
    got = segment_combine(ids, routed, num_segments=s_count)
    plain = ref.segment_combine_ref(ids, routed, num_segments=s_count)
    exact = torch.zeros((s_count, d), dtype=torch.float64, device=dev)
    exact.index_add_(0, seg, routed.double())
    lens = torch.bincount(seg, minlength=s_count).double()[:, None]
    # positive inputs: sum|v| is the exact sum.  f32 summation bound:
    # |fl(sum) - sum| <= len_seg * 2^-24 * sum|v| per segment and column
    tol = lens * U32 * exact
    kerr = (got.double() - exact).abs()
    assert bool((kerr <= tol).all()), "COMB outside the f32 summation bound"
    err = float((got.double() - plain.double()).abs().max())
    assert bool(((got.double() - plain.double()).abs() <= 2 * tol).all())
    lib_out = torch.zeros((s_count, d), dtype=torch.float32, device=dev)
    tb = bound(4 * n + 4 * n * d + 4 * s_count * d, n * d, F32_OPS_PER_S)
    rows["segment_combine"] = dict(
        max_abs_err=err, tolerance="len_seg*2^-24*sum|v| against the exact sum",
        ms=time_ms(lambda: segment_combine(ids, routed,
                                           num_segments=s_count)),
        plain_ms=time_ms(lambda: ref.segment_combine_ref(
            ids, routed, num_segments=s_count)),
        library_ms=time_ms(lambda: lib_out.index_add_(0, seg, routed)),
        bound_ms=tb[0], bound_by=tb[1], segments=s_count)
    log(f"kernel COMB sorted ids n={n} S={s_count} d={d} f32: "
        f"{json.dumps(rows['segment_combine'])}")

    # ---- the ordered fold: bit-identical for sum / min / max --------------
    # segments of 1..FOLD_MAX_SEG rows, so the plain loop takes <= 64 steps
    lens = torch.randint(1, FOLD_MAX_SEG + 1, (n,), device=dev, generator=gen)
    starts = torch.cumsum(lens, 0)
    starts = starts[starts < n]
    is_start = torch.zeros(n, dtype=torch.bool, device=dev)
    is_start[0] = True
    is_start[starts] = True
    v64 = torch.randn((n, d), dtype=torch.float64, device=dev, generator=gen)
    special = torch.rand((n, d), device=dev, generator=gen) < 1e-3
    picks = torch.tensor([float("nan"), 0.0, -0.0, float("inf")],
                         dtype=torch.float64, device=dev)
    v64[special] = picks[torch.randint(0, 4, (int(special.sum()),),
                                       device=dev, generator=gen)]
    for op in ("sum", "min", "max"):
        got = segmented_fold(op, is_start, v64)
        plain = ref.segmented_fold_ref(op, is_start, v64)
        # bit-identical, except that a NaN matches any NaN: IEEE leaves an
        # arithmetic NaN's payload unspecified
        same = (got.view(torch.int64) == plain.view(torch.int64)) \
            | (got.isnan() & plain.isnan())
        assert bool(same.all()), f"fold {op} differs from the plain version"
    tb = bound(n + 8 * n * d + 8 * n * d, n * d, F64_OPS_PER_S)
    rows["segmented_fold"] = dict(
        max_abs_err=0.0, tolerance="bit-identical (sum, min, max; NaN=NaN)",
        ms=time_ms(lambda: segmented_fold("sum", is_start, v64)),
        plain_ms=time_ms(lambda: ref.segmented_fold_ref("sum", is_start, v64),
                         reps=3, warmup=1),
        library_ms=None, bound_ms=tb[0], bound_by=tb[1],
        longest_segment=FOLD_MAX_SEG)
    log(f"kernel fold n={n} d={d} f64 segments 1..{FOLD_MAX_SEG}: "
        f"{json.dumps(rows['segmented_fold'])}")

    # the fold on the global stage's own layout: one hot Zipf key is one
    # long segment walked in order (latency, not bytes, bounds this one)
    zs, zv = head.contiguous(), routed.double()
    longest = int(torch.bincount(seg).max())
    log(f"kernel fold on the Zipf global layout n={n} longest={longest}: "
        f"ms={time_ms(lambda: segmented_fold('sum', zs, zv), reps=5)!r}")
    return rows


# ---------------------------------------------------------------------------
# 4. slice phase
# ---------------------------------------------------------------------------

def _stats_identical(a: dict, b: dict) -> None:
    import math
    for k in ("total_bytes", "sample_bytes", "bytes_per_level",
              "recv_bytes_per_worker", "bytes_per_tenant"):
        assert a[k] == b[k], (k, a[k], b[k])
    assert math.isclose(a["modelled_time_s"], b["modelled_time_s"],
                        rel_tol=1e-9, abs_tol=1e-18)
    for t in a["cost_per_tenant"]:
        assert math.isclose(a["cost_per_tenant"][t], b["cost_per_tenant"][t],
                            rel_tol=1e-9, abs_tol=1e-18)


def _sum_bound(bufs, ws):
    """Per key: rows and sum of |v| over the whole input (every key lands
    at exactly one destination)."""
    import numpy as np
    keys = np.concatenate([bufs[w].keys for w in ws])
    vals = np.concatenate([bufs[w].vals for w in ws])
    rows = np.bincount(keys, minlength=KEYS)
    absum = np.stack([np.bincount(keys, weights=np.abs(vals[:, c]),
                                  minlength=KEYS) for c in range(WIDTH)], 1)
    return rows, absum


def slice_phase(dev, profile_dir: Path | None) -> dict:
    import numpy as np
    import torch

    import repro_torch.core as port
    from repro_torch.core import torchplan
    from repro_torch.kernels import KERNELS

    topo = port.datacenter(4, 5, 2, intra_server_bw=12.5e9,
                           intra_rack_bw=1.25e9, oversubscription=10.0)
    assert topo.num_workers == WORKERS
    ws = list(range(WORKERS))
    t0 = time.perf_counter()
    bufs = zipf_shards(seed=0)
    log(f"slice data: {WORKERS} workers x {ROWS_PER_WORKER} rows x {WIDTH} "
        f"f64 ({sum(m.nbytes for m in bufs.values()) / 1e6:.0f} MB wire), "
        f"made in {time.perf_counter() - t0:.2f} s")
    rows_per_key, absum = _sum_bound(bufs, ws)
    launches = {k.__name__: 0 for k in KERNELS}
    out = {}
    for template in TEMPLATES:
        cl = port.TeShuCluster(topo, device=dev)       # executor="torch"
        client = cl.tenant()
        t0 = time.perf_counter()
        miss = client.shuffle(template, copy_bufs(bufs), ws, ws,
                              comb_fn=port.SUM)
        miss_s = time.perf_counter() - t0
        assert miss.engine == "threaded" and not miss.cached
        inputs = [copy_bufs(bufs) for _ in range(HITS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in KERNELS:                 # the main path, counted alone
            k.launches = 0
        walls, hits = [], []
        for b in inputs:
            t0 = time.perf_counter()
            hits.append(client.shuffle(template, b, ws, ws, comb_fn=port.SUM))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = {k.__name__: k.launches for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        for k, c in counts.items():
            launches[k] += c
        for h in hits:
            assert h.engine == "torch" and h.fallback_reason is None, \
                (h.engine, h.fallback_reason)
            assert h.cached
        assert all(c > 0 for c in counts.values()), counts
        hit = hits[-1]
        # the port's own vectorized replay is the yardstick
        vec = client.shuffle(template, copy_bufs(bufs), ws, ws,
                             comb_fn=port.SUM, executor="vectorized")
        assert vec.engine == "vectorized"
        worst = 0.0
        for w in ws:
            a, b = hit.bufs[w], vec.bufs[w]
            assert a.keys.dtype == np.int64 and a.vals.dtype == np.float64
            assert np.array_equal(a.keys, b.keys)
            assert np.isfinite(a.vals).all() and a.vals.shape == b.vals.shape
            # SUM per key on float32: each input rounds to f32 (2^-24 |v|)
            # and the summation adds at most len * 2^-24 * sum|v|
            tol = (rows_per_key[a.keys, None] + 1) * U32 * absum[a.keys]
            diff = np.abs(a.vals - b.vals)
            assert (diff <= tol).all(), f"{template}: dst {w} outside bound"
            worst = max(worst, float(diff.max(initial=0.0)))
        _stats_identical(hit.stats, vec.stats)
        # the exact plane: byte-identical with the kernel plane off
        prev = torchplan.set_kernel_plane(False)
        exact = client.shuffle(template, copy_bufs(bufs), ws, ws,
                               comb_fn=port.SUM)
        torchplan.set_kernel_plane(prev)
        assert exact.engine == "torch"
        for w in ws:
            assert np.array_equal(exact.bufs[w].keys, vec.bufs[w].keys)
            assert np.array_equal(exact.bufs[w].vals.view(np.int64),
                                  vec.bufs[w].vals.view(np.int64))
        _stats_identical(exact.stats, vec.stats)
        nrows = sum(m.n for m in hit.bufs.values())
        out[template] = dict(
            miss_s=miss_s, hit_s=statistics.median(walls), hit_walls=walls,
            peak_device_bytes=peak, launches=counts, out_rows=nrows,
            max_abs_err_vs_vectorized=worst)
        log(f"slice {template}: {json.dumps(out[template])}")
        if profile_dir is not None:
            _profile_hit(client, template, bufs, ws, profile_dir)
    out["launches"] = launches
    return out


def _profile_hit(client, template, bufs, ws, profile_dir: Path) -> None:
    """One more hit under torch.profiler: device time by kernel and host
    time by replay phase (the ``teshu.*`` ranges of torchplan)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as port
    b = copy_bufs(bufs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.shuffle(template, b, ws, ws, comb_fn=port.SUM)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_dir.mkdir(parents=True, exist_ok=True)
    ka = prof.key_averages()
    (profile_dir / f"profile_{template}.txt").write_text(
        ka.table(sort_by="cuda_time_total", row_limit=40))
    # each teshu.* range appears twice: once on the host (CPU time) and
    # once as a device annotation spanning the range's device work
    phases: dict[str, float] = {}
    for e in ka:
        if e.key.startswith("teshu."):
            phases[e.key] = max(phases.get(e.key, 0.0), e.cpu_time_total / 1e3)
    busy = sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("teshu.")
               and e.name != "Activity Buffer Request") / 1e3
    log(f"profile {template}: wall_ms={wall * 1e3!r} device_busy_ms={busy!r} "
        f"phases_host_ms={json.dumps(phases)}")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="trace one hit per template into this directory")
    args = ap.parse_args()
    if not __debug__:
        sys.exit("chip_smoke.py checks its results with assert: run it "
                 "without -O")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import KERNELS, _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(nvidia_smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{len(_build.SOURCES)} sources (nvcc {_build.BUILD_INFO['seconds']})")
    for name, report in _build.BUILD_INFO["ptxas"].items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    krows = kernel_phase(dev)
    log(f"kernel phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sl = slice_phase(dev, args.profile)
    log(f"slice phase: {time.perf_counter() - t0:.2f} s")

    sources = {"partition_permute": ("partition.cu",
                                     "src/repro/kernels/partition.py:102"),
               "segment_combine": ("combine.cu",
                                   "src/repro/kernels/combine.py:93"),
               "segmented_fold": ("fold.cu", "src/repro/core/jaxplan.py:326")}
    line = []
    for k in KERNELS:
        r = krows[k.__name__]
        src, replaces = sources[k.__name__]
        line.append({
            "name": k.__name__, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": sl["launches"][k.__name__],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    assert all(e["launches"] > 0 for e in line)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
