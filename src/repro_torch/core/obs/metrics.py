"""A small labelled-metrics registry: counters, gauges, histograms, collectors.

One :class:`MetricsRegistry` per cluster absorbs the service's ad-hoc stat
surfaces behind a single snapshot: layers increment named counter/gauge/
histogram *families* with free-form labels (``tenant=...``, ``engine=...``),
and stat owners that already keep authoritative counters (the plan cache, the
cost ledger, the jit replay cache) register *collectors* — callables sampled
at snapshot/export time — so the registry view reads the canonical source and
can never disagree with it.

``snapshot()`` returns a plain dict (name -> list of labelled samples);
``to_prometheus()`` renders the Prometheus text exposition format.  All
operations are thread-safe under one coarse lock; an increment is a dict
lookup + float add, cheap enough to stay always-on (the span tracer is the
opt-in half of the plane — see :mod:`repro_torch.core.obs.tracer`).
"""
from __future__ import annotations

import threading

# Default histogram bucket bounds (seconds-flavored; +Inf is implicit).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    """One named metric family: cells keyed by their label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._cells: dict[tuple, float] = {}

    def get(self, **labels) -> float:
        with self._lock:
            return self._cells.get(_label_key(labels), 0.0)

    def samples(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._cells.items())]


class Counter(_Family):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter increment must be >= 0: {value}")
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + value


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._cells[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics) per label set."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = lock
        # label key -> [per-bucket counts..., +Inf count, sum]
        self._cells: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = [0] * (len(self.buckets) + 1) + [0.0]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    cell[i] += 1
                    break
            else:
                cell[len(self.buckets)] += 1
            cell[-1] += float(value)

    def get(self, **labels) -> dict:
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            if cell is None:
                return {"count": 0, "sum": 0.0,
                        "buckets": {b: 0 for b in self.buckets}}
            counts, total = cell[:-1], cell[-1]
            cum, out = 0, {}
            for b, c in zip(self.buckets, counts):
                cum += c
                out[b] = cum
            return {"count": cum + counts[-1], "sum": total, "buckets": out}

    def samples(self) -> list[dict]:
        with self._lock:
            keys = list(self._cells)
        out = []
        for k in sorted(keys):
            out.append(dict(self.get(**dict(k)), labels=dict(k)))
        return out


class MetricsRegistry:
    """Named metric families + collectors; one per cluster."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, object] = {}
        self._collectors: list = []

    def _family(self, name: str, cls, help: str, **kwargs):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, threading.Lock(),
                                                 **kwargs)
            elif not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}")
            return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._family(name, Histogram, help, buckets=buckets)

    def register_collector(self, fn) -> None:
        """``fn()`` returns an iterable of ``(name, labels_dict, value)``
        samples, read at snapshot/export time.  Collectors are how surfaces
        that own their counters (plan cache, ledger, jit replay cache)
        publish through the registry without double-bookkeeping: the registry
        *reads* the canonical source, so the two can never drift apart."""
        with self._lock:
            self._collectors.append(fn)

    def _collected(self) -> dict[str, list[dict]]:
        with self._lock:
            collectors = list(self._collectors)
        out: dict[str, list[dict]] = {}
        for fn in collectors:
            for name, labels, value in fn():
                out.setdefault(name, []).append(
                    {"labels": dict(labels), "value": float(value)})
        return out

    def snapshot(self) -> dict:
        """Every family's labelled samples plus collector-sourced gauges:
        ``{name: [{"labels": {...}, "value": v} | histogram dict, ...]}``."""
        with self._lock:
            families = list(self._families.values())
        out = {fam.name: fam.samples() for fam in families}
        for name, samples in self._collected().items():
            out.setdefault(name, []).extend(samples)
        return out

    def get(self, name: str, **labels):
        """Convenience read of one cell (0/empty when never touched)."""
        with self._lock:
            fam = self._families.get(name)
        if fam is not None:
            return fam.get(**labels)
        for s in self._collected().get(name, ()):
            if s["labels"] == {str(k): str(v) for k, v in labels.items()}:
                return s["value"]
        return 0.0

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (collectors export as gauges)."""
        with self._lock:
            families = list(self._families.values())
        lines: list[str] = []
        for fam in sorted(families, key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            if isinstance(fam, Histogram):
                for s in fam.samples():
                    lbl = s["labels"]
                    for b, c in s["buckets"].items():
                        lines.append(f"{fam.name}_bucket"
                                     f"{_fmt_labels(lbl, le=_fmt_float(b))} {c}")
                    lines.append(f"{fam.name}_bucket"
                                 f"{_fmt_labels(lbl, le='+Inf')} {s['count']}")
                    lines.append(f"{fam.name}_sum{_fmt_labels(lbl)}"
                                 f" {_fmt_float(s['sum'])}")
                    lines.append(f"{fam.name}_count{_fmt_labels(lbl)}"
                                 f" {s['count']}")
            else:
                for s in fam.samples():
                    lines.append(f"{fam.name}{_fmt_labels(s['labels'])}"
                                 f" {_fmt_float(s['value'])}")
        for name, samples in sorted(self._collected().items()):
            lines.append(f"# TYPE {name} gauge")
            for s in samples:
                lines.append(f"{name}{_fmt_labels(s['labels'])}"
                             f" {_fmt_float(s['value'])}")
        return "\n".join(lines) + "\n"


def _fmt_float(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _fmt_labels(labels: dict, **extra) -> str:
    merged = {**labels, **extra}
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
