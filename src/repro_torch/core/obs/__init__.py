"""The shuffle telemetry plane: spans, metrics, and explainability.

One :class:`Observability` object per :class:`~repro_torch.core.primitives.LocalCluster`
carries the two halves of the plane:

* ``obs.metrics`` — the always-on :class:`~repro_torch.core.obs.metrics.MetricsRegistry`
  (counter bumps are dict ops; surfaces that own authoritative counters
  publish through registered collectors);
* ``obs.tracer`` — the span tracer, a shared no-op :data:`NULL_TRACER` until
  :meth:`Observability.enable_tracing` swaps in a
  :class:`~repro_torch.core.obs.tracer.FlightRecorder` (the service's ``tracing``
  constructor knob does this).

Every layer that holds a cluster reference reaches the plane as
``cluster.obs`` — no globals, so concurrent clusters never share telemetry.
"""
from __future__ import annotations

from .explain import ShuffleReport, build_report
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .tracer import NULL_TRACER, FlightRecorder, NullTracer, Span

__all__ = [
    "Observability", "ShuffleReport", "build_report",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "FlightRecorder", "NullTracer", "NULL_TRACER", "Span",
]


class Observability:
    """Per-cluster telemetry handle: a metrics registry + a swappable tracer."""

    def __init__(self, *, tracing: bool = False, span_capacity: int = 8192):
        self.metrics = MetricsRegistry()
        self.tracer = (FlightRecorder(span_capacity) if tracing
                       else NULL_TRACER)

    def enable_tracing(self, capacity: int = 8192) -> FlightRecorder:
        """Swap in a flight recorder (idempotent: an enabled tracer is kept)."""
        if not self.tracer.enabled:
            self.tracer = FlightRecorder(capacity)
        return self.tracer

    def disable_tracing(self) -> None:
        """Back to the shared no-op tracer; recorded spans are discarded."""
        self.tracer = NULL_TRACER
