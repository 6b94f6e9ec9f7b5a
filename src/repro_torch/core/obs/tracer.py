"""Per-shuffle span tracing into a bounded in-memory flight recorder.

A *span* is one timed step of a shuffle's life — plan lookup, sampling,
lowering, a hierarchy stage, the global exchange, a recovery attempt, a
stream feed — tagged with the shuffle id, tenant, and engine that produced
it.  Spans opened while another span of the same thread is active nest under
it (``parent_id``), so the service's root ``"shuffle"`` span groups the
executor's per-stage spans into a tree without any of the emitting layers
knowing about each other.

Two tracer implementations share the same surface:

* :class:`FlightRecorder` — the enabled path: spans are timestamped with
  ``time.monotonic`` and, when closed, appended to a bounded ring buffer
  (``capacity`` most recent spans; older spans fall off, ``dropped`` counts
  them).  ``spans()`` filters by shuffle id / name; ``export_jsonl`` dumps
  the buffer one span per line for offline tooling (the doctor CLI).
* :class:`NullTracer` — the disabled path, and the default on every
  :class:`~repro_torch.core.primitives.LocalCluster`.  ``span()`` returns a shared
  no-op object and performs **no timestamp syscalls and no allocation**, so
  instrumented hot paths cost one attribute load and one no-op call when
  tracing is off.  Guard any attr-dict construction with ``tracer.enabled``.

Spans support both ``with tracer.span(...)`` (nests via a thread-local stack
and survives exceptions — the error is recorded as an attr) and manual
``sp = tracer.span(...); ...; sp.end()`` for loop bodies where a ``with``
block would force deep re-indentation.  A span abandoned without ``end()``
is simply never recorded.
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time


class _NullSpan:
    """Shared no-op span: safe to nest, set on, and end any number of times."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs) -> None:
        pass

    def end(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op, no clock is read."""

    enabled = False

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def point(self, name: str, **attrs) -> None:
        pass

    def spans(self, shuffle_id: int | None = None,
              name: str | None = None) -> list[dict]:
        return []

    def export_jsonl(self, path: str) -> int:
        return 0

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_TRACER = NullTracer()


class Span:
    """One live span; becomes a recorded dict when :meth:`end` fires."""

    __slots__ = ("_tracer", "span_id", "parent_id", "name", "shuffle_id",
                 "tenant", "attrs", "t0", "t1", "_entered")

    def __init__(self, tracer: "FlightRecorder", name: str,
                 shuffle_id: int | None, tenant: str | None, attrs: dict):
        self._tracer = tracer
        self.span_id = next(tracer._ids)
        self.parent_id = tracer._current_id()
        self.name = name
        self.shuffle_id = shuffle_id
        self.tenant = tenant
        self.attrs = attrs
        self.t0 = time.monotonic()
        self.t1: float | None = None
        self._entered = False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        if self.t1 is not None:        # idempotent: with-block + manual end
            return
        if attrs:
            self.attrs.update(attrs)
        self.t1 = time.monotonic()
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._pop(self)
        if exc is not None and self.t1 is None:
            self.attrs["error"] = f"{type(exc).__name__}: {exc}"
        self.end()
        return False

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "shuffle_id": self.shuffle_id,
            "tenant": self.tenant,
            "t0": self.t0,
            "t1": self.t1,
            "dur_s": (self.t1 - self.t0) if self.t1 is not None else None,
            "attrs": dict(self.attrs),
        }


class FlightRecorder:
    """Bounded ring buffer of finished spans (the enabled tracer)."""

    enabled = True

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self._buf: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.recorded_total = 0

    # ---- span lifecycle ----------------------------------------------------
    def span(self, name: str, *, shuffle_id: int | None = None,
             tenant: str | None = None, **attrs) -> Span:
        """Open a span.  Use as a context manager (nests under the thread's
        current span) or call ``.end()`` manually (reads the current parent at
        creation but never occupies the stack)."""
        return Span(self, name, shuffle_id, tenant, attrs)

    def point(self, name: str, *, shuffle_id: int | None = None,
              tenant: str | None = None, **attrs) -> None:
        """Record an instantaneous event as a zero-duration span."""
        Span(self, name, shuffle_id, tenant, attrs).end()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _current_id(self) -> int | None:
        st = getattr(self._tls, "stack", None)
        return st[-1].span_id if st else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()

    def _record(self, span: Span) -> None:
        with self._lock:
            self._buf.append(span.to_dict())
            self.recorded_total += 1

    # ---- introspection -----------------------------------------------------
    @property
    def dropped(self) -> int:
        """Spans that aged out of the ring buffer."""
        with self._lock:
            return self.recorded_total - len(self._buf)

    def spans(self, shuffle_id: int | None = None,
              name: str | None = None) -> list[dict]:
        with self._lock:
            out = list(self._buf)
        if shuffle_id is not None:
            out = [s for s in out if s["shuffle_id"] == shuffle_id]
        if name is not None:
            out = [s for s in out if s["name"] == name]
        return out

    def export_jsonl(self, path: str) -> int:
        """Write every buffered span as one JSON line; returns the count."""
        recs = self.spans()
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return len(recs)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.recorded_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)
