"""A unified metrics registry: counters, gauges, histograms, pull sources.

The FL stack accumulates numbers in half a dozen places — ``LinkStats``
byte totals, ``FaultyChannel`` drop/corrupt buckets, ``RetryPolicy``
resend/give-up counts on the engine, heartbeat RTTs and liveness flips on
the transport.  Rather than rewrite those (their internal counters are
load-bearing for checkpoints and benches), the registry absorbs them two
ways:

- **Push instruments**: ``counter()``/``gauge()``/``histogram()`` return
  get-or-create instruments for code that wants to record directly
  (heartbeat RTT, liveness transitions, round wall times).
- **Pull sources**: ``register_source(name, fn)`` registers a zero-arg
  callable evaluated at ``snapshot()`` time — the transport registers a
  source that reads its live ``LinkStats`` ledger, so bytes shown by
  ``/metrics`` are always the billed truth, never a shadow copy.

``snapshot()`` is a plain JSON-able dict rendered identically by
``metrics.jsonl``, the ``/metrics`` HTTP endpoint, and ``trace_report``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def get(self) -> float:
        return self.value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def get(self) -> Optional[float]:
        return self.value


class Histogram:
    """Bounded-reservoir histogram with on-demand quantiles.

    Keeps the most recent ``capacity`` observations plus exact running
    count/sum/min/max, so quantiles reflect recent behaviour while the
    aggregates stay lossless.
    """

    __slots__ = ("name", "capacity", "count", "total", "vmin", "vmax",
                 "_ring", "_lock")

    def __init__(self, name: str, capacity: int = 4096):
        self.name = name
        self.capacity = int(capacity)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._ring: List[float] = []
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            self.vmin = v if self.vmin is None else min(self.vmin, v)
            self.vmax = v if self.vmax is None else max(self.vmax, v)
            if len(self._ring) == self.capacity:
                self._ring.pop(0)
            self._ring.append(v)

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            data = sorted(self._ring)
        if not data:
            return None
        idx = min(len(data) - 1, max(0, int(round(q * (len(data) - 1)))))
        return data[idx]

    def summary(self) -> Dict[str, Any]:
        return {
            "count": self.count, "sum": self.total,
            "min": self.vmin, "max": self.vmax,
            "mean": (self.total / self.count) if self.count else None,
            "p50": self.quantile(0.50), "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create instrument registry plus pull-model sources."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sources: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str, capacity: int = 4096) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, capacity=capacity)
            return self._histograms[name]

    def register_source(self, name: str,
                        fn: Callable[[], Dict[str, Any]]) -> None:
        """Register a zero-arg callable polled at snapshot time.  The
        callable must return a JSON-able dict; exceptions are captured
        into the snapshot rather than propagated (a dead source must not
        take down ``/metrics``)."""
        with self._lock:
            self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time JSON-able view of every instrument and source."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            sources = dict(self._sources)
        snap: Dict[str, Any] = {
            "uptime_s": time.monotonic() - self._t0,
            "counters": {n: c.get() for n, c in sorted(counters.items())},
            "gauges": {n: g.get() for n, g in sorted(gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(histograms.items())},
        }
        src_out: Dict[str, Any] = {}
        for name, fn in sorted(sources.items()):
            try:
                src_out[name] = fn()
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                src_out[name] = {"error": f"{type(e).__name__}: {e}"}
        snap["sources"] = src_out
        return snap


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _GLOBAL
    _GLOBAL = registry
    return registry
