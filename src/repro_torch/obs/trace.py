"""Host-side span tracing with bounded memory and cross-process merge.

A :class:`Tracer` records *spans* (named intervals with tags) and *events*
(instantaneous points) on the host monotonic clock into a bounded ring
buffer.  It is designed for the round hot path:

- When disabled, ``span()`` returns a shared no-op context manager and
  ``event()`` returns immediately — no allocation, no clock read.
- When enabled, a span costs two ``time.monotonic_ns()`` calls and one
  deque append.  Nothing here ever touches a device array (a device read
  inside instrumentation would force a host sync and corrupt the very
  timing being measured).
- The ring is bounded (``capacity``); evictions are counted in
  ``dropped`` so truncation is visible, never silent.

Spans carry a ``proc`` label ("server", "client-3", ...) identifying the
recording process.  Workers drain their rings and piggyback the dicts on
``MSG_METRIC``; the server shifts them by a heartbeat-derived clock
offset (:func:`merge_traces`) so one file shows the server's deadline
windows against each worker's compute/encode/send timeline.

Export formats:

- JSONL: one span/event dict per line (``write_jsonl`` / ``read_trace_jsonl``).
- Chrome/Perfetto trace events (``write_chrome_trace``): load the file in
  ``chrome://tracing`` or https://ui.perfetto.dev — each ``proc`` becomes
  a named process row, spans become "X" complete events, events become
  "i" instants.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional


class Span:
    """An open span; close it via the context-manager protocol or ``end()``."""

    __slots__ = ("_tracer", "name", "tags", "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, tags: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self.t0 = tracer._clock()
        self.t1: Optional[int] = None

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def end(self, **extra_tags: Any) -> None:
        if self.t1 is not None:
            return
        self.t1 = self._tracer._clock()
        if extra_tags:
            self.tags.update(extra_tags)
        self._tracer._append({
            "kind": "span", "name": self.name, "proc": self._tracer.proc,
            "t0": self.t0, "t1": self.t1, **self.tags,
        })


class _NoopSpan:
    """Shared disabled-path span: no clock reads, no allocation per use."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def end(self, **extra_tags: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Bounded ring buffer of span/event dicts on the monotonic clock."""

    def __init__(self, enabled: bool = True, proc: str = "main",
                 capacity: int = 65536,
                 clock: Callable[[], int] = time.monotonic_ns):
        self.enabled = enabled
        self.proc = proc
        self.capacity = int(capacity)
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **tags: Any):
        """Open a span; use as ``with tracer.span("phase", round=r): ...``."""
        if not self.enabled:
            return _NOOP_SPAN
        return Span(self, name, tags)

    def event(self, name: str, **tags: Any) -> None:
        """Record an instantaneous event."""
        if not self.enabled:
            return
        self._append({"kind": "event", "name": name, "proc": self.proc,
                      "t": self._clock(), **tags})

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    # -- draining / merging ------------------------------------------------

    def drain(self) -> List[Dict[str, Any]]:
        """Remove and return all buffered records (oldest first)."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def to_dicts(self) -> List[Dict[str, Any]]:
        """Snapshot buffered records without clearing."""
        with self._lock:
            return list(self._ring)

    def extend_from_dicts(self, dicts: Iterable[Dict[str, Any]],
                          offset_ns: int = 0,
                          proc: Optional[str] = None) -> None:
        """Absorb records from another process, shifting timestamps by
        ``offset_ns`` (remote clock + offset == local clock)."""
        for d in dicts:
            rec = dict(d)
            if proc is not None:
                rec["proc"] = proc
            for k in ("t0", "t1", "t"):
                if rec.get(k) is not None:
                    rec[k] = int(rec[k]) + offset_ns
            self._append(rec)

    # -- export ------------------------------------------------------------

    def write_jsonl(self, path: str) -> int:
        """Write buffered records as JSONL; returns the record count."""
        recs = self.to_dicts()
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return len(recs)


def read_trace_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def merge_traces(server_records: Iterable[Dict[str, Any]],
                 worker_records: Dict[str, List[Dict[str, Any]]],
                 offsets_ns: Dict[str, int]) -> List[Dict[str, Any]]:
    """Merge worker record lists into the server timeline.

    ``worker_records`` maps proc label -> that worker's raw records (on its
    own monotonic clock); ``offsets_ns`` maps the same labels to the
    estimated ``server_clock - worker_clock`` offset.  Returns one list
    sorted by start time, all on the server clock.
    """
    merged: List[Dict[str, Any]] = [dict(r) for r in server_records]
    for proc, recs in worker_records.items():
        off = int(offsets_ns.get(proc, 0))
        for d in recs:
            rec = dict(d)
            rec["proc"] = proc
            for k in ("t0", "t1", "t"):
                if rec.get(k) is not None:
                    rec[k] = int(rec[k]) + off
            merged.append(rec)
    merged.sort(key=lambda r: r.get("t0", r.get("t", 0)))
    return merged


def write_chrome_trace(records: Iterable[Dict[str, Any]], path: str) -> int:
    """Export records as Chrome trace-event JSON (load in chrome://tracing
    or ui.perfetto.dev).  Timestamps are rebased to the earliest record so
    the viewer opens at t=0.  Returns the event count."""
    recs = list(records)
    starts = [r.get("t0", r.get("t")) for r in recs
              if r.get("t0", r.get("t")) is not None]
    base = min(starts) if starts else 0
    procs = sorted({r.get("proc", "main") for r in recs})
    pid_of = {p: i + 1 for i, p in enumerate(procs)}
    events: List[Dict[str, Any]] = []
    for p, pid in pid_of.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": p}})
    reserved = {"kind", "name", "proc", "t0", "t1", "t"}
    for r in recs:
        pid = pid_of.get(r.get("proc", "main"), 0)
        args = {k: v for k, v in r.items() if k not in reserved}
        if r.get("kind") == "span" and r.get("t1") is not None:
            events.append({
                "ph": "X", "name": r["name"], "pid": pid, "tid": 0,
                "ts": (int(r["t0"]) - base) / 1e3,
                "dur": (int(r["t1"]) - int(r["t0"])) / 1e3,
                "args": args,
            })
        else:
            t = r.get("t", r.get("t0"))
            if t is None:
                continue
            events.append({"ph": "i", "name": r["name"], "pid": pid,
                           "tid": 0, "ts": (int(t) - base) / 1e3,
                           "s": "p", "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


# -- process-global tracer -------------------------------------------------

_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    global _GLOBAL
    _GLOBAL = tracer
    return tracer


def configure_tracer(enabled: bool, proc: str = "main",
                     capacity: int = 65536) -> Tracer:
    """Replace the process-global tracer; returns the new one."""
    return set_tracer(Tracer(enabled=enabled, proc=proc, capacity=capacity))
