"""Span tracing with bounded memory, device marks and cross-process merge.

A :class:`Tracer` records *spans* (named intervals with tags) and *events*
(instantaneous points) into a bounded ring buffer. It is designed for the
round hot path:

- When disabled, ``span()`` returns a shared no-op context manager and
  ``event()`` returns immediately: no allocation, no clock read, no
  device event.
- When enabled, a span costs two clock reads and one deque append. Its
  clock is the injected ``clock`` callable (default :func:`now_ns`); the
  clock only stamps records and never feeds a computed value.
- The ring is bounded (``capacity``); evictions are counted in
  ``dropped`` so truncation is visible, never silent.

**Clock.** :func:`now_ns` reads Unix-epoch nanoseconds, the clock
torch.profiler stamps its records with, so a span and a profiler record
of the same moment carry the same time, and a profile's Chrome trace can
take the spans (:func:`add_to_chrome_trace`). The transport's heartbeat
stamps read it too, so worker spans merge onto the server's timeline.

**Parents.** Every span records an ``id`` (unique within its tracer) and
the ``parent`` id of the span open around it on the same thread (None at
the root), and ``tid``, the tracer's index of that thread. A Chrome
export puts each thread on a row of its own, where children nest in their
parents.

**Device marks.** A span opened with ``device=`` a CUDA device records a
timing ``torch.cuda.Event`` on that device's current stream at open and
at close (events are not kernels: they add no device record). The marks
wait until the caller, at a host sync it makes anyway, calls
``sync_point(device)`` (one more event ``E``, waited on, then the clock
read ``h``) and ``settle(E, h)``: the device has then finished everything
up to ``E``, so it reached each earlier mark at ``h − elapsed(mark, E)``,
written into the span's record as ``d0``/``d1`` on the tracer's clock.
Marks that are never settled (drained first, another device, more than
``MAX_PENDING`` waiting) are counted in ``unsettled``.

**Registry fold.** ``settle(..., rounds=R)`` also folds the spans closed
since the last settle into the meter registry: per span name one
observation per round of histogram ``<name>_ms`` (the host ms summed over
the block, over ``R``), and for device-marked names one of
``<name>.device_ms`` (``d1 − d0`` summed, over ``R``). ``/metrics`` and
``meters.json`` then show per-phase quantiles without the trace file.

**Layer spans and counts.** A model layer opens its span with
:func:`layer_span` and adds its counts with :func:`layer_count`: both do
nothing with the tracer off, and nothing while the current stream
captures a CUDA graph (a replay runs no host code, so a span or a count
recorded in the capture would stand for every replay but be seen once).
A count given as a device tensor is added on the device into the
tracer's accumulator and read back once, at the next settle, which comes
after the host sync its caller makes anyway; it lands in the registry's
counter ``<name>`` (a scalar) or ``<name>.<i>`` (element i).

Spans carry a ``proc`` label ("server", "client-3", ...) identifying the
recording process. Workers drain their rings and piggyback the dicts on
``MSG_METRIC``; the server shifts them by a heartbeat-derived clock
offset (:func:`merge_traces`) so one file shows the server's deadline
windows against each worker's compute/encode/send timeline.

Export formats:

- JSONL: one span/event dict per line (``write_jsonl`` / ``read_trace_jsonl``).
- Chrome/Perfetto trace events (``write_chrome_trace``): load the file in
  ``chrome://tracing`` or https://ui.perfetto.dev. Each ``proc`` becomes
  a named process, each thread a row of its spans ("X" complete events)
  and events ("i" instants), and device-marked spans a ``device`` row of
  their own.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.obs.meters import get_registry

# device marks waiting for a settle; past this the oldest are unsettled
MAX_PENDING = 4096
# the Chrome export's row of the device-marked spans of a proc
DEVICE_TID = 1 << 20


def now_ns() -> int:
    """The tracer's default clock: Unix-epoch nanoseconds, as
    torch.profiler stamps its records."""
    return time.time_ns()


def cuda_marker(device) -> Optional[torch.cuda.Event]:
    """A timing event recorded on ``device``'s current stream, or None
    where ``device`` is no CUDA device."""
    if device is None or torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Span:
    """An open span; close it via the context-manager protocol or ``end()``."""

    __slots__ = ("_tracer", "name", "tags", "id", "parent", "tid", "t0",
                 "t1", "_device", "_m0")

    def __init__(self, tracer: "Tracer", name: str, tags: Dict[str, Any],
                 device=None):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self.id = next(tracer._ids)
        self.tid, stack = tracer._thread()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._device = device
        self.t0 = tracer._clock()
        self._m0 = None if device is None else tracer._marker(device)
        self.t1: Optional[int] = None

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def end(self, **extra_tags: Any) -> None:
        if self.t1 is not None:
            return
        m1 = None if self._m0 is None else self._tracer._marker(self._device)
        self.t1 = self._tracer._clock()
        _, stack = self._tracer._thread()
        if self in stack:
            stack.remove(self)
        if extra_tags:
            self.tags.update(extra_tags)
        self._tracer._close({
            "kind": "span", "name": self.name, "proc": self._tracer.proc,
            "id": self.id, "parent": self.parent, "tid": self.tid,
            "t0": self.t0, "t1": self.t1, **self.tags,
        }, self._m0, m1)


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
    """Bounded ring buffer of span/event dicts, stamped by ``clock``;
    ``marker(device)`` records a device mark (default :func:`cuda_marker`).
    ``settle`` folds into the process-global meter registry."""

    def __init__(self, enabled: bool = True, proc: str = "main",
                 capacity: int = 65536,
                 clock: Callable[[], int] = now_ns,
                 marker: Callable[[Any], Any] = cuda_marker):
        self.enabled = enabled
        self.proc = proc
        self.capacity = int(capacity)
        self._clock = clock
        self._marker = marker
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._tids = itertools.count()
        # spans closed since the last settle, and their device marks
        self._block: deque = deque(maxlen=self.capacity)
        self._pending: List[Tuple[Dict[str, Any], Any, Any]] = []
        # counts since the last settle: host ints and device accumulators
        self._counts: Dict[str, Any] = {}
        self.dropped = 0
        self.unsettled = 0

    # -- recording ---------------------------------------------------------

    def span(self, name: str, *, device=None, **tags: Any):
        """Open a span; use as ``with tracer.span("phase", round=r): ...``.
        ``device``: mark the span on that CUDA device's stream as well."""
        if not self.enabled:
            return _NOOP_SPAN
        return Span(self, name, tags, device)

    def event(self, name: str, **tags: Any) -> None:
        """Record an instantaneous event."""
        if not self.enabled:
            return
        self._append({"kind": "event", "name": name, "proc": self.proc,
                      "tid": self._thread()[0], "t": self._clock(), **tags})

    def count(self, name: str, value) -> None:
        """Add ``value`` (an int, or an integer tensor of per-element
        counts, added on its device) to ``name``'s count, folded into the
        registry at the next settle."""
        if not self.enabled:
            return
        with self._lock:
            acc = self._counts.get(name)
            if isinstance(value, torch.Tensor):
                value = value.detach().to(torch.int64)
                self._counts[name] = (value.clone() if acc is None
                                      else acc.add_(value))
            else:
                self._counts[name] = (acc or 0) + int(value)

    def _thread(self) -> Tuple[int, List[Span]]:
        """This thread's row index and its stack of open spans."""
        loc = self._local
        if not hasattr(loc, "stack"):
            loc.tid, loc.stack = next(self._tids), []
        return loc.tid, loc.stack

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)

    def _close(self, rec: Dict[str, Any], m0, m1) -> None:
        self._append(rec)
        with self._lock:
            self._block.append(rec)
            if m0 is not None and m1 is not None:
                self._pending.append((rec, m0, m1))
                if len(self._pending) > MAX_PENDING:
                    self._pending.pop(0)
                    self.unsettled += 1

    # -- device marks and the registry fold --------------------------------

    def sync_point(self, device) -> Tuple[Any, int]:
        """``(E, h)``: a mark recorded on ``device`` and waited on, then
        the clock; E is None off CUDA."""
        end = self._marker(device)
        if end is not None:
            end.synchronize()
        return end, self._clock()

    def settle(self, end, host_ns: int, *, rounds: int = 1) -> int:
        """Write ``d0``/``d1`` into every pending span from the completed
        mark ``end`` that the clock read ``host_ns`` right after, then fold
        the spans closed since the last settle (``rounds`` rounds) into the
        registry. Returns the number of marks it could not settle."""
        if not self.enabled:
            return 0
        with self._lock:
            pending, self._pending = self._pending, []
            block = list(self._block)
            self._block.clear()
        missed = len(pending) if end is None else 0
        for rec, m0, m1 in pending if end is not None else ():
            try:
                rec["d0"] = host_ns - round(m0.elapsed_time(end) * 1e6)
                rec["d1"] = host_ns - round(m1.elapsed_time(end) * 1e6)
            except RuntimeError:    # another device, or a mark not recorded
                missed += 1
        self.unsettled += missed
        self._fold(block, max(int(rounds), 1))
        self._fold_counts()
        return missed

    def _fold_counts(self) -> None:
        """The counts since the last settle into the registry's counters:
        one read of each device accumulator, the device already past it."""
        with self._lock:
            counts, self._counts = self._counts, {}
        reg = get_registry()
        for name, acc in counts.items():
            vals = acc.tolist() if isinstance(acc, torch.Tensor) else acc
            if isinstance(vals, list):
                for i, v in enumerate(vals):
                    reg.counter(f"{name}.{i}").inc(v)
            else:
                reg.counter(name).inc(vals)

    def _fold(self, block: List[Dict[str, Any]], rounds: int) -> None:
        host: Dict[str, float] = {}
        dev: Dict[str, float] = {}
        for r in block:
            name = r["name"]
            host[name] = host.get(name, 0.0) + (r["t1"] - r["t0"]) / 1e6
            if "d0" in r:
                dev[name] = dev.get(name, 0.0) + (r["d1"] - r["d0"]) / 1e6
        reg = get_registry()
        for suffix, sums in (("_ms", host), (".device_ms", dev)):
            for name, ms in sums.items():
                hist = reg.histogram(name + suffix)
                for _ in range(rounds):
                    hist.observe(ms / rounds)
        if self.unsettled:
            reg.gauge("trace.unsettled_marks").set(self.unsettled)

    # -- draining / merging ------------------------------------------------

    def drain(self) -> List[Dict[str, Any]]:
        """Remove and return all buffered records (oldest first); marks
        still waiting for a settle leave unsettled."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            self.unsettled += len(self._pending)
            self._pending = []
        return out

    def to_dicts(self) -> List[Dict[str, Any]]:
        """Snapshot buffered records without clearing."""
        with self._lock:
            return list(self._ring)

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
    own clock); ``offsets_ns`` maps the same labels to the estimated
    ``server_clock - worker_clock`` offset. Returns one list sorted by
    start time, all on the server clock (device times too).
    """
    merged: List[Dict[str, Any]] = [dict(r) for r in server_records]
    for proc, recs in worker_records.items():
        off = int(offsets_ns.get(proc, 0))
        for d in recs:
            rec = dict(d)
            rec["proc"] = proc
            for k in ("t0", "t1", "t", "d0", "d1"):
                if rec.get(k) is not None:
                    rec[k] = int(rec[k]) + off
            merged.append(rec)
    merged.sort(key=lambda r: r.get("t0", r.get("t", 0)))
    return merged


def chrome_events(records: Iterable[Dict[str, Any]], base_ns: int,
                  pid0: int = 1) -> List[Dict[str, Any]]:
    """Records as Chrome trace events in µs after ``base_ns``: one process
    per ``proc`` (pids from ``pid0``), one row per recording thread, and a
    ``device`` row for the device-marked spans."""
    recs = list(records)
    procs = sorted({r.get("proc", "main") for r in recs})
    pid_of = {p: pid0 + i for i, p in enumerate(procs)}
    events: List[Dict[str, Any]] = []
    for p, pid in pid_of.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": p}})
    for pid in sorted({pid_of[r.get("proc", "main")] for r in recs
                       if r.get("d0") is not None}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": DEVICE_TID, "args": {"name": "device"}})
    reserved = {"kind", "name", "proc", "tid", "t0", "t1", "t", "d0", "d1"}
    for r in recs:
        pid = pid_of[r.get("proc", "main")]
        tid = r.get("tid", 0)
        args = {k: v for k, v in r.items() if k not in reserved}
        if r.get("kind") == "span" and r.get("t1") is not None:
            events.append({
                "ph": "X", "name": r["name"], "pid": pid, "tid": tid,
                "ts": (int(r["t0"]) - base_ns) / 1e3,
                "dur": (int(r["t1"]) - int(r["t0"])) / 1e3,
                "args": args,
            })
            if r.get("d0") is not None:
                events.append({
                    "ph": "X", "name": r["name"], "pid": pid,
                    "tid": DEVICE_TID, "ts": (int(r["d0"]) - base_ns) / 1e3,
                    "dur": (int(r["d1"]) - int(r["d0"])) / 1e3,
                    "args": args,
                })
        else:
            t = r.get("t", r.get("t0"))
            if t is None:
                continue
            events.append({"ph": "i", "name": r["name"], "pid": pid,
                           "tid": tid, "ts": (int(t) - base_ns) / 1e3,
                           "s": "p", "args": args})
    return events


def write_chrome_trace(records: Iterable[Dict[str, Any]], path: str) -> int:
    """Export records as Chrome trace-event JSON (load in chrome://tracing
    or ui.perfetto.dev). Timestamps are rebased to the earliest record so
    the viewer opens at t=0. Returns the event count."""
    recs = list(records)
    starts = [r.get("t0", r.get("t")) for r in recs
              if r.get("t0", r.get("t")) is not None]
    events = chrome_events(recs, min(starts) if starts else 0)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def add_to_chrome_trace(path: str, records: Iterable[Dict[str, Any]]) -> int:
    """Add records to a Chrome trace that torch.profiler exported, on its
    ``baseTimeNanoseconds`` and under pids of their own, so one view shows
    the spans (and their device rows) over the profiler's records.
    Returns the number of events added."""
    with open(path) as f:
        doc = json.load(f)
    pids = [e["pid"] for e in doc.get("traceEvents", [])
            if isinstance(e.get("pid"), int)]
    events = chrome_events(records, int(doc.get("baseTimeNanoseconds", 0)),
                           pid0=max(pids, default=0) + 1)
    doc.setdefault("traceEvents", []).extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


# -- process-global tracer -------------------------------------------------

_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    global _GLOBAL
    _GLOBAL = tracer
    return tracer


def _silent(like: torch.Tensor) -> bool:
    """Whether a layer records nothing: the tracer off, or ``like``'s
    stream capturing a CUDA graph."""
    if not _GLOBAL.enabled:
        return True
    return (like.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def layer_span(name: str, like: torch.Tensor):
    """A span around a model layer's forward call, marked on the device of
    ``like`` (an input of the call) where that is a CUDA device; the
    shared no-op span where the layer is silent (``_silent``)."""
    if _silent(like):
        return _NOOP_SPAN
    dev = like.device if like.device.type == "cuda" else None
    return _GLOBAL.span(name, device=dev)


def layer_count(name: str, value, like: torch.Tensor) -> None:
    """``Tracer.count`` on the process tracer, unless the layer is silent
    (``_silent``)."""
    if not _silent(like):
        _GLOBAL.count(name, value)


def configure_tracer(enabled: bool, proc: str = "main",
                     capacity: int = 65536) -> Tracer:
    """Replace the process-global tracer; returns the new one."""
    return set_tracer(Tracer(enabled=enabled, proc=proc, capacity=capacity))
