"""The port's observability: the mirror of tests/test_obs.py for
``repro_torch.obs`` (tracer ring, meters registry, HTTP endpoints,
structured logger), ``scripts/trace_report.py`` reading traces the port's
tracer writes, the ledger's overhead surfacing on the port's channel, and
a live socket run of the port's trainer with ``--trace`` and
``--metrics-port`` whose trace reconciles exactly with its ledger."""
import importlib.util
import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from repro_torch.comm.channel import InProcessChannel
from repro_torch.launch import train as train_mod
from repro_torch.obs import (Tracer, get_logger, merge_traces,
                             read_trace_jsonl, write_chrome_trace)
from repro_torch.obs.http import ObsHTTPServer
from repro_torch.obs.meters import MetricsRegistry
from repro_torch.obs.trace import DEVICE_TID, _NOOP_SPAN, chrome_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _load_trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(REPO, "scripts", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_span_records_tags_and_monotonic_interval():
    t = Tracer(enabled=True, proc="p1")
    with t.span("phase", round=3) as sp:
        sp.end(bytes=17)          # idempotent: __exit__ after end() is a no-op
    recs = t.drain()
    assert len(recs) == 1
    r = recs[0]
    assert r["kind"] == "span" and r["name"] == "phase" and r["proc"] == "p1"
    assert r["round"] == 3 and r["bytes"] == 17
    assert isinstance(r["t0"], int) and r["t1"] >= r["t0"]
    assert t.drain() == []        # drain cleared the ring


def test_event_records_instant():
    t = Tracer(enabled=True, proc="w")
    t.event("rx_frame", round=1, client=2, bytes=99, outcome="ok")
    (r,) = t.drain()
    assert r["kind"] == "event" and r["outcome"] == "ok" and "t" in r


def test_disabled_tracer_is_noop_and_allocation_free():
    t = Tracer(enabled=False)
    sp = t.span("x", round=0)
    assert sp is _NOOP_SPAN       # shared object: no per-call allocation
    with sp:
        sp.end(bytes=1)
    t.event("y")
    assert t.to_dicts() == []


def test_ring_bounds_memory_and_counts_drops():
    t = Tracer(enabled=True, capacity=4)
    for i in range(10):
        t.event("e", i=i)
    recs = t.drain()
    assert len(recs) == 4
    assert [r["i"] for r in recs] == [6, 7, 8, 9]     # oldest evicted
    assert t.dropped == 6                              # eviction is visible


def test_jsonl_roundtrip(tmp_path):
    t = Tracer(enabled=True)
    with t.span("a", k="v"):
        pass
    t.event("b")
    path = str(tmp_path / "trace.jsonl")
    assert t.write_jsonl(path) == 2
    back = read_trace_jsonl(path)
    assert [r["name"] for r in back] == ["a", "b"]


def test_merge_traces_shifts_worker_clocks():
    server = [{"kind": "span", "name": "round", "proc": "server",
               "t0": 1000, "t1": 2000, "round": 0}]
    worker = {"client-1": [
        {"kind": "span", "name": "worker.compute", "proc": "client-1",
         "t0": 100, "t1": 200, "round": 0},
        {"kind": "event", "name": "ef_push", "proc": "client-1", "t": 300}]}
    merged = merge_traces(server, worker, {"client-1": 1_000_000})
    by_name = {r["name"]: r for r in merged}
    assert by_name["worker.compute"]["t0"] == 1_000_100
    assert by_name["worker.compute"]["t1"] == 1_000_200
    assert by_name["ef_push"]["t"] == 1_000_300
    assert by_name["round"]["t0"] == 1000                 # server untouched
    starts = [r.get("t0", r.get("t")) for r in merged]
    assert starts == sorted(starts)


def test_chrome_trace_export(tmp_path):
    recs = [
        {"kind": "span", "name": "round", "proc": "server",
         "t0": 5_000_000, "t1": 9_000_000, "round": 0},
        {"kind": "event", "name": "rx_frame", "proc": "client-0",
         "t": 6_000_000, "bytes": 4},
    ]
    path = str(tmp_path / "t.json")
    n = write_chrome_trace(recs, path)
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    assert n == len(evs)
    metas = [e for e in evs if e["ph"] == "M"]
    assert {m["args"]["name"] for m in metas} == {"server", "client-0"}
    x = next(e for e in evs if e["ph"] == "X")
    assert x["ts"] == 0.0 and x["dur"] == 4000.0          # rebased, us units
    i = next(e for e in evs if e["ph"] == "i")
    assert i["ts"] == 1000.0 and i["args"]["bytes"] == 4


# ---------------------------------------------------------------------------
# the clock, parents, device marks and the registry fold
# ---------------------------------------------------------------------------


def test_span_clock_encloses_profiler_record():
    """A span around a ``record_function`` region under a CPU-activity
    torch.profiler run encloses that record's start and end: the tracer's
    clock is the one the profiler stamps its records with."""
    from torch.profiler import ProfilerActivity, profile, record_function

    t = Tracer(enabled=True)
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with t.span("outer", i=i):
                with record_function(f"region{i}"):
                    x @ x
    spans = {r["i"]: r for r in t.drain()}
    recs = {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("region")}
    assert len(spans) == len(recs) == 3
    for i, sp in spans.items():
        e = recs[f"region{i}"]
        assert sp["t0"] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= sp["t1"]


def _nested_records():
    t = Tracer(enabled=True, proc="p")
    with t.span("a"):
        with t.span("b"):
            t.event("e")
        with t.span("c") as c:
            c.end()               # closed early: d's parent is a, not c
            with t.span("d"):
                pass

    def other():
        with t.span("x"):
            pass

    th = threading.Thread(target=other)
    th.start()
    th.join(10)
    assert not th.is_alive()
    return t.drain()


def test_spans_record_ids_parents_and_threads():
    recs = {r["name"]: r for r in _nested_records()}
    a, b, c, d, x = (recs[n] for n in "abcdx")
    assert a["parent"] is None and x["parent"] is None
    assert b["parent"] == c["parent"] == d["parent"] == a["id"]
    assert len({r["id"] for r in (a, b, c, d, x)}) == 5
    assert a["tid"] == b["tid"] == recs["e"]["tid"] != x["tid"]


def test_chrome_trace_nests_children_in_their_parents(tmp_path):
    recs = _nested_records()
    path = str(tmp_path / "t.json")
    write_chrome_trace(recs, path)
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    by = {e["name"]: e for e in evs}
    for child in "bcd":
        e, p = by[child], by["a"]
        assert (e["pid"], e["tid"]) == (p["pid"], p["tid"])
        assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
        assert e["args"]["parent"] == p["args"]["id"]
    assert by["x"]["tid"] != by["a"]["tid"]


class _Mark:
    """A device mark standing for a timing event: ``at`` is the device
    time (ns) at which the stream reached it (None: never recorded)."""

    def __init__(self, at):
        self.at = at

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        if self.at is None or end.at is None:
            raise RuntimeError("event not recorded")
        return (end.at - self.at) / 1e6          # ms, as torch.cuda.Event


def _marked_tracer(dev_times):
    """A tracer on a hand-stepped clock whose marks come from
    ``dev_times`` in order, with its marker calls counted."""
    now = {"t": 0, "marks": 0}
    times = iter(dev_times)

    def marker(device):
        now["marks"] += 1
        return _Mark(next(times))

    t = Tracer(enabled=True, clock=lambda: now["t"], marker=marker)
    return t, now


def test_settle_arithmetic_with_injected_marks(traced):
    """The stream reached each mark at ``h − elapsed(mark, E)``: d0/d1 on
    the tracer's clock; an unmarked span gets none and costs no mark."""
    t, now = _marked_tracer([5_000, 9_000, 12_000])
    traced(t)
    now["t"] = 1_000
    with t.span("k", device="dev"):              # mark at device 5,000
        now["t"] = 2_000                         # closing mark at 9,000
    with t.span("host_only"):
        pass
    assert now["marks"] == 2
    now["t"] = 40_000
    end, h = t.sync_point("dev")                 # E at 12,000, h 40,000
    assert h == 40_000 and end.at == 12_000
    assert t.settle(end, h) == 0 and t.unsettled == 0
    k, host = t.drain()
    assert (k["t0"], k["t1"]) == (1_000, 2_000)
    assert k["d0"] == 40_000 - (12_000 - 5_000)
    assert k["d1"] == 40_000 - (12_000 - 9_000)
    assert "d0" not in host and "d1" not in host


def test_unsettled_marks_are_counted(traced, monkeypatch):
    from repro_torch.obs import trace as trace_mod

    t, now = _marked_tracer([1, 2, 3, 4, None, 6, 7, 8, 9, 10, 11, 12, 13])
    reg = traced(t)
    with t.span("a", device="dev"):
        pass
    assert t.settle(None, 5) == 1                # nothing to settle against
    with t.span("b", device="dev"):              # marks 3 and 4
        pass
    with t.span("c", device="dev"):              # a mark never recorded
        pass
    assert t.settle(*t.sync_point("dev")) == 1   # c; b settles
    with t.span("d", device="dev"):
        pass
    t.drain()                                    # drained before a settle
    monkeypatch.setattr(trace_mod, "MAX_PENDING", 1)
    with t.span("e", device="dev"):
        pass
    with t.span("f", device="dev"):              # pushes e out
        pass
    assert t.unsettled == 4
    recs = {r["name"]: r for r in t.drain()}
    assert "d0" not in recs["f"]
    t.settle(None, 0)
    assert t.unsettled == 5
    assert reg.snapshot()["gauges"]["trace.unsettled_marks"] == 5


def test_registry_fold_matches_drained_spans(traced):
    """One observation per round and span name of the host ms (and, for
    marked spans, the device ms) summed over the block, over its
    rounds."""
    t, now = _marked_tracer([100, 1_100_100, 5_000_000])
    reg = traced(t)
    for name, t0, t1, dev in (("a", 0, 2_000_000, "dev"),
                              ("b", 2_000_000, 3_000_000, None),
                              ("b", 3_000_000, 6_000_000, None)):
        now["t"] = t0
        sp = t.span(name, device=dev)
        now["t"] = t1
        sp.end()
    t.settle(*t.sync_point("dev"), rounds=2)
    recs = t.drain()
    hs = reg.snapshot()["histograms"]
    for name in ("a", "b"):
        host = sum((r["t1"] - r["t0"]) / 1e6 for r in recs
                   if r["name"] == name)
        assert hs[f"{name}_ms"]["count"] == 2
        assert hs[f"{name}_ms"]["sum"] == pytest.approx(host)
        assert hs[f"{name}_ms"]["p50"] == pytest.approx(host / 2)
    a = next(r for r in recs if r["name"] == "a")
    assert hs["a.device_ms"]["count"] == 2
    assert hs["a.device_ms"]["sum"] == pytest.approx((a["d1"] - a["d0"]) / 1e6)
    assert hs["a.device_ms"]["sum"] == pytest.approx(1.1)
    assert "b.device_ms" not in hs
    t.settle(None, 0)                            # an empty block adds none
    assert reg.snapshot()["histograms"]["a_ms"]["count"] == 2


# ---------------------------------------------------------------------------
# the phase spans of a round, driven by RoundEngine
# ---------------------------------------------------------------------------

N_LM = 3


def _lm_engine():
    """A 3SFC+EF round of the smoke mamba2 LM over ``N_LM`` clients (one
    local step of two 16-token sequences), its engine and first state."""
    import argparse

    import numpy as np

    from repro_torch.configs.base import CompressorConfig, get_smoke_config
    from repro_torch.fl.engine import RoundEngine, token_batcher
    from repro_torch.fl.round import build_fl_round

    cfg = get_smoke_config("mamba2-370m")
    args = argparse.Namespace(clients=N_LM, local_steps=1, lr=0.01, batch=2,
                              rounds=1, seed=0)
    comp = CompressorConfig(kind="threesfc", error_feedback=True,
                            syn_steps=2, syn_seq=4)
    model, strategy, run = train_mod.lm_setup(args, cfg, comp, 16)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16))
    engine = RoundEngine(build_fl_round(model.loss, strategy, run),
                         token_batcher(toks, N_LM, 1, 2), seed=0)
    params = model.init(torch.Generator().manual_seed(0))
    return engine, engine.init_state(params, N_LM, strategy)


@pytest.fixture
def traced(monkeypatch):
    """Install a process tracer and a fresh registry for one test."""
    from repro_torch.obs import meters as meters_mod
    from repro_torch.obs import trace as trace_mod

    def install(tracer):
        monkeypatch.setattr(trace_mod, "_GLOBAL", tracer)
        reg = MetricsRegistry()
        monkeypatch.setattr(meters_mod, "_GLOBAL", reg)
        return reg

    return install


def test_layer_spans_and_counts_silent_off_and_in_capture(traced,
                                                         monkeypatch):
    """``layer_span``/``layer_count``: nothing with the tracer off; with it
    on a span marked on a CUDA input's device and a count added, but
    nothing while the current stream captures a CUDA graph."""
    from types import SimpleNamespace

    from repro_torch.obs import layer_count, layer_span
    cpu = torch.zeros(2)
    traced(Tracer(enabled=False))
    assert layer_span("mla.attention", cpu) is _NOOP_SPAN
    layer_count("moe.slots", 5, cpu)
    t, now = _marked_tracer([1, 2, 3, 4])
    reg = traced(t)
    cuda = SimpleNamespace(device=torch.device("cuda"))
    capturing = {"on": True}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["on"])
    assert layer_span("mla.attention", cuda) is _NOOP_SPAN
    layer_count("moe.slots", 5, cuda)
    assert now["marks"] == 0 and t._counts == {}
    capturing["on"] = False
    with layer_span("mla.attention", cuda):
        pass
    with layer_span("moe.routed", cpu):          # a CPU input: no marks
        pass
    layer_count("moe.slots", 5, cuda)
    assert now["marks"] == 2
    t.settle(*t.sync_point("dev"))
    spans = {r["name"]: r for r in t.drain()}
    assert "d0" in spans["mla.attention"] and "d0" not in spans["moe.routed"]
    assert reg.snapshot()["counters"] == {"moe.slots": 5}


def test_device_counts_fold_into_counters_at_settle(traced):
    """Counts accumulate (ints on the host, tensors on their device) until
    a settle reads each once into the registry: a scalar as ``name``, a
    vector as ``name.<i>``; the next block starts from zero."""
    t = Tracer(enabled=True)
    reg = traced(t)
    t.count("moe.slots", 12)
    t.count("moe.slots", 6)
    t.count("moe.slots.held", torch.tensor([1, 0, 3]))
    t.count("moe.slots.held", torch.tensor([2, 2, 0], dtype=torch.int32))
    t.count("one", torch.tensor(4))
    assert reg.snapshot()["counters"] == {}
    t.settle(None, 0)
    assert reg.snapshot()["counters"] == {
        "moe.slots": 18, "moe.slots.held.0": 3, "moe.slots.held.1": 2,
        "moe.slots.held.2": 3, "one": 4}
    t.count("moe.slots.held", torch.tensor([1, 1, 1]))
    t.settle(None, 0)
    assert reg.snapshot()["counters"]["moe.slots.held.2"] == 4
    off = Tracer(enabled=False)
    off.count("moe.slots", 3)
    assert off._counts == {}


def test_engine_round_phase_spans_nest_in_dispatch(traced):
    """With tracing on, every round driven by ``RoundEngine`` yields N
    ``client.train``, N ``client.encode`` and one ``server.aggregate``,
    each a child of that round's ``engine.dispatch``, in that order; their
    host time fits in the dispatch; the registry fold matches the spans."""
    engine, state = _lm_engine()
    tracer = Tracer(enabled=True, proc="server")
    reg = traced(tracer)
    state, _ = engine.run(state, 3, eval_every=1)
    recs = tracer.drain()
    spans = [r for r in recs if r["kind"] == "span"]
    dispatch = [r for r in spans if r["name"] == "engine.dispatch"]
    assert len(dispatch) == 3
    want = [n for i in range(N_LM) for n in ("client.train", "client.encode")]
    for rnd, d in enumerate(dispatch):
        kids = [r for r in spans if r["parent"] == d["id"]]
        assert [r["name"] for r in kids] == want + ["server.aggregate"]
        assert [r.get("client") for r in kids] == [
            i for i in range(N_LM) for _ in "te"] + [None]
        assert all(r["round"] == rnd for r in kids)
        train = kids[0]
        assert train["K"] == 1 and train["num_micro"] == 1
        assert all(d["t0"] <= r["t0"] and r["t1"] <= d["t1"] for r in kids)
        assert sum(r["t1"] - r["t0"] for r in kids) <= d["t1"] - d["t0"]
    assert all("d0" not in r for r in spans)     # no device on the CPU
    assert tracer.unsettled == 0
    hs = reg.snapshot()["histograms"]
    for name in ("engine.dispatch", "engine.sync", "client.train",
                 "client.encode", "server.aggregate"):
        host = sum((r["t1"] - r["t0"]) / 1e6 for r in spans
                   if r["name"] == name)
        assert hs[f"{name}_ms"]["count"] == 3
        assert hs[f"{name}_ms"]["sum"] == pytest.approx(host)
    assert not any(k.endswith(".device_ms") for k in hs)
    # a block of two rounds: two observations of half the block's sum
    state, _ = engine.run_block(state, 2)
    recs = [r for r in tracer.drain() if r.get("name") == "client.train"]
    assert len(recs) == 2 * N_LM
    block = sum((r["t1"] - r["t0"]) / 1e6 for r in recs)
    h = reg.snapshot()["histograms"]["client.train_ms"]
    assert h["count"] == 5
    assert h["sum"] == pytest.approx(hs["client.train_ms"]["sum"] + block)


def test_engine_round_device_marks_through_the_round(traced):
    """The same round with a marker standing for the stream's events: two
    marks a phase span and one at the sync, every phase span settled, on
    the device row of the Chrome export; device times never decrease."""
    engine, state = _lm_engine()
    dev_t = {"t": 0}

    def marker(device):                  # a µs of device time a mark
        dev_t["t"] += 1_000
        return _Mark(dev_t["t"])

    tracer = Tracer(enabled=True, proc="server", marker=marker)
    reg = traced(tracer)
    state, _ = engine.run_block(state, 1)
    assert dev_t["t"] == 1_000 * (2 * (2 * N_LM + 1) + 1)
    recs = tracer.drain()
    phases = [r for r in recs if r["name"] in
              ("client.train", "client.encode", "server.aggregate")]
    assert len(phases) == 2 * N_LM + 1 and tracer.unsettled == 0
    marks = [m for r in phases for m in (r["d0"], r["d1"])]
    assert marks == sorted(marks) and all(r["d0"] <= r["d1"]
                                          for r in phases)
    hs = reg.snapshot()["histograms"]
    assert hs["client.encode.device_ms"]["count"] == 1
    assert hs["client.encode.device_ms"]["sum"] == pytest.approx(
        N_LM * 1_000 / 1e6)
    events = chrome_events(recs, 0)
    rows = [e for e in events if e["ph"] == "X" and e["tid"] == DEVICE_TID]
    assert sorted(e["name"] for e in rows) == sorted(r["name"]
                                                     for r in phases)


def test_tracing_off_round_creates_nothing(traced, monkeypatch):
    """With tracing off, the traced round's code reads no clock, records
    no mark, creates no ``torch.cuda.Event``, no span and no registry
    instrument."""
    engine, state = _lm_engine()
    made = {"events": 0, "clock": 0, "marks": 0}

    class Event:
        def __init__(self, *a, **k):
            made["events"] += 1

    monkeypatch.setattr(torch.cuda, "Event", Event)

    def clock():
        made["clock"] += 1
        return 0

    def marker(device):
        made["marks"] += 1

    tracer = Tracer(enabled=False, clock=clock, marker=marker)
    reg = traced(tracer)
    state, _ = engine.run(state, 2, eval_every=1)
    state, _ = engine.run_loop(state, 1)
    assert made == {"events": 0, "clock": 0, "marks": 0}
    assert tracer.to_dicts() == []
    snap = reg.snapshot()
    assert snap["counters"] == snap["gauges"] == snap["histograms"] == {}


# ---------------------------------------------------------------------------
# meters
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)                   # get-or-create: same instance
    reg.gauge("g").set(2.5)
    h = reg.histogram("h")
    for v in range(100):
        h.observe(float(v))
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 5
    assert snap["gauges"]["g"] == 2.5
    hs = snap["histograms"]["h"]
    assert hs["count"] == 100 and hs["min"] == 0.0 and hs["max"] == 99.0
    assert 45 <= hs["p50"] <= 55 and 90 <= hs["p95"] <= 99
    assert hs["p99"] >= hs["p95"] >= hs["p50"]


def test_histogram_ring_bounded():
    reg = MetricsRegistry()
    h = reg.histogram("h", capacity=8)
    for v in range(100):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 100                  # count/sum track everything
    assert s["p50"] >= 92.0                   # quantiles from the recent ring


def test_sources_polled_and_exception_captured():
    reg = MetricsRegistry()
    reg.register_source("ok", lambda: {"x": 1})

    def boom():
        raise RuntimeError("dead source")

    reg.register_source("bad", boom)
    snap = reg.snapshot()
    assert snap["sources"]["ok"] == {"x": 1}
    assert "RuntimeError" in snap["sources"]["bad"]["error"]
    reg.unregister_source("bad")
    assert "bad" not in reg.snapshot()["sources"]


def test_http_endpoints():
    reg = MetricsRegistry()
    reg.counter("hits").inc(3)
    srv = ObsHTTPServer(port=0, registry=reg)
    try:
        with urllib.request.urlopen(f"{srv.url}/healthz", timeout=5) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["uptime_s"] >= 0
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=5) as r:
            snap = json.loads(r.read())
        assert snap["counters"]["hits"] == 3
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{srv.url}/nope", timeout=5)
        assert ei.value.code == 404
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# structured logger
# ---------------------------------------------------------------------------


def test_logger_prefixes_context():
    # the "repro_torch" root logger is propagate=False (it owns its stderr
    # handler), so capture on the named logger itself
    records = []

    class Collect(logging.Handler):
        def emit(self, rec):
            records.append(rec.getMessage())

    log = get_logger("worker", client=7)
    assert log.logger.name == "repro_torch.worker"
    h = Collect()
    log.logger.addHandler(h)
    try:
        log.info("hello %d", 42)
        log.bind(round=3).info("served")
    finally:
        log.logger.removeHandler(h)
    assert records[0] == "[client=7] hello 42"
    assert records[1] == "[client=7 round=3] served"


# ---------------------------------------------------------------------------
# scripts/trace_report.py over traces the port's tracer writes
# ---------------------------------------------------------------------------


def _synthetic_trace(tmp_path):
    """tests/test_obs.py's two rounds of three clients, recorded through
    the port's ``Tracer`` (its clock stepped by hand) and read back from
    its JSONL: round 0 all delivered plus a filtered duplicate; round 1 a
    straggler (cid 1), a dead worker (cid 2)."""
    S = 1_000_000_000                                  # 1s in ns
    now = {"t": 0}
    server = Tracer(enabled=True, proc="server", clock=lambda: now["t"])
    worker = Tracer(enabled=True, proc="client-1", clock=lambda: now["t"])

    def span(tr, name, t0, t1, **tags):
        now["t"] = t0
        sp = tr.span(name, **tags)
        now["t"] = t1
        sp.end()

    def ev(name, t, **tags):
        now["t"] = t
        server.event(name, **tags)

    for rnd, base in ((0, 0), (1, 2 * S)):
        span(server, "round", base, base + S, round=rnd, deadline_s=0.5)
        for i, ph in enumerate(("encode", "broadcast", "collect", "ack",
                                "aggregate")):
            span(server, f"round.{ph}", base + i * 1000,
                 base + i * 1000 + 500, round=rnd, phase=ph)
        for cid in range(3):
            ev("tx_frame", base + 100, round=rnd, client=cid, bytes=200)
    for cid in range(3):
        ev("rx_frame", 500_000, round=0, client=cid, bytes=100, outcome="ok")
        ev("round.outcome", S, round=0, client=cid, outcome="delivered")
    ev("rx_frame", 600_000, round=0, client=0, bytes=100, outcome="filtered")
    ev("rx_frame", 2 * S + 500_000, round=1, client=0, bytes=100,
       outcome="ok")
    ev("round.outcome", 3 * S, round=1, client=0, outcome="delivered")
    ev("round.outcome", 3 * S, round=1, client=1, outcome="undelivered")
    ev("round.outcome", 3 * S, round=1, client=2, outcome="dead")
    span(worker, "worker.compute", 2 * S, 2 * S + 300_000_000, round=1)
    span(worker, "worker.straggle", 2 * S + 300_000_000, 4 * S, round=1,
         sleep_s=1.7)
    recs = merge_traces(server.drain(), {"client-1": worker.drain()},
                        {"client-1": 0})
    path = tmp_path / "trace.jsonl"
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return read_trace_jsonl(str(path)), path


def test_trace_report_phases_and_attribution(tmp_path):
    tr = _load_trace_report()
    recs, _ = _synthetic_trace(tmp_path)
    rep = tr.report(recs)
    assert rep["rounds"] == [0, 1]
    assert rep["phase_complete"] and rep["missing_phases"] == {}
    assert rep["phases"]["round"]["count"] == 2
    assert abs(rep["phases"]["round"]["p50"] - 1.0) < 1e-6    # 1s spans
    att = rep["attribution"]
    assert att["stragglers"] == {1: [1]}
    assert att["dead_workers"] == {2: [1]}
    assert att["frame_lost"] == {}            # the filtered frame was a dup
    causes = {(c["round"], c["client"]): c["cause"]
              for c in att["undelivered"]}
    assert causes == {(1, 1): "straggler", (1, 2): "dead"}


def test_trace_report_detects_missing_phase(tmp_path):
    tr = _load_trace_report()
    recs, _ = _synthetic_trace(tmp_path)
    recs = [r for r in recs
            if not (r.get("name") == "round.ack" and r.get("round") == 1)]
    rep = tr.report(recs)
    assert not rep["phase_complete"]
    assert rep["missing_phases"] == {"1": ["round.ack"]}


def test_trace_report_reconciliation_exact_and_mismatch(tmp_path):
    tr = _load_trace_report()
    recs, _ = _synthetic_trace(tmp_path)
    good = {"uplink": {"total_bytes": 500}, "downlink": {"total_bytes": 1200},
            "overhead_up": 77, "overhead_down": 88}
    rec = tr.reconcile(recs, good)
    assert rec["uplink_exact"] and rec["downlink_exact"]
    assert rec["overhead_up"] == 77 and rec["overhead_down"] == 88
    bad = {"uplink": {"total_bytes": 501}, "downlink": {"total_bytes": 1200}}
    rec = tr.reconcile(recs, bad)
    assert not rec["uplink_exact"] and rec["downlink_exact"]


def test_trace_report_replay_summary(tmp_path):
    tr = _load_trace_report()
    recs, _ = _synthetic_trace(tmp_path)
    rep = tr.replay_summary(recs)
    assert rep["schema"] == "repro.trace-replay/v1"
    assert [r["round"] for r in rep["rounds"]] == [0, 1]
    r0 = rep["rounds"][0]
    assert r0["wall_s"] == 1.0 and r0["deadline_s"] == 0.5
    assert r0["bytes_up"] == 400 and r0["bytes_down"] == 600
    assert r0["clients"]["0"]["outcome"] == "delivered"
    assert abs(r0["clients"]["0"]["arrival_s"] - 0.0005) < 1e-9
    r1 = rep["rounds"][1]
    assert r1["clients"]["1"]["outcome"] == "undelivered"
    assert r1["clients"]["1"]["arrival_s"] is None


def test_trace_report_cli(tmp_path):
    tr = _load_trace_report()
    _, trace = _synthetic_trace(tmp_path)
    ledger = tmp_path / "ledger.json"
    ledger.write_text(json.dumps(
        {"uplink": {"total_bytes": 500}, "downlink": {"total_bytes": 1200},
         "overhead_up": 0, "overhead_down": 0}))
    replay = tmp_path / "replay.json"
    rc = tr.main([str(trace), "--ledger", str(ledger),
                  "--replay", str(replay), "--json"])
    assert rc == 0
    assert json.loads(replay.read_text())["rounds"]


# ---------------------------------------------------------------------------
# ledger overhead surfacing
# ---------------------------------------------------------------------------


def test_ledger_roundtrips_overhead_and_defaults_old_snapshots():
    ch = InProcessChannel()
    ch.overhead_up += 123
    ch.overhead_down += 456
    led = ch.ledger()
    assert led["overhead_up"] == 123 and led["overhead_down"] == 456
    ch2 = InProcessChannel()
    ch2.restore_ledger(led)
    assert ch2.overhead_up == 123 and ch2.overhead_down == 456
    # a ledger without overhead keys: restore defaults them to 0
    old = {"uplink": led["uplink"], "downlink": led["downlink"]}
    ch3 = InProcessChannel()
    ch3.restore_ledger(old)
    assert ch3.overhead_up == 0 and ch3.overhead_down == 0


def test_live_history_surfaces_overhead():
    """The mirror of the reference's live-result test, on the port's
    checkpointed history: a live round's overhead rides through the JSON
    form a recovery point carries, and a record without it reads 0."""
    import numpy as np

    history = [{"round": 0, "wall_s": 0.5, "participate": np.ones(2, bool),
                "delivered": np.array([True, False]), "retries": 1,
                "bytes_up": 1000, "bytes_down": 2000, "overhead_up": 50,
                "overhead_down": 60, "dead": [1],
                "losses": {0: 1.0, 1: 3.0}}]
    js = json.loads(json.dumps(train_mod._history_to_json(history)))
    assert js[0]["overhead_up"] == 50 and js[0]["overhead_down"] == 60
    back = train_mod._history_from_json(js)
    assert back[0]["losses"] == {0: 1.0, 1: 3.0}
    assert back[0]["delivered"].tolist() == [True, False]
    old = dict(history[0])
    del old["overhead_up"], old["overhead_down"]
    js = train_mod._history_to_json([old])
    assert js[0]["overhead_up"] == 0 and js[0]["overhead_down"] == 0


# ---------------------------------------------------------------------------
# a live traced socket run of the port's trainer
# ---------------------------------------------------------------------------


@pytest.mark.transport(timeout=240)
def test_traced_socket_run_reconciles_with_its_ledger(tmp_path):
    """``--transport socket --trace --metrics-port 0`` over 2 CPU workers:
    /healthz and /metrics answer during the run, every round shows every
    phase, and the bytes the trace saw equal the ledger's exactly
    (``scripts/trace_report.py`` as a subprocess)."""
    import socket

    from repro_torch.obs import get_tracer

    with socket.socket() as s:                 # a free port for the run
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "run"
    fetched = {}

    def poll():
        # /healthz, then /metrics once the transport's ledger is a source
        url = f"http://127.0.0.1:{port}"
        end = time.monotonic() + 120
        while time.monotonic() < end and "metrics" not in fetched:
            try:
                with urllib.request.urlopen(f"{url}/healthz",
                                            timeout=2) as r:
                    fetched["healthz"] = json.loads(r.read())
                with urllib.request.urlopen(f"{url}/metrics",
                                            timeout=2) as r:
                    snap = json.loads(r.read())
                if "transport.ledger" in snap["sources"]:
                    fetched["metrics"] = snap
            except OSError:
                pass
            time.sleep(0.05)

    before = get_tracer()
    t = threading.Thread(target=poll, daemon=True)
    t.start()
    train_mod.main([
        "--compressor", "threesfc", "--wire", "codec",
        "--transport", "socket", "--rounds", "3", "--clients", "2",
        "--local-steps", "2", "--batch", "8", "--train-size", "128",
        "--eval-every", "1", "--device", "cpu", "--trace",
        "--metrics-port", str(port), "--round-deadline-s", "60",
        "--out", str(out)])
    t.join(5)
    assert get_tracer() is before          # the run's tracer ended with it
    assert fetched["healthz"]["status"] == "ok"
    assert "metrics" in fetched
    rows = [json.loads(l) for l in open(out / "metrics.jsonl")]
    assert [r["round"] for r in rows] == [1, 2, 3]
    assert all(r["delivered"] == 2 for r in rows)
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "trace_report.py"),
         str(out / "trace.jsonl"), "--ledger", str(out / "ledger.json"),
         "--json"], capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    rep = json.loads(p.stdout)
    assert rep["rounds"] == [0, 1, 2]
    assert rep["phase_complete"], rep["missing_phases"]
    rec = rep["reconciliation"]
    assert rec["uplink_exact"] and rec["downlink_exact"], rec
    assert rec["uplink_billed"] > 0 and rec["overhead_up"] > 0
    # the workers' own spans were merged onto the server's clock
    recs = read_trace_jsonl(str(out / "trace.jsonl"))
    names = {r["name"] for r in recs}
    assert {"worker.compute", "worker.decode", "worker.send"} <= names
    # the client step's phase spans are worker.compute's children
    spans = {(r["proc"], r["id"]): r for r in recs if r["kind"] == "span"}
    phases = [r for r in recs if r["name"] in ("client.train",
                                               "client.encode")]
    assert len(phases) == 2 * 2 * 3
    for r in phases:
        parent = spans[(r["proc"], r["parent"])]
        assert parent["name"] == "worker.compute"
        assert parent["round"] == r["round"]
    # one clock: each worker's compute sits in the server's round window
    rounds = {r["round"]: r for r in recs if r["name"] == "round"}
    slack = 50_000_000                           # 50 ms of offset error
    for r in recs:
        if r["name"] == "worker.compute":
            win = rounds[r["round"]]
            assert win["t0"] - slack <= r["t0"] <= r["t1"] <= win["t1"] + slack
    assert (out / "trace.chrome.json").exists()
    assert (out / "meters.json").exists()


def test_serve_metrics_port_serves_the_meters(monkeypatch):
    """``repro_torch.launch.serve --metrics-port`` serves the serve meters
    (prefill and decode-step times, token counters) after the run, until
    interrupted."""
    import socket

    from repro_torch.launch import serve as serve_mod

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = {}

    def sleep(seconds):
        # the wait after the run: read the endpoints, then ctrl-c
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
            got["healthz"] = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/metrics", timeout=5) as r:
            got["metrics"] = json.loads(r.read())
        raise KeyboardInterrupt

    monkeypatch.setattr(serve_mod.time, "sleep", sleep)
    res = serve_mod.main(["--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--gen", "3",
                          "--metrics-port", str(port)])
    assert res.tokens.shape == (2, 3)
    assert got["healthz"]["status"] == "ok"
    snap = got["metrics"]
    assert snap["counters"]["serve.tokens"] >= 6
    assert snap["counters"]["serve.prefills"] >= 1
    assert snap["gauges"]["serve.batch"] == 2
    assert snap["histograms"]["serve.decode_step_s"]["count"] >= 2


def test_trainer_profile_window_writes_a_chrome_trace(tmp_path):
    """``--profile DIR --profile-window 1:3`` captures rounds [1, 3) with
    ``torch.profiler`` and writes them as one Chrome trace."""
    prof = tmp_path / "prof"
    train_mod.main(["--compressor", "threesfc", "--rounds", "4",
                    "--clients", "2", "--local-steps", "1", "--batch", "8",
                    "--train-size", "128", "--eval-every", "1",
                    "--device", "cpu", "--profile", str(prof),
                    "--profile-window", "1:3", "--out", str(tmp_path)])
    assert sorted(os.listdir(prof)) == ["rounds_1_3.json"]
    with open(prof / "rounds_1_3.json") as f:
        doc = json.load(f)
    assert doc["traceEvents"]


def test_lm_trainer_profile_window_carries_the_spans(tmp_path, traced):
    """``train_lm --trace --profile``: the profile window's Chrome trace
    also holds the program's spans of its rounds, on the file's
    ``baseTimeNanoseconds``, so each ``client.train`` span encloses the
    profiler's own records of its work; ``meters.json`` holds the phase
    histograms."""
    traced(Tracer(enabled=False))
    prof, out = tmp_path / "prof", tmp_path / "run"
    train_mod.main(["--arch", "mamba2-370m", "--smoke", "--rounds", "3",
                    "--clients", "2", "--local-steps", "1", "--batch", "2",
                    "--eval-every", "1", "--device", "cpu", "--trace",
                    "--profile", str(prof), "--profile-window", "1:3",
                    "--out", str(out)])
    with open(prof / "rounds_1_3.json") as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    names = {e["args"]["name"]: e["pid"] for e in evs
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    pid = names["server"]
    mine = [e for e in evs if e.get("pid") == pid and e.get("ph") == "X"]
    theirs = [e for e in evs if e.get("pid") != pid and e.get("ph") == "X"
              and e.get("cat") == "cpu_op"]
    trains = [e for e in mine if e["name"] == "client.train"]
    assert len(trains) == 2 * 2                  # rounds 1 and 2, 2 clients
    assert sum(e["name"] == "engine.dispatch" for e in mine) == 2
    for sp in trains:
        inside = [e for e in theirs if sp["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= sp["ts"] + sp["dur"]]
        assert inside, sp
    with open(out / "meters.json") as f:
        hs = json.load(f)["histograms"]
    assert hs["client.train_ms"]["count"] == 3
    assert (out / "trace.jsonl").exists()
