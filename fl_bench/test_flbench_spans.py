"""The phase metrics' readers against the program's own spans: small cells
of both families driven through the harness's ``Program`` with the
program's tracer on, each reader holding the median of its registry
histogram, and None where the program has no such histogram (tracing
off, or a program without the spans). The test marked ``card`` holds the
settled device marks to the device's own records under torch.profiler."""
import statistics

import pytest
import torch

import flb_harness
from flb_testkit import TINY, make_tiny_bench

HOST = ("client.train_ms", "client.encode_ms", "server.aggregate_ms",
        "engine.sync_ms")
DEVICE = ("client.train.device_ms", "client.encode.device_ms",
          "server.aggregate.device_ms")
SEED = 2 ** 31 + 17
SLACK_NS = 50_000                                 # 50 µs
PHASES = ("client.train", "client.encode", "server.aggregate")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return flb_harness.Bench(make_tiny_bench(tmp_path_factory.mktemp("s")))


@pytest.fixture
def registry(monkeypatch):
    """A fresh process registry and a disabled process tracer, restored
    after the test."""
    from repro_torch.obs import Tracer, meters, trace
    reg = meters.MetricsRegistry()
    monkeypatch.setattr(meters, "_GLOBAL", reg)
    monkeypatch.setattr(trace, "_GLOBAL", Tracer(enabled=False))
    return reg


def _traced_rounds(bench, name, device, rounds, registry):
    """One untraced round of the small cell ``name``, then ``rounds``
    traced ones; returns (program, their spans)."""
    from repro_torch.obs import configure_tracer
    torch.set_num_threads(2)
    cell = bench.cell(name)
    prog = flb_harness.Program(cell, SEED, device,
                               flb_harness.cell_tokens(cell, SEED, device))
    prog.round()
    assert registry.snapshot()["histograms"] == {}
    tracer = configure_tracer(True)
    for _ in range(rounds):
        prog.round()
    spans = tracer.drain()
    configure_tracer(False)
    return prog, spans


@pytest.mark.parametrize("real", list(TINY))
def test_readers_read_the_registry_of_traced_rounds(bench, registry, real):
    prog, spans = _traced_rounds(bench, f"tiny.{real}", torch.device("cpu"),
                                 3, registry)
    n = bench.cell(f"tiny.{real}").traffic["clients"]
    before = registry.snapshot()["histograms"]
    for metric in HOST:
        got = bench.reader(metric)({})
        h = before[metric]
        assert h["count"] == 3 and got == h["p50"] and got > 0
    for metric in DEVICE:
        assert bench.reader(metric)({}) is None  # no device on the CPU
    assert registry.snapshot()["histograms"].keys() == before.keys()
    # the fold per round: the spans of that name summed over the round
    for name in ("client.train", "client.encode", "server.aggregate",
                 "engine.sync"):
        mine = [(r["t1"] - r["t0"]) / 1e6 for r in spans
                if r["name"] == name]
        assert len(mine) == 3 * (n if name.startswith("client") else 1)
        assert before[f"{name}_ms"]["sum"] == pytest.approx(sum(mine))
    # the phases' host time fits in each round's dispatch
    for d in (r for r in spans if r["name"] == "engine.dispatch"):
        kids = [r for r in spans if r.get("parent") == d["id"]]
        assert {r["name"] for r in kids} == set(PHASES)
        assert sum(r["t1"] - r["t0"] for r in kids) <= d["t1"] - d["t0"]


def test_readers_read_none_without_the_spans(bench, registry):
    """What a program without the phase spans leaves: no histogram, so
    every new reader reads None, and reading creates none."""
    for metric in HOST + DEVICE:
        assert bench.reader(metric)({}) is None
    assert registry.snapshot()["histograms"] == {}


# --- on the card ----------------------------------------------------------


def _profile_round(prog, cpu: bool):
    """(device records, host launch time by correlation id) of one round
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        prog.round()
        torch.cuda.synchronize()
    dev, launch = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            launch[e.correlation_id()] = e.start_ns()
    return sorted(dev), launch


def _aligned(timed, host) -> bool:
    """Whether the profiler's device timeline holds to its own launches
    near ``host``: of the records launched within 2 ms of it, the first to
    start after its launch does so 0–25 µs after it (the device idles
    between a tiny round's launches). The profiler's device clock strays
    from its host clock in some rounds, its records then starting up to
    1.6 ms before their own launch."""
    lags = [s - t for t, s, e in timed if abs(t - host) < 2_000_000]
    return bool(lags) and 0 <= min(lags) <= 25_000


@pytest.mark.card
@pytest.mark.parametrize("real", list(TINY))
def test_device_marks_lie_between_their_device_records(bench, registry,
                                                       card, real):
    """In a round profiled with device activity (the first of up to eight
    whose device timeline holds to its launches), each settled mark's
    device time lies, within 50 µs, after every device record launched
    before the mark and before every one launched after it; marks never
    go back, d0 ≤ d1 and d0 ≥ t0 − 50 µs; and the marks add no device
    record (rounds in turns with tracing off and on count the same)."""
    from repro_torch.kernels import _build
    from repro_torch.obs import configure_tracer
    _build.build_all(("fused_cosine", "ef_update"))
    prog, _ = _traced_rounds(bench, f"tiny.{real}", card, 1, registry)
    n = bench.cell(f"tiny.{real}").traffic["clients"]
    counts = {False: [], True: []}
    for on in (False, True, True, False, False, True):
        configure_tracer(on)
        counts[on].append(len(_profile_round(prog, cpu=False)[0]))
    # a record a mark would add 2·(2N + 1) + 1 to every traced round; a
    # round's count moves by one now and then on its own, so medians
    assert statistics.median(counts[True]) == statistics.median(
        counts[False]) > 0, counts
    for _ in range(8):
        tracer = configure_tracer(True)
        dev, launch = _profile_round(prog, cpu=True)
        marked = [r for r in tracer.drain() if r["name"] in PHASES]
        configure_tracer(False)
        assert len(marked) == 2 * n + 1 and tracer.unsettled == 0
        marks = [(r[t], r[d]) for r in marked
                 for t, d in (("t0", "d0"), ("t1", "d1"))]
        timed = [(launch[c], s, e) for s, e, c in dev if c in launch]
        if all(_aligned(timed, host) for host, _ in marks):
            break
    else:
        pytest.fail("no profiled round's device timeline held to its "
                    "launches")
    assert len(timed) > len(dev) // 2
    for r in marked:
        assert r["d0"] <= r["d1"] and r["d0"] >= r["t0"] - SLACK_NS
    assert [d for _, d in marks] == sorted(d for _, d in marks)
    for host, d in marks:
        before = [e for t, s, e in timed if t < host]
        after = [s for t, s, e in timed if t > host]
        if before:
            assert d >= max(before) - SLACK_NS, (host, d)
        if after:
            assert d <= min(after) + SLACK_NS, (host, d)
