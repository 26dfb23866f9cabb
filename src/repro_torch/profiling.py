"""Device timing on one CUDA card: a call's time in a CUDA graph and
eagerly, and a round's wall time beside its device kernel time.

``chip_smoke.py`` and ``scripts/torch_round_profile.py`` both time with
these. The module imports only ``torch`` and the standard library, so the
profile script can load it by path next to another checkout's
``repro_torch``.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Sequence

import torch


def graph_ms(fn: Callable[[], object], reps: int = 200,
             replays: int = 21) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    each replay timed with CUDA events; the median over replays, divided by
    ``reps``. The graph strips the host's launch overhead, so this is the
    kernels' time plus the gaps between them on the device. Three warm-up
    calls run on the stream the graph is captured on (B1 makes a stream's
    scratch at its first call there, outside any capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def call_ms(fn: Callable[[], object], reps: int = 200) -> float:
    """Median over ``reps`` eager calls, each between two CUDA events: the
    time one call occupies the stream, the host's launch overhead
    included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def round_profile(one_round: Callable[[], object],
                  kernel_names: Sequence[str] = (),
                  walls: int = 3) -> Dict[str, object]:
    """Wall time of ``one_round()`` (median of ``walls``, host clock around
    ``torch.cuda.synchronize()``), and from torch.profiler over one more,
    tracing the device's activity only (tracing the host's ops as well
    costs several times the wall time of a round that launches half a
    million kernels): the device
    kernel time, the number of device kernels and copies, the (time in us,
    count) of each kernel whose name contains one of ``kernel_names``, and
    the eight costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls_ms = []
    for _ in range(walls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        walls_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_round()
        torch.cuda.synchronize()
    # the device's records only (kernels, copies, fills), summed by name
    # straight from the trace's events
    by_name: Dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        tc = by_name.setdefault(e.name(), [0.0, 0])
        tc[0] += e.duration_ns() / 1e3
        tc[1] += 1
    dev_us = sum(t for t, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    top = sorted(((t, key, c) for key, (t, c) in by_name.items()),
                 reverse=True)
    per_kernel = {}
    for name in kernel_names:
        for key, (t, c) in by_name.items():
            if name in key:
                per_kernel[name] = (t, c)
    return {"round_wall_ms": statistics.median(walls_ms),
            "walls_ms": walls_ms,
            "round_device_ms": dev_us / 1e3 if dev_us else None,
            "device_launches": launches, "per_kernel_us": per_kernel,
            "top": top[:8]}
