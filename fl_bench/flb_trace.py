"""The device trace of the traced rounds, reduced to what the per-layer
readers take: the union of the device's activity, its records by name
and the idle gaps between them.

torch.profiler traces the device's activity only (tracing the host's ops
as well costs several times a round of ~10⁵ launches), as
``repro_torch.profiling.round_profile`` does; this is that arithmetic,
copied, over whole rounds.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

NAME_CHARS = 120


def profile_rounds(step: Callable[[], object], rounds: int) -> Dict:
    """Runs ``step`` ``rounds`` times under torch.profiler (device activity
    only) and returns the summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.name()))
    return summarize(spans, wall, rounds)


def summarize(spans: List[Tuple[int, int, str]], wall_s: float,
              rounds: int) -> Dict:
    """``spans``: (start ns, end ns, name) of every device record."""
    spans.sort()
    by_name: Dict[str, List[float]] = {}
    for t0, t1, name in spans:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (t1 - t0) / 1e9
        acc[1] += 1
    busy_ns, gaps = 0, {}
    cur0 = cur1 = None
    for t0, t1, name in spans:
        if cur1 is None:
            cur0, cur1 = t0, t1
        elif t0 > cur1:
            busy_ns += cur1 - cur0
            label = f"before {name[:NAME_CHARS]}"
            gaps[label] = gaps.get(label, 0.0) + (t0 - cur1) / 1e9
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy_ns += cur1 - cur0
    top = sorted(((v[0], k) for k, v in by_name.items()), reverse=True)
    idle = sorted(((v, k) for k, v in gaps.items()), reverse=True)
    return {"rounds": rounds, "window_s": wall_s, "busy_s": busy_ns / 1e9,
            "records": len(spans), "by_name": by_name,
            "device_ops": [[k[:NAME_CHARS], v] for v, k in top[:10]],
            "idle_gaps": [[k, v] for v, k in idle[:10]]}


def kernel_time(summary: Dict, name: str) -> Tuple[float, int]:
    """(seconds, launches) of the records whose name holds ``name``."""
    secs, count = 0.0, 0
    for key, (s, c) in summary["by_name"].items():
        if name in key:
            secs += s
            count += c
    return secs, count
