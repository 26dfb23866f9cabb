"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel of the port from ``src/repro_torch/
             kernels/csrc`` (one nvcc per source, all at once).
3. kernels — each kernel against its plain PyTorch version on the card,
             at lengths 0, 1, 3, 1025, 199,210 (the MLP) and 4 Mi + 5, and
             on the MLP's 6-leaf tree; B1 twice, bitwise.
4. main path — ``repro_torch.launch.train.main`` at the trainer's defaults
             (MLP on MNIST shapes, 3SFC+EF, N=10, K=5, B=32, S=10) for 3
             rounds, with every launch counter set to 0 just before and read
             just after: B1 must launch N·(S+1) and B2 N times per round.
5. fused decode — one round from the trained state with fused decode and
             one without must agree; the same round on the CPU (the plain
             versions) must agree with the card's.
6. times   — each kernel at the main path's shape (CUDA events), its plain
             version, a one-call PyTorch yardstick, its bound, and the wall
             and device time of one main-path round.

The last lines are one JSON object with every kernel's numbers, the list of
kernels, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

from repro_torch.configs.base import CompressorConfig, FLConfig  # noqa: E402
from repro_torch.configs.run import RunConfig  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.core.strategy import make_strategy  # noqa: E402
from repro_torch.core.threesfc import SynData, init_syn  # noqa: E402
from repro_torch.fl.round import FLState, build_fl_round  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ef_update as ef_mod  # noqa: E402
from repro_torch.kernels import fused_cosine as fc_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.build import vision_syn_spec  # noqa: E402
from repro_torch.models.cnn import MNIST_SPEC, make_mlp  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

N, K, B, S = 10, 5, 32, 10
ROUNDS = 3
MLP_D = 199_210
LENGTHS = (0, 1, 3, 1025, MLP_D, (1 << 22) + 5)
B1_RTOL = 1e-5       # of (‖x‖‖y‖, ‖x‖², ‖y‖²): another summation order
B2_ULP = 2.4e-7      # of (|u| + |s·d|): one FMA rounding vs two roundings
# the JAX package's fused-vs-float bounds (tests/test_fused_decode.py)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def reset_counts() -> None:
    fc_mod.LAUNCHES = 0
    ef_mod.LAUNCHES = 0


def counts() -> dict:
    return {"fused_cosine": fc_mod.LAUNCHES, "ef_update": ef_mod.LAUNCHES}


def gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def mlp_tree(g: torch.Generator, scale: float = 1.0) -> dict:
    params = make_mlp(MNIST_SPEC).init(g)
    return flat.tree_map(
        lambda p: scale * torch.randn(p.shape, generator=g, device=p.device),
        params)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_b1(x: torch.Tensor, y: torch.Tensor) -> float:
    got = fc_mod.fused_cosine(x, y)
    again = fc_mod.fused_cosine(x, y)
    want = fc_mod.fused_cosine_plain(x, y)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"B1 not bitwise repeatable at n={x.numel()}: "
                             f"{got.tolist()} vs {again.tolist()}")
    return check_b1_result(got, want, x.numel())


def check_b1_result(got, want, n) -> float:
    scale = torch.stack([torch.sqrt(want[1] * want[2]), want[1], want[2]])
    err = (got - want).abs()
    if not bool((err <= B1_RTOL * scale).all()):
        raise AssertionError(f"B1 disagrees at n={n}: {got.tolist()} vs "
                             f"{want.tolist()}")
    return float(err.max())


def check_b2(u, d, s) -> float:
    got = ef_mod.ef_update(u, d, s)
    want = ef_mod.ef_update_plain(u, d, s)
    torch.cuda.synchronize()
    return check_b2_result(got, want, u, d, s)


def check_b2_result(got, want, u, d, s) -> float:
    if got.numel() == 0:
        return 0.0
    err = (got - want).abs()
    bound = B2_ULP * (u.abs() + (s.reshape(()) * d).abs())
    if not bool((err <= bound).all()):
        i = int(torch.argmax(err - bound))
        raise AssertionError(f"B2 disagrees at n={u.numel()}, element {i}: "
                             f"{float(got[i])} vs {float(want[i])}")
    return float(err.max())


def phase_kernels(dev) -> dict:
    phase("kernels vs plain, on the card")
    g = gen(dev, 11)
    s = torch.tensor([-0.37], device=dev)
    for n in LENGTHS:
        x = torch.randn(n, generator=g, device=dev)
        y = torch.randn(n, generator=g, device=dev)
        e1, e2 = check_b1(x, y), check_b2(x, y, s)
        print(f"  n={n}: B1 max_abs_err={e1:.3e} (bitwise repeatable), "
              f"B2 max_abs_err={e2:.3e}")
    # unaligned views take the scalar path
    x = torch.randn(1027, generator=g, device=dev)
    y = torch.randn(1027, generator=g, device=dev)
    check_b1(x[1:], y[1:])
    check_b2(x[3:1003], y[1:1001], s)
    # the MLP's 6-leaf tree, as the main path hands it over
    a, b = mlp_tree(g, 1e-3), mlp_tree(g, 1e-3)
    leaves_a, leaves_b = flat.tree_leaves(a), flat.tree_leaves(b)
    cat_a = torch.cat([t.reshape(-1) for t in leaves_a])
    cat_b = torch.cat([t.reshape(-1) for t in leaves_b])
    got = ops.tree_fused_stats(a, b)
    torch.cuda.synchronize()
    err_b1 = check_b1_result(got, fc_mod.fused_cosine_plain(cat_a, cat_b),
                             cat_a.numel())
    got_e = torch.cat([t.reshape(-1) for t in flat.tree_leaves(
        ops.tree_ef_update(a, b, s))])
    err_b2 = check_b2_result(got_e, ef_mod.ef_update_plain(cat_a, cat_b, s),
                             cat_a, cat_b, s)
    print(f"  MLP tree (d={cat_a.numel()}): B1 max_abs_err={err_b1:.3e}, "
          f"B2 max_abs_err={err_b2:.3e}")
    return {"fused_cosine": err_b1, "ef_update": err_b2}


# ---------------------------------------------------------------------------
# phase 4: the main path through the entry point
# ---------------------------------------------------------------------------


def phase_main_path(out_dir: str):
    phase("main path: repro_torch.launch.train.main")
    argv = ["--model", "mlp", "--dataset", "mnist", "--compressor", "threesfc",
            "--clients", str(N), "--local-steps", str(K), "--batch", str(B),
            "--rounds", str(ROUNDS), "--eval-every", "1", "--device", "cuda",
            "--out", out_dir]
    reset_counts()
    t0 = time.perf_counter()
    state = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != ROUNDS:
        raise AssertionError(f"expected {ROUNDS} metrics rows, got {rows}")
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["cos"])):
            raise AssertionError(f"non-finite metrics: {r}")
    want = {"fused_cosine": ROUNDS * N * (S + 1), "ef_update": ROUNDS * N}
    if launched != want:
        raise AssertionError(f"launches {launched}, expected {want}")
    print(f"  {ROUNDS} rounds in {wall:.2f} s (first includes warm-up), "
          f"launches {launched}")
    return state, launched


# ---------------------------------------------------------------------------
# phase 5: fused decode vs float decode, and the card vs the CPU
# ---------------------------------------------------------------------------


def make_round(fused: bool):
    model = make_mlp(MNIST_SPEC)
    comp = CompressorConfig(kind="threesfc", syn_steps=S, syn_lr=0.1)
    strategy = make_strategy(comp, loss_fn=model.syn_loss,
                             syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                             local_lr=0.01)
    run = RunConfig(fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.01,
                                local_batch=B, compressor=comp),
                    fused_decode=fused)
    return build_fl_round(model.loss, strategy, run), strategy


def round_inputs(dev, spec):
    g = gen(dev, 5)
    batches = {"x": torch.rand((N, K, B, 28, 28, 1), generator=g, device=dev),
               "y": torch.randint(0, 10, (N, K, B), generator=g, device=dev)}
    syns = [init_syn(g, spec) for _ in range(N)]
    syn0 = SynData(*[torch.stack(ts) for ts in zip(*syns)])
    return batches, syn0


def assert_close(name, got, want, tol) -> None:
    """Elementwise |got − want| ≤ atol + rtol·|want| over every leaf."""
    worst, max_abs = -math.inf, 0.0
    for a, b in zip(flat.tree_leaves(got), flat.tree_leaves(want)):
        a, b = a.double().cpu(), b.double().cpu()
        d = (a - b).abs()
        max_abs = max(max_abs, float(d.max()))
        worst = max(worst, float((d / (tol["atol"]
                                       + tol["rtol"] * b.abs())).max()))
    if worst > 1.0:
        raise AssertionError(f"{name}: exceeds rtol={tol['rtol']} "
                             f"atol={tol['atol']} ({worst:.3f}x the bound)")
    print(f"  {name}: max |diff| {max_abs:.3e}, at most {worst:.3f}x the "
          f"bound rtol={tol['rtol']} atol={tol['atol']}")


def phase_fused(state: FLState, dev):
    phase("fused decode vs float decode; card vs CPU")
    float_round, strategy = make_round(False)
    fused_round, _ = make_round(True)
    batches, syn0 = round_inputs(dev, strategy.syn_spec)
    reset_counts()
    s_float, m_float = float_round(state, batches, 0, syn0=syn0)
    s_fused, m_fused = fused_round(state, batches, 0, syn0=syn0)
    torch.cuda.synchronize()
    print(f"  launches over the two rounds: {counts()}")
    assert_close("fused params", s_fused.params, s_float.params, PARAM_TOL)
    assert_close("fused EF", s_fused.ef, s_float.ef, EF_TOL)
    # the same float round on the CPU runs the kernels' plain versions
    to_cpu = lambda t: flat.tree_map(lambda x: x.cpu(), t)  # noqa: E731
    s_cpu, m_cpu = float_round(
        FLState(to_cpu(state.params), to_cpu(state.ef), state.round),
        to_cpu(batches), 0, syn0=SynData(*to_cpu(list(syn0))))
    assert_close("card vs CPU params", s_float.params, s_cpu.params,
                 PARAM_TOL)
    assert_close("card vs CPU EF", s_float.ef, s_cpu.ef, EF_TOL)
    for m in (m_float, m_fused, m_cpu):
        if not bool(torch.isfinite(m.cosine).all()):
            raise AssertionError(f"non-finite cosine: {m.cosine}")
    return float_round, batches, syn0


# ---------------------------------------------------------------------------
# phase 6: times
# ---------------------------------------------------------------------------


def graph_ms(fn, reps: int = 200, replays: int = 21) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    each replay timed with CUDA events; the median over replays, divided by
    ``reps``. The graph strips the host's launch overhead, so this is the
    kernels' time plus the gaps between them on the device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def call_ms(fn, reps: int = 200) -> float:
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


def bound_ms(nbytes: int, flops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def round_profile(float_round, state, batches, syn0) -> dict:
    """Wall time of main-path rounds, and the device's kernel time in one
    of them from torch.profiler."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float_round(state, batches, 0, syn0=syn0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float_round(state, batches, 0, syn0=syn0)
        torch.cuda.synchronize()
    # kernel rows only (device_type CUDA): the aten:: rows repeat the time
    # of the kernels they launch
    dev_us, per_kernel, top = 0.0, {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
            continue
        t = e.device_time_total
        dev_us += t
        top.append((t, e.key, e.count))
        for name in ("fused_cosine_partials", "fused_cosine_finish",
                     "ef_update_kernel"):
            if name in e.key:
                per_kernel[name] = (t, e.count)
    top.sort(reverse=True)
    return {"round_wall_ms": statistics.median(walls),
            "round_device_ms": dev_us / 1e3 if dev_us else None,
            "per_kernel_us": per_kernel, "top": top[:8]}


def phase_times(dev, launched, errs, float_round, state, batches, syn0):
    phase("times at the main path's shape")
    g = gen(dev, 13)
    x = torch.randn(MLP_D, generator=g, device=dev)
    y = torch.randn(MLP_D, generator=g, device=dev)
    s = torch.tensor([0.37], device=dev)
    X = torch.stack([x, y])
    n = x.numel()
    rows = []
    specs = [
        ("fused_cosine", "src/repro_torch/kernels/csrc/fused_cosine.cu",
         "src/repro/kernels/fused_cosine.py:60",
         lambda: fc_mod.fused_cosine(x, y),
         lambda: fc_mod.fused_cosine_plain(x, y),
         lambda: torch.mm(X, X.T),
         2 * n * 4 + 3 * 4, 6 * n, N * (S + 1)),
        ("ef_update", "src/repro_torch/kernels/csrc/ef_update.cu",
         "src/repro/kernels/ef_update.py:31",
         lambda: ef_mod.ef_update(x, y, s),
         lambda: ef_mod.ef_update_plain(x, y, s),
         lambda: torch.addcmul(x, y, s, value=-1),
         3 * n * 4 + 4, 2 * n, N),
    ]
    for (name, source, replaces, kern, plain, lib, nbytes, flops,
         per_round) in specs:
        kern_ms = graph_ms(kern)
        eager_ms = call_ms(kern)
        plain_ms = graph_ms(plain)
        library_ms = graph_ms(lib)
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"  {name}: kernel_ms={kern_ms:.6f} (eager call "
              f"{eager_ms:.6f}) bound_ms={b_ms:.6f} ({b_by}) "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"launches_per_round={per_round}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched[name],
                     "max_abs_err": errs[name], "ms": kern_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "call_ms": eager_ms,
                     "launches_per_round": per_round})
    prof = round_profile(float_round, state, batches, syn0)
    busy = (f"{prof['round_device_ms']:.3f} ms, busy share "
            f"{prof['round_device_ms'] / prof['round_wall_ms']:.4f}"
            if prof["round_device_ms"] else "not measured")
    print(f"  main-path round (N={N}, K={K}, B={B}, S={S}): wall "
          f"{prof['round_wall_ms']:.3f} ms (median of 3), device kernel "
          f"time {busy}")
    for name, (t, cnt) in sorted(prof["per_kernel_us"].items()):
        print(f"    {name}: {cnt} launches, {t / cnt:.3f} us each")
    for t, key, cnt in prof["top"]:
        print(f"    top: {t / 1e3:.3f} ms  {cnt:5d}x  {key[:90]}")
    return rows


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    # the reference computes in full f32: TF32 stays off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase("build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"  built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s")

    errs = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        state, launched = phase_main_path(out_dir)
    float_round, batches, syn0 = phase_fused(state, dev)
    rows = phase_times(dev, launched, errs, float_round, state, batches,
                       syn0)

    print(card)
    print(json.dumps({"kernels": rows}))
    print('kernels: ["fused_cosine", "ef_update"]')
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
