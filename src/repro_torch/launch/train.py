"""Federated training driver — the port's end-to-end entry point.

Runs an in-process FL training job on the paper's vision setting through
``repro_torch.fl.engine.RoundEngine``: data and Dirichlet pools live on the
device, the round is built by ``repro_torch.fl.round.build_fl_round`` over
the compressor's registered strategy, and the flags fold into one
validated ``RunConfig`` (logged as ``run_config.json`` next to
``metrics.jsonl``). ``--wire codec`` runs the round on serialized uint8
frames (``repro_torch.comm``), one per client per round. The fault flags
(``--participation-rate``, ``--drop-rate``, ``--straggler-rate``,
``--staleness-max``, ``--fault-seed``) run the in-round fault model of
``repro_torch.fl.faults``; ``--model`` takes each of the paper's five
vision models. ``--arch ID --smoke`` runs the reference's reduced
LM-family FL run instead (``train_lm_smoke``: the arch's smoke config, 64
tokens a sequence, 3SFC with 10 steps over 8 synthetic positions);
``train_lm`` is that run's body for any config, sequence length and
compressor, and takes the reference's microbatch rule (from 4,096 tokens
a sequence, up to 8 slices of each local batch).

    PYTHONPATH=src python -m repro_torch.launch.train --model mlp \
        --dataset mnist --compressor threesfc --rounds 200 --clients 10
    PYTHONPATH=src python -m repro_torch.launch.train --compressor signsgd \
        --wire codec
    PYTHONPATH=src python -m repro_torch.launch.train --model convnet \
        --dataset cifar10 --drop-rate 0.3 --participation-rate 0.8
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --rounds 3 --clients 2 --eval-every 1

It runs on the CUDA device unless ``--device cpu`` is given, and raises
when no CUDA device is available and the CPU was not asked for.

Host layers, as in the reference: ``--transport socket`` (with ``--wire
codec``) runs the rounds over a ``SocketServer`` and N worker processes
on the run's device (``train_vision_socket``; the deadline, backoff and
liveness knobs are ``RunConfig``'s); ``--ckpt-every`` writes full-state
recovery points under ``<out>/ckpt`` and ``--resume`` continues one
bitwise, on either transport; ``--trace`` writes the merged span trace
(``trace.jsonl``, ``trace.chrome.json``), ``--profile`` a
``torch.profiler`` trace of a round window (with ``--trace``, the
window's spans and their device rows in the same file, on its clock), and
``--metrics-port`` serves ``/healthz`` and ``/metrics`` (with
``--trace``, each phase span's host and device ms a round as
histograms):

    PYTHONPATH=src python -m repro_torch.launch.train --wire codec \
        --transport socket --rounds 20 --ckpt-every 5 --trace

Client fan-out (``--client-parallel``, ``make_fanout``): ``shard_map``
shares each round among the ranks of a job, one rank per device, each
running its own block of clients (``repro_torch.fl.sharding``); ``auto``
(the default) picks it when the job has more than one rank and the client
count divides over them, else ``vmap``, the single-process loop. Launch a
job with ``torchrun``; each rank uses ``cuda:LOCAL_RANK`` (NCCL), or the
CPU with ``--device cpu`` (gloo), and only rank 0 writes the logs:

    torchrun --nproc-per-node P -m repro_torch.launch.train \
        --client-parallel shard_map --clients 8 --rounds 20

Seeds: the training set (images or token sequences) is drawn from
``fold_in(seed, 0)``, the test set from ``fold_in(seed, 1)`` and the
initial params from ``fold_in(seed, 2)``
(``repro_torch.fl.round.fold_in``); the engine derives batches and encoder
draws from ``seed`` as ``repro_torch.fl.engine`` documents.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (CheckpointManager, load_fl_checkpoint,
                                    save_checkpoint, save_fl_checkpoint)
from repro_torch.configs.base import (ARCH_IDS, CompressorConfig, FLConfig,
                                     ModelConfig, get_smoke_config)
from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.strategy import CompressionStrategy, make_strategy
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (make_class_image_dataset,
                                        make_token_dataset)
from repro_torch.fl.budget import matched_compressors
from repro_torch.fl.engine import (RoundEngine, RunHistory, device_pools,
                                   token_batcher, vision_batcher)
from repro_torch.fl.round import FLState, build_fl_round, fl_init, fold_in
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_host_mesh, process_rank, world_size
from repro_torch.models.build import (build_model, syn_loss_fn, syn_spec_for,
                                      vision_syn_spec)
from repro_torch.models.cnn import (DATASETS, VisionSpec, accuracy,
                                    make_paper_model)
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.obs import (add_to_chrome_trace, configure_tracer,
                             get_registry, get_tracer, merge_traces, now_ns,
                             set_tracer, write_chrome_trace)
from repro_torch.obs.http import ObsHTTPServer

# the reference's reduced LM run (launch/train.py train_lm_smoke)
SMOKE_SEQ_LEN, SMOKE_NUM_SEQS = 64, 2048


def resolve_device(name: str) -> torch.device:
    """The run's device. CUDA unless the caller asked for the CPU; raises
    when CUDA was asked for (the default) and none is available. Under a
    launcher that exports ``LOCAL_RANK``, ``cuda`` means that rank's
    device, made current."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is false; pass "
            "--device cpu to run on the CPU")
    if device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if device.index is not None:
        torch.cuda.set_device(device)
    # the reference computes in full f32: keep TF32 off for matrix products
    # and for cuDNN, whatever the process defaults are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def make_fanout(args, device: torch.device):
    """(client_parallel, mesh, shardings) from ``--client-parallel``.

    'auto' picks the sharded fan-out when the job has more than one rank
    and the client count divides evenly over them, else the single-process
    loop. An explicit 'shard_map' fails loudly (one rank, or a client count
    that does not divide) rather than silently degrading.
    """
    mode = args.client_parallel
    n = world_size()
    if mode == "auto":
        mode = "shard_map" if n > 1 and args.clients % n == 0 else "vmap"
    if mode == "vmap":
        return "vmap", None, None
    if n < 2:
        raise ValueError(
            "--client-parallel shard_map needs >1 device (a 1-shard "
            "shard_map would be vmap with extra steps); this job has "
            f"{n} rank — use 'vmap'/'auto' or launch ranks with "
            "torchrun --nproc-per-node P")
    # imported here: DTensor's import (sympy, fx) takes seconds, and a
    # socket worker, which imports this module, never shards
    from repro_torch.fl.sharding import make_fl_shardings
    mesh = make_host_mesh(device=device)
    shardings = make_fl_shardings(mesh)
    shardings.check_divisible(args.clients)
    return "shard_map", mesh, shardings


def _write_run_config(out_dir: str, record: dict) -> None:
    """Log the run's configuration next to its metrics (rank 0 only)."""
    if process_rank() != 0:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "run_config.json"), "w") as f:
        json.dump(record, f, indent=1)


class _MetricsLog:
    """``<out>/metrics.jsonl``, written and printed by rank 0 only."""

    def __init__(self, out_dir: str, append: bool = False):
        self._f = None
        if process_rank() == 0:
            os.makedirs(out_dir, exist_ok=True)
            self._f = open(os.path.join(out_dir, "metrics.jsonl"),
                           "a" if append else "w")

    @property
    def writer(self) -> bool:
        return self._f is not None

    def write(self, rec: dict) -> None:
        print(json.dumps(rec))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._f is not None:
            self._f.close()


class _ProfileWindow:
    """``torch.profiler`` capture over a round window ``[start, stop)``,
    written as a Chrome trace ``<dir>/rounds_<start>_<stop>.json``. With
    the process tracer on (``--trace``) the file also carries the spans
    that closed in the window, with their device rows, on the profile's
    own ``baseTimeNanoseconds`` (one clock: ``obs.now_ns``).

    Drive it with ``maybe_start(next_round)`` before rounds begin and
    ``after_round(completed_round)`` at round boundaries; ``close()``
    stops a started capture. On the socket transport the window is exact
    (the loop reports every round); in-process it snaps to eval-block
    boundaries."""

    def __init__(self, out_dir: str, start: int, stop: int):
        self.dir, self.a, self.b = out_dir, start, stop
        self._prof = None
        self.done = False

    def maybe_start(self, next_round: int) -> None:
        if self.done or self._prof is not None \
                or not (self.a <= next_round < self.b):
            return
        os.makedirs(self.dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._first = next_round
        self._t0 = now_ns()

    def after_round(self, completed_round: int) -> None:
        nxt = completed_round + 1
        if self._prof is not None and nxt >= self.b:
            self._stop(nxt)
        self.maybe_start(nxt)

    def _stop(self, end: int) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.dir, f"rounds_{self._first}_{end}.json")
        prof.export_chrome_trace(path)
        tracer = get_tracer()
        if tracer.enabled:
            add_to_chrome_trace(path, [
                r for r in tracer.to_dicts()
                if r.get("t0", r.get("t", 0)) >= self._t0])
        self.done = True

    def close(self) -> None:
        if self._prof is not None:
            self._stop(self.b)


def _make_profiler(args, r0: int) -> Optional[_ProfileWindow]:
    if not args.profile:
        return None
    if args.profile_window:
        a, b = (int(x) for x in args.profile_window.split(":", 1))
    else:
        a, b = r0, args.rounds
    return _ProfileWindow(args.profile, a, b)


def _dump_obs(out_dir: str, server=None) -> None:
    """End-of-run observability files: ``meters.json`` always; when
    tracing is on, the merged span trace as ``trace.jsonl`` and a
    Chrome/Perfetto ``trace.chrome.json`` (the workers' piggybacked spans
    shifted onto the server's clock by the heartbeat offset estimates);
    on the socket transport, the byte ledger as ``ledger.json``."""
    os.makedirs(out_dir, exist_ok=True)
    tracer = get_tracer()
    if tracer.enabled:
        records = tracer.drain()
        if server is not None:
            records = merge_traces(records, server.pop_worker_spans(),
                                   server.clock_offsets())
        with open(os.path.join(out_dir, "trace.jsonl"), "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        write_chrome_trace(records,
                           os.path.join(out_dir, "trace.chrome.json"))
        print(f"trace -> {out_dir}/trace.jsonl ({len(records)} records, "
              f"{tracer.dropped} dropped)")
    with open(os.path.join(out_dir, "meters.json"), "w") as f:
        json.dump(get_registry().snapshot(), f, indent=1)
    if server is not None:
        # what scripts/trace_report.py --ledger reconciles the trace with
        with open(os.path.join(out_dir, "ledger.json"), "w") as f:
            json.dump(server.ledger(), f, indent=1)


def _ckpt_manager(args) -> CheckpointManager:
    """The run's checkpoint root: ``--resume PATH`` names an existing root
    to continue (new recovery points land in the same index); otherwise
    ``<out>/ckpt``."""
    return CheckpointManager(args.resume or os.path.join(args.out, "ckpt"))


def _check_resume_config(meta, run: RunConfig) -> None:
    """A resumed run must replay the checkpointed configuration: bitwise
    resume is only defined for the same seeds and knobs. The run's length
    (``fl.rounds``) may differ — every round is a function of the seeds
    and the absolute round counter, not of the horizon — so a run cut
    short can be extended."""
    def knobs(d):
        d = json.loads(json.dumps(d))
        d.get("fl", {}).pop("rounds", None)
        return d

    want, got = run.to_json(), meta.get("run")
    if got is not None and knobs(got) != knobs(want):
        want, got = knobs(want), knobs(got)
        diff = sorted(k for k in set(want) | set(got)
                      if want.get(k) != got.get(k))
        raise ValueError(
            f"--resume configuration mismatch on {diff}: the checkpoint was "
            f"written under a different RunConfig; rounds replayed from it "
            f"would not be the same run")


def _finish(state: FLState, shardings) -> FLState:
    """The run's final state, with every client's EF row on every rank."""
    return state if shardings is None else shardings.gather_state(state)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def vision_model(name: str, spec: VisionSpec, seed: int,
                 device: torch.device):
    """(model, initial params) of a vision run: the paper model ``name``
    at ``spec``'s shapes, its params drawn from ``fold_in(seed, 2)``."""
    model = make_paper_model(name, spec)
    return model, model.init(_generator(device, fold_in(seed, 2)))


def vision_strategy(model, spec: VisionSpec,
                    fl: FLConfig) -> CompressionStrategy:
    """The strategy of ``fl``'s compressor over the model's synthetic-data
    loss."""
    return make_strategy(fl.compressor, loss_fn=model.syn_loss,
                         syn_spec=vision_syn_spec(spec, fl.compressor),
                         local_lr=fl.local_lr)


def vision_data(spec: VisionSpec, fl: FLConfig, train_size: int,
                device: torch.device):
    """(training set on the host, device pools of its Dirichlet partition)
    of a vision run: ``train_size`` images drawn from ``fold_in(fl.seed,
    0)``, split over ``fl.num_clients`` clients. The in-process trainer
    and every socket worker (``repro_torch.launch.worker``) build their
    data here, so a worker's client holds the trainer's rows."""
    train = make_class_image_dataset(
        _generator(torch.device("cpu"), fold_in(fl.seed, 0)), train_size,
        spec.input_shape, spec.num_classes)
    parts = dirichlet_partition(train.y, fl.num_clients,
                                alpha=fl.dirichlet_alpha, seed=fl.seed,
                                min_per_client=fl.local_batch)
    return train, device_pools(parts, device)


def train_vision(args) -> FLState:
    device = resolve_device(args.device)
    spec = DATASETS[args.dataset]
    model, params = vision_model(args.model, spec, args.seed, device)
    d = flat.tree_size(params)
    comp = matched_compressors(args.model, spec, d)[args.compressor]
    if args.transport == "socket":
        # worker processes ARE the fan-out; the mesh paths stay in-process
        mode, mesh, shardings = "vmap", None, None
    else:
        mode, mesh, shardings = make_fanout(args, device)
    run = RunConfig.from_flags(args, compressor=comp, client_parallel=mode,
                               mesh=mesh)
    strategy = vision_strategy(model, spec, run.fl)
    codec = strategy.wire_codec(params, policy=run.wire_policy) \
        if run.wire == "codec" else None
    test = make_class_image_dataset(
        _generator(torch.device("cpu"), fold_in(args.seed, 1)), 1000,
        spec.input_shape, spec.num_classes)
    if run.transport == "socket":
        return train_vision_socket(args, spec=spec, model=model,
                                   params=params, strategy=strategy, run=run,
                                   codec=codec, test=test, device=device)
    train, pools = vision_data(spec, run.fl, args.train_size, device)
    clients = None
    if shardings is not None:
        pools = shardings.place_pools(pools)
        clients = shardings.local_clients(args.clients)
    engine = RoundEngine(
        build_fl_round(model.loss, strategy, run, codec=codec),
        vision_batcher(train.x, train.y, pools, args.local_steps, args.batch,
                       clients=clients),
        seed=args.seed, shardings=shardings)
    state = engine.init_state(params, args.clients, strategy,
                              staleness_max=run.staleness_max)
    eval_acc = _evaluator(model, test, device)
    mgr = _ckpt_manager(args)
    meta_extra = {"model": args.model, "dataset": args.dataset,
                  "compressor": args.compressor, "transport": "inproc"}
    r0 = 0
    if args.resume:
        # a whole-N template: a checkpoint of another model, fault or
        # staleness configuration fails typed here
        template = fl_init(params, args.clients, strategy,
                           staleness_max=run.staleness_max)
        state, _, meta = load_fl_checkpoint(mgr, template)
        _check_resume_config(meta, run)
        if shardings is not None:
            state = shardings.place_state(state)
        r0 = int(meta["round"])
        print(f"resuming from {mgr.path(r0)} at round {r0}")

    def ckpt_fn(st, rnd):
        # the whole-N state (a collective under shard_map), saved by rank 0
        full = _finish(st, shardings)
        if process_rank() == 0:
            save_fl_checkpoint(mgr, rnd, full, run=run, extra=meta_extra)

    _write_run_config(args.out, {**run.to_json(), "device": str(device),
                                 "world_size": world_size()})
    t0 = time.time()
    profiler = _make_profiler(args, r0)
    if profiler is not None:
        profiler.maybe_start(r0)
    with _MetricsLog(args.out, append=bool(args.resume)) as log:
        def on_eval(st, m, r):
            if profiler is not None:
                profiler.after_round(r0 + r - 1)
            if not log.writer:
                return
            log.write({"round": r0 + r, "loss": float(m.loss[-1]),
                       "acc": eval_acc(st.params),
                       "cos": float(m.cosine[-1].mean()),
                       "payload_floats": float(m.payload_floats[-1]),
                       "elapsed_s": round(time.time() - t0, 1)})

        try:
            state, _ = engine.run(
                state, args.rounds - r0, eval_every=args.eval_every,
                eval_fn=on_eval, ckpt_every=args.ckpt_every,
                ckpt_fn=ckpt_fn if args.ckpt_every else None)
        finally:
            if profiler is not None:
                profiler.close()
    if args.ckpt_every and mgr.latest() != args.rounds:
        ckpt_fn(state, args.rounds)
    state = _finish(state, shardings)
    if process_rank() == 0:
        _dump_obs(args.out)
        _save_final(args, state.params)
    return state


def _evaluator(model, test, device: torch.device):
    """Test accuracy of a params tree on the run's test set."""
    test_x = torch.as_tensor(test.x, device=device)
    test_y = torch.as_tensor(test.y, device=device)

    def eval_acc(p) -> float:
        with torch.no_grad():
            return float(accuracy(model.apply(p, test_x), test_y))

    return eval_acc


def _save_final(args, params, **meta) -> None:
    save_checkpoint(os.path.join(args.out, "final"), params,
                    meta={"model": args.model, "dataset": args.dataset,
                          "compressor": args.compressor,
                          "rounds": args.rounds, **meta})
    print(f"checkpoint -> {args.out}/final")


def _history_to_json(history):
    """Live-loop round records -> the JSON form a checkpoint carries."""
    return [{"round": int(rec["round"]),
             "wall_s": float(rec["wall_s"]),
             "participate": [bool(b) for b in rec["participate"]],
             "delivered": [bool(b) for b in rec["delivered"]],
             "retries": int(rec["retries"]),
             "bytes_up": int(rec["bytes_up"]),
             "bytes_down": int(rec["bytes_down"]),
             "overhead_up": int(rec.get("overhead_up", 0)),
             "overhead_down": int(rec.get("overhead_down", 0)),
             "dead": [int(c) for c in rec["dead"]],
             "losses": {str(k): float(v) for k, v in rec["losses"].items()}}
            for rec in history]


def _history_from_json(recs):
    return [{**rec,
             "participate": np.asarray(rec["participate"], bool),
             "delivered": np.asarray(rec["delivered"], bool),
             "losses": {int(k): float(v) for k, v in rec["losses"].items()}}
            for rec in recs]


def ef_from_bank(bank, template, num_clients: int):
    """The (N, ...) EF tree of a socket run from the server's EF bank (each
    client's flat f32 stream in tree-leaf order), shaped like
    ``template`` (one client's residual) on its device; None when a
    client has no banked residual."""
    if any(c not in bank for c in range(num_clients)):
        return None
    leaves, treedef = tree_flatten(template)
    rows = []
    for c in range(num_clients):
        vec, off, out = bank[c][1], 0, []
        for leaf in leaves:
            n = leaf.numel()
            out.append(torch.as_tensor(vec[off:off + n].reshape(
                tuple(leaf.shape))).to(leaf.device))
            off += n
        rows.append(tree_unflatten(treedef, out))
    return flat.tree_stack(rows)


WORKER_KERNELS = ("fused_cosine", "ef_update", "bitpack")


def train_vision_socket(args, *, spec, model, params, strategy, run, codec,
                        test, device: torch.device) -> FLState:
    """The live multi-process path: a ``SocketServer`` and N worker
    processes (``repro_torch.launch.worker``, on this run's device) driven
    by ``repro_torch.fl.engine.LiveRoundLoop`` — framed rounds over real
    sockets under the run's deadline, backoff and liveness knobs. The same
    metrics JSONL and checkpoint contract as the in-process path; the
    workers' logs go to ``<out>/workers/``. Returns the final params, the
    EF of every client from the server's bank, and the round counter."""
    # the worker's module imports this one: imported here
    from repro_torch.comm.transport import SocketServer, spawn_local_workers
    from repro_torch.fl.engine import LiveRoundLoop, RetryPolicy
    from repro_torch.launch.worker import vision_setup

    eval_acc = _evaluator(model, test, device)
    mgr = _ckpt_manager(args)
    r0, bank, history, meta = 0, {}, [], None
    if args.resume:
        # params, the per-client EF bank, the ledger and the history;
        # every worker is a joiner the server re-syncs from the bank
        params, bank, meta = load_fl_checkpoint(mgr, params)
        _check_resume_config(meta, run)
        r0 = int(meta["round"])
        history = _history_from_json(meta.get("history", []))
        print(f"resuming from {mgr.path(r0)} at round {r0}")
    _write_run_config(args.out, {**run.to_json(), "device": str(device),
                                 "world_size": 1})
    if device.type == "cuda":
        # build once here rather than in N workers at once
        _build.build_all(WORKER_KERNELS)
    t0 = time.time()
    server = SocketServer(args.clients, heartbeat_s=run.heartbeat_s,
                          liveness_timeout_s=run.liveness_timeout_s)
    if meta is not None:
        server.restore_ledger(meta["ledger"])   # round numbering continues
        server.seed_ef_bank(bank)
    procs = spawn_local_workers(server.address, range(args.clients),
                                device=str(device),
                                log_dir=os.path.join(args.out, "workers"))
    profiler = _make_profiler(args, r0)
    extra = {"model": args.model, "dataset": args.dataset,
             "compressor": args.compressor, "transport": "socket"}
    try:
        server.wait_ready()
        server.send_setup(vision_setup(run, model=args.model, spec=spec,
                                       train_size=args.train_size,
                                       trace=args.trace, device=str(device)))
        with _MetricsLog(args.out, append=bool(args.resume)) as log:
            def on_round(rec, rep):
                if profiler is not None:
                    profiler.after_round(rec["round"])
                r = rec["round"] + 1
                if r % args.eval_every and r != args.rounds:
                    return
                log.write({
                    "round": r,
                    "loss": float(np.mean(list(rec["losses"].values())))
                    if rec["losses"] else None,
                    "acc": eval_acc(loop.params),
                    "delivered": int(rec["delivered"].sum()),
                    "retries": rec["retries"],
                    "bytes_up": rec["bytes_up"],
                    "bytes_down": rec["bytes_down"],
                    "overhead_up": rec["overhead_up"],
                    "overhead_down": rec["overhead_down"],
                    "wall_s": round(rec["wall_s"], 4),
                    "elapsed_s": round(time.time() - t0, 1)})

            def settle(rnd: int, rec) -> None:
                # every participating live worker must have pushed its
                # round-``rnd`` commit before the bank is read: an
                # unsettled recovery point would not resume bitwise
                cids = [c for c in range(args.clients)
                        if rec["participate"][c] and c not in rec["dead"]]
                if not server.wait_ef_bank(rnd, cids, timeout=30.0):
                    live = set(server.live_workers())
                    cids = [c for c in cids if c in live]
                    if not server.wait_ef_bank(rnd, cids, timeout=30.0):
                        raise RuntimeError(
                            f"EF bank did not settle for round {rnd}; "
                            f"refusing to write an unsettled recovery point")

            def ckpt_fn(lp, rnd):
                settle(rnd, lp.history[-1])
                save_fl_checkpoint(
                    mgr, rnd + 1, lp.params, run=run,
                    ledger=server.ledger(),
                    history=_history_to_json(lp.history),
                    ef_bank=server.ef_bank(), extra=extra)

            loop = LiveRoundLoop(server, strategy, codec, run, params,
                                 on_round=on_round)
            loop.history.extend(history)
            ck = dict(ckpt_every=args.ckpt_every,
                      ckpt_fn=ckpt_fn if args.ckpt_every else None)
            # every worker warms up inside its first round (round 0, or
            # the first resumed round): a generous window for that one,
            # then the configured deadline and backoff
            remaining = args.rounds - r0
            boot = max(run.round_deadline_s, 300.0)
            if profiler is not None:
                profiler.maybe_start(r0)
            if remaining > 0:
                loop.run(1, deadline_s=boot,
                         policy=RetryPolicy(max_retries=0,
                                            recv_timeout_s=boot,
                                            max_timeout_s=boot), **ck)
                loop.run(remaining - 1, **ck)
            final = loop.params
            if args.ckpt_every and mgr.latest() != args.rounds:
                # final recovery point (the cadence may not divide rounds)
                ckpt_fn(loop, args.rounds - 1)
            elif loop.history:
                settle(args.rounds - 1, loop.history[-1])
            ef = ef_from_bank(server.ef_bank(),
                              strategy.init_ef_state(params), args.clients)
        _dump_obs(args.out, server=server)
    finally:
        if profiler is not None:
            profiler.close()
        server.stop()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    _save_final(args, final, transport="socket")
    return FLState(final, ef, args.rounds)


def num_micro_for(per_client: int, seq_len: int) -> int:
    """The reference's microbatch rule (``launch/specs.py``
    ``make_train_entry``): from 4,096 tokens a sequence, ``min(per_client,
    8)`` slices of each local batch, lowered to a divisor of it; else 1."""
    num_micro = min(per_client, 8) if seq_len >= 4096 else 1
    while per_client % num_micro:
        num_micro -= 1
    return num_micro


def lm_setup(args, cfg: ModelConfig, comp: CompressorConfig,
             seq_len: int, *, client_parallel: str = "vmap", mesh=None
             ) -> Tuple[Union[LM, EncDec], CompressionStrategy, RunConfig]:
    """(model, strategy, run config) of an LM-family FL round: ``cfg``'s
    model, ``comp`` with the model's synthetic-data loss, the flags' FL
    settings, the fan-out and the microbatch rule for ``args.batch``
    sequences of ``seq_len`` tokens."""
    model = build_model(cfg)
    strategy = make_strategy(comp, loss_fn=syn_loss_fn(model),
                             syn_spec=syn_spec_for(cfg, comp),
                             local_lr=args.lr)
    run = RunConfig.from_flags(args, compressor=comp,
                               client_parallel=client_parallel,
                               mesh=mesh).replace(
        num_micro=num_micro_for(args.batch, seq_len))
    return model, strategy, run


def train_lm(args, cfg: ModelConfig, comp: CompressorConfig, seq_len: int,
             num_seqs: int) -> Tuple[FLState, RunHistory]:
    """An LM-family FL run: ``cfg``'s model trained by ``args.clients``
    clients on ``num_seqs`` planted-bigram sequences of ``seq_len`` tokens
    (IID batches of ``args.batch`` sequences, ``args.local_steps`` local
    steps), the update compressed by ``comp``; one row per eval with the
    reference's keys ``round``, ``loss``, ``cos``, ``params``, printed and
    written to ``<out>/metrics.jsonl``; ``--profile`` and ``--trace`` as
    the vision run's (``meters.json``, the traces)."""
    device = resolve_device(args.device)
    mode, mesh, shardings = make_fanout(args, device)
    model, strategy, run = lm_setup(args, cfg, comp, seq_len,
                                    client_parallel=mode, mesh=mesh)
    params = model.init(_generator(device, fold_in(args.seed, 2)))
    d = flat.tree_size(params)
    codec = strategy.wire_codec(params, policy=run.wire_policy) \
        if run.wire == "codec" else None
    data = make_token_dataset(
        _generator(torch.device("cpu"), fold_in(args.seed, 0)), num_seqs,
        seq_len, cfg.vocab_size)
    extras = {}
    if isinstance(model, EncDec):
        extras["frames"] = (cfg.num_mm_tokens, cfg.d_model)
    elif cfg.num_mm_tokens:
        extras["prefix_embeds"] = (cfg.num_mm_tokens, cfg.d_model)
    engine = RoundEngine(
        build_fl_round(model.loss, strategy, run, codec=codec),
        token_batcher(data, args.clients, args.local_steps, args.batch,
                      extras=extras, device=device,
                      clients=None if shardings is None
                      else shardings.local_clients(args.clients)),
        seed=args.seed, shardings=shardings)
    first = [engine.init_state(params, args.clients, strategy,
                               staleness_max=run.staleness_max)]
    del params                       # the state holds its own copy

    _write_run_config(args.out, {**run.to_json(), "arch": cfg.name,
                                 "seq_len": seq_len, "device": str(device),
                                 "world_size": world_size()})
    profiler = _make_profiler(args, 0)
    if profiler is not None:
        profiler.maybe_start(0)
    with _MetricsLog(args.out) as log:
        def on_eval(st, m, r):
            if profiler is not None:
                profiler.after_round(r - 1)
            if log.writer:
                log.write({"round": r, "loss": float(m.loss[-1]),
                           "cos": float(m.cosine[-1].mean()), "params": d})

        # the engine takes the only reference to the first state: kept in
        # this frame, it would stay on the device beside every later
        # round's (at 1.1 B parameters, 5 trees of 4.4 GB)
        try:
            state, hist = engine.run(first.pop(), args.rounds,
                                     eval_every=args.eval_every,
                                     eval_fn=on_eval)
        finally:
            if profiler is not None:
                profiler.close()
    state = _finish(state, shardings)
    if process_rank() == 0:
        _dump_obs(args.out)
    return state, hist


def train_lm_smoke(args) -> Tuple[FLState, RunHistory]:
    """The reference's reduced LM-family run: the arch's smoke config, 3SFC
    (10 steps at lr 0.1 over 8 synthetic positions) or the named
    compressor, FedAvg as identity without EF, on 2,048 sequences of 64
    tokens."""
    if getattr(args, "transport", "inproc") == "socket":
        raise ValueError(
            "--transport socket drives vision runs only: the worker rebuilds "
            "the client computation from the vision SETUP blob "
            "(repro_torch.launch.worker); the LM smoke path is in-process")
    cfg = get_smoke_config(args.arch)
    comp = CompressorConfig(kind=args.compressor if args.compressor != "fedavg"
                            else "identity",
                            error_feedback=args.compressor != "fedavg",
                            syn_steps=10, syn_lr=0.1, syn_seq=8)
    return train_lm(args, cfg, comp, SMOKE_SEQ_LEN, SMOKE_NUM_SEQS)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp",
                    choices=["mlp", "mnistnet", "convnet", "resnet", "regnet"])
    ap.add_argument("--dataset", default="mnist", choices=sorted(DATASETS))
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced LM-family FL run (requires --arch)")
    ap.add_argument("--compressor", default="threesfc",
                    choices=["fedavg", "dgc", "signsgd", "stc", "threesfc"])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=5, dest="local_steps")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--train-size", type=int, default=4000, dest="train_size")
    ap.add_argument("--eval-every", type=int, default=10, dest="eval_every")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/train_run_torch")
    ap.add_argument("--wire", default="float", choices=["float", "codec"],
                    help="what crosses the client/server boundary: float "
                         "trees (accounted bytes) or the repro_torch.comm "
                         "codec's framed uint8 buffers (measured bytes)")
    ap.add_argument("--fused-decode", action="store_true",
                    dest="fused_decode",
                    help="3SFC: the server aggregates the N (D_syn, s) "
                         "payloads in one backward instead of averaging N "
                         "reconstructed trees (RunConfig.fused_decode); a "
                         "round then never holds N model-sized trees")
    # fault model (repro_torch.fl.faults): all default to the zero-fault
    # config, which runs the exact unfaulted round
    ap.add_argument("--participation-rate", type=float, default=1.0,
                    dest="participation_rate",
                    help="fraction of clients scheduled each round")
    ap.add_argument("--drop-rate", type=float, default=0.0, dest="drop_rate",
                    help="probability a participating client's payload is "
                         "lost mid-round (EF banks the whole update)")
    ap.add_argument("--straggler-rate", type=float, default=0.0,
                    dest="straggler_rate",
                    help="probability a delivered payload arrives 1..k "
                         "rounds late (requires --staleness-max >= 1)")
    ap.add_argument("--staleness-max", type=int, default=0,
                    dest="staleness_max",
                    help="staleness bound k: late payloads are applied at "
                         "t+delay with weight 1/(1+delay); 0 disables the "
                         "ring buffer")
    ap.add_argument("--fault-seed", type=int, default=0, dest="fault_seed",
                    help="seed of the fault stream (schedules are a pure "
                         "function of (fault_seed, round))")
    ap.add_argument("--client-parallel", default="auto",
                    dest="client_parallel",
                    choices=["auto", "vmap", "shard_map"],
                    help="client fan-out: shard_map shares each round among "
                         "the job's ranks (torchrun), vmap is the "
                         "single-process loop; auto picks shard_map when "
                         "there is more than one rank and --clients divides "
                         "over them")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the run raises when cuda is "
                         "asked for and no CUDA device is available")
    # transport (repro_torch.comm.transport): socket mode spawns N worker
    # processes on the run's device and runs framed rounds over sockets
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "socket"],
                    help="how rounds move: one in-process loop or a "
                         "SocketServer + N worker processes (requires "
                         "--wire codec)")
    ap.add_argument("--round-deadline-s", type=float, default=30.0,
                    dest="round_deadline_s",
                    help="hard bound on one round's collect phase")
    ap.add_argument("--recv-timeout-s", type=float, default=2.0,
                    dest="recv_timeout_s",
                    help="per-client receive window before the first RESEND")
    ap.add_argument("--recv-backoff", type=float, default=2.0,
                    dest="recv_backoff",
                    help="exponential backoff factor per retry attempt")
    ap.add_argument("--transport-retries", type=int, default=2,
                    dest="transport_retries",
                    help="RESENDs before a client counts as dropped")
    ap.add_argument("--heartbeat-s", type=float, default=0.5,
                    dest="heartbeat_s", help="worker liveness tick period")
    ap.add_argument("--liveness-timeout-s", type=float, default=5.0,
                    dest="liveness_timeout_s",
                    help="silence window after which a worker counts as dead")
    # recovery (repro_torch.checkpoint): full-state recovery points and
    # bitwise resume, both transports
    ap.add_argument("--ckpt-every", type=int, default=0, dest="ckpt_every",
                    help="write a durable full-state recovery point every N "
                         "rounds (params + EF + staleness buffer + round "
                         "counter; socket: + byte ledger and EF bank) under "
                         "<out>/ckpt; 0 writes only the final params")
    ap.add_argument("--resume", default=None, metavar="CKPT_ROOT",
                    help="resume from the latest recovery point under this "
                         "checkpoint root (e.g. <out>/ckpt); the run must "
                         "use the same configuration, replays the remaining "
                         "rounds bitwise and appends to metrics.jsonl")
    # observability (repro_torch.obs)
    ap.add_argument("--trace", action="store_true",
                    help="record host-side spans (round phases, transport "
                         "framing, checkpoint I/O; socket workers piggyback "
                         "theirs) and write <out>/trace.jsonl + "
                         "trace.chrome.json")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace (host and device) "
                         "into DIR as a Chrome trace")
    ap.add_argument("--profile-window", default=None, metavar="A:B",
                    dest="profile_window",
                    help="restrict --profile to absolute rounds [A, B); "
                         "exact on --transport socket, snaps to eval-block "
                         "boundaries in-process")
    ap.add_argument("--metrics-port", type=int, default=None,
                    dest="metrics_port",
                    help="serve /healthz and /metrics (the obs meters "
                         "snapshot) on this port for the run's duration "
                         "(0 picks a free port)")
    return ap.parse_args(argv)


def main(argv=None) -> FLState:
    args = parse_args(argv)
    owned = not dist.is_initialized()
    tracer = get_tracer()
    if args.trace:
        configure_tracer(True, proc="server")
    http = None
    if args.metrics_port is not None:
        http = ObsHTTPServer(port=args.metrics_port)
        print(f"metrics -> {http.url}/metrics", flush=True)
    try:
        if args.arch and args.smoke:
            return train_lm_smoke(args)[0]
        return train_vision(args)
    finally:
        set_tracer(tracer)              # the run's tracer ends with it
        if http is not None:
            http.stop()
        # a process group the fan-out started ends with the run
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
