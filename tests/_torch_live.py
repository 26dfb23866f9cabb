"""Shared pieces of the port's live-socket tests (tests/test_torch_
transport.py, tests/test_torch_recovery.py): the tiny world their 2 CPU
workers rebuild, the port's in-process codec round over the same seed as
the bitwise oracle, and the teardown.

CPU results depend on the thread count, and the workers run one thread
each, so the oracle runs on one thread too.
"""
import contextlib

import numpy as np
import torch

from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.fl.engine import RetryPolicy, RoundEngine, vision_batcher
from repro_torch.fl.round import build_fl_round
from repro_torch.launch.train import (vision_data, vision_model,
                                      vision_strategy)
from repro_torch.models.cnn import VisionSpec

CPU = torch.device("cpu")
TINY = VisionSpec("tiny", (6, 6, 1), 3)
TRAIN_N = 96
# the first round warms every worker up: a generous window, no resends
WARM = RetryPolicy(max_retries=0, recv_timeout_s=90.0, max_timeout_s=90.0)


@contextlib.contextmanager
def one_thread():
    """The CPU workers' thread count, for an oracle their results must
    match bitwise."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def tiny_world(kind: str, n: int):
    comp = CompressorConfig(kind=kind, keep_ratio=0.1, syn_steps=2)
    fl = FLConfig(num_clients=n, local_steps=2, local_lr=0.05,
                  local_batch=4, compressor=comp, seed=0)
    run = RunConfig(fl=fl, wire="codec", transport="socket",
                    round_deadline_s=60.0, recv_timeout_s=30.0,
                    transport_retries=0, heartbeat_s=0.2,
                    liveness_timeout_s=5.0)
    model, params = vision_model("mlp", TINY, fl.seed, CPU)
    strategy = vision_strategy(model, TINY, fl)
    codec = strategy.wire_codec(params, policy=run.wire_policy)
    return run, model, params, strategy, codec


def inproc_oracle(kind: str, n: int, rounds: int, schedule_fn=None):
    """The port's in-process codec round over the same seed: (params, EF
    tree) after ``rounds`` rounds, on one thread."""
    from repro_torch.fl.faults import null_schedule

    run, model, params, strategy, codec = tiny_world(kind, n)
    train, pools = vision_data(TINY, run.fl, TRAIN_N, CPU)
    with one_thread():
        engine = RoundEngine(
            build_fl_round(model.loss, strategy,
                           RunConfig(fl=run.fl, wire="codec"), codec=codec,
                           fault_schedule_fn=schedule_fn
                           or (lambda r, m: null_schedule(m))),
            vision_batcher(train.x, train.y, pools, run.fl.local_steps,
                           run.fl.local_batch),
            seed=run.fl.seed)
        state = engine.init_state(params, n, strategy)
        state, _ = engine.run_loop(state, rounds)
    return state.params, state.ef


def ef_row(ef, i) -> np.ndarray:
    return torch.cat([l[i].reshape(-1) for l in tree_leaves(ef)]).numpy()


def stop_all(server, procs) -> None:
    server.stop()
    for p in procs:
        try:
            p.wait(timeout=15)
        except Exception:
            p.kill()
            p.wait()
