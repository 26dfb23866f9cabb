"""The port's crash-safe recovery: the mirror of tests/test_recovery.py
(bitwise resume of the in-process engine from a mid-run recovery point,
the absolute-round checkpoint cadence, ``ckpt_every`` in the run config,
and — over real sockets — a SIGKILLed worker rejoining with its EF
residual re-synced from the server's bank), with the rejoin held bitwise
to the port's in-process codec round under the schedule the outage
makes, and the trainer's ``--ckpt-every``/``--resume`` bitwise the
uninterrupted run on both transports.

Every round is a pure function of (seed, fault_seed, absolute round), so
restoring the state restores the trajectory, however rounds are grouped.
"""
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, load_fl_checkpoint,
                                    save_fl_checkpoint)
from repro_torch.configs.base import CompressorConfig, FLConfig
from repro_torch.configs.run import RunConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.fl.engine import RoundEngine, vision_batcher
from repro_torch.fl.faults import FaultSchedule, null_schedule
from repro_torch.fl.round import build_fl_round
from repro_torch.launch import train
from repro_torch.launch.train import (vision_data, vision_model,
                                      vision_strategy)
from _torch_live import (CPU, TINY, TRAIN_N, WARM, ef_row, inproc_oracle,
                         stop_all, tiny_world)

torch.set_num_threads(2)


def _faulted_problem(num_clients=4):
    """Tiny faulted vision problem: drops, stragglers and the staleness
    buffer, so a recovery point must carry every piece of round state."""
    comp = CompressorConfig(kind="stc", keep_ratio=0.1)
    fl = FLConfig(num_clients=num_clients, local_steps=2, local_lr=0.05,
                  local_batch=4, compressor=comp, seed=0)
    run = RunConfig(fl=fl, drop_rate=0.3, straggler_rate=0.25,
                    staleness_max=2, fault_seed=7)
    model, params = vision_model("mlp", TINY, fl.seed, CPU)
    strategy = vision_strategy(model, TINY, fl)
    train_set, pools = vision_data(TINY, fl, 120, CPU)

    def make_engine():
        return RoundEngine(
            build_fl_round(model.loss, strategy, run),
            vision_batcher(train_set.x, train_set.y, pools, fl.local_steps,
                           fl.local_batch),
            seed=fl.seed)

    return make_engine, params, strategy, run


def _state_equal(a, b) -> bool:
    if a.round != b.round:
        return False
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def test_inproc_resume_is_bitwise_equal_to_uninterrupted_run(tmp_path):
    """Oracle: 8 straight faulted rounds. Recovery path: checkpoint every
    2 rounds (eval every 3 — coprime cadences), load the step-4 recovery
    point into a FRESH engine and template, run the remaining 4 rounds.
    Params, per-client EF, the staleness buffer and the round counter are
    all bitwise equal."""
    make_engine, params, strategy, run = _faulted_problem()
    N, R, CUT = run.fl.num_clients, 8, 4

    oracle = make_engine()
    st = oracle.init_state(params, N, strategy,
                           staleness_max=run.staleness_max)
    oracle_final, _ = oracle.run(st, R)

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    eng = make_engine()
    st = eng.init_state(params, N, strategy, staleness_max=run.staleness_max)
    eng.run(st, CUT + 1, eval_every=3, ckpt_every=2,
            ckpt_fn=lambda s, r: save_fl_checkpoint(mgr, r, s, run=run))
    assert mgr.steps() == [2, 4]                # absolute-round cadence

    resumed = make_engine()
    template = resumed.init_state(params, N, strategy,
                                  staleness_max=run.staleness_max)
    state, _, meta = load_fl_checkpoint(mgr, template, step=CUT)
    assert meta["round"] == CUT and state.round == CUT
    assert meta["run"] == run.to_json()
    resumed_final, _ = resumed.run(state, R - CUT)

    assert resumed_final.round == oracle_final.round == R
    assert _state_equal(oracle_final, resumed_final)


def test_ckpt_hook_fires_on_absolute_round_boundaries():
    """ckpt_every anchors on FLState.round: a state resumed at round 8
    checkpoints at 12, where the uninterrupted run does; eval boundaries
    still fire relative."""
    make_engine, params, strategy, run = _faulted_problem()
    N = run.fl.num_clients
    fired = []
    eng = make_engine()
    st = eng.init_state(params, N, strategy, staleness_max=run.staleness_max)
    st, hist = eng.run(st, 8, eval_every=3, eval_fn=lambda s, m, r: r,
                       ckpt_every=2, ckpt_fn=lambda s, r: fired.append(r))
    assert fired == [2, 4, 6, 8]
    assert [r for r, _ in hist.evals] == [3, 6, 8]
    fired2 = []
    st, _ = eng.run(st, 5, ckpt_every=4,
                    ckpt_fn=lambda s, r: fired2.append(r))
    assert fired2 == [12] and st.round == 13


def test_run_config_ckpt_every_roundtrips_and_validates():
    run = RunConfig(fl=FLConfig(num_clients=2), ckpt_every=5)
    assert RunConfig.from_json(run.to_json()).ckpt_every == 5
    assert RunConfig.from_json(run.to_json()) == run
    d = run.to_json()
    d.pop("ckpt_every")
    assert RunConfig.from_json(d).ckpt_every == 0
    with pytest.raises(ValueError):
        RunConfig(fl=FLConfig(num_clients=2), ckpt_every=-1)
    # the port's JSON is the reference's, key for key
    from repro.configs.base import FLConfig as JFL
    from repro.configs.run import RunConfig as JRun
    jrun = JRun(fl=JFL(num_clients=2), ckpt_every=5)
    assert run.to_json() == jrun.to_json()
    assert RunConfig.from_json(jrun.to_json()) == run


# ---------------------------------------------------------------------------
# live sockets: a SIGKILLed worker rejoins with its banked EF residual
# ---------------------------------------------------------------------------


def outage_schedule(kill: int, rounds):
    """The in-process schedule of a worker that is dead in ``rounds``: it
    sits those out (its EF frozen), everyone else is healthy."""
    def fn(r, n):
        sched = null_schedule(n)
        if r in rounds:
            part = sched.participate.clone()
            part[kill] = False
            return FaultSchedule(part, sched.delivered, sched.delay,
                                 sched.weight)
        return sched
    return fn


@pytest.mark.transport(timeout=300)
def test_killed_worker_rejoins_with_banked_ef_resynced(tmp_path):
    """SIGKILL a worker, drive rounds without it (delivered=False, its
    residual frozen server-side), restart its process: the rejoiner's
    installed EF is bitwise the banked commit, it re-enters delivery, the
    missed rounds are recorded dead and undelivered — and the params and
    every EF after the rejoin round are bitwise the in-process round
    under the schedule in which it sat those rounds out."""
    from repro_torch.comm.transport import SocketServer, spawn_local_workers
    from repro_torch.fl.engine import LiveRoundLoop

    N, KILL = 2, 1
    run, model, params, strategy, codec = tiny_world("stc", N)
    server = SocketServer(N, heartbeat_s=run.heartbeat_s,
                          liveness_timeout_s=run.liveness_timeout_s)
    procs = spawn_local_workers(server.address, range(N), device="cpu",
                                log_dir=str(tmp_path))
    rejoin_procs = []
    try:
        server.wait_ready(60)
        server.send_setup(vision_setup_tiny(run))
        loop = LiveRoundLoop(server, strategy, codec, run, params)
        loop.run(2, deadline_s=90.0, policy=WARM)
        assert server.wait_ef_bank(1, range(N), timeout=30.0)
        banked = server.ef_bank()                        # post-round-1

        procs[KILL].send_signal(signal.SIGKILL)
        procs[KILL].wait()
        deadline = time.monotonic() + 20
        while KILL in server.live_workers():
            assert time.monotonic() < deadline, "server never noticed death"
            time.sleep(0.05)
        loop.run(2)                                      # rounds 2-3

        rejoin_procs = spawn_local_workers(server.address, [KILL],
                                           device="cpu",
                                           log_dir=str(tmp_path))
        deadline = time.monotonic() + 60
        while KILL not in server.live_workers():
            assert time.monotonic() < deadline, "rejoiner never connected"
            time.sleep(0.05)
        ef = server.request_ef(KILL, timeout=60)
        assert ef is not None
        np.testing.assert_array_equal(ef, banked[KILL][1])
        live_params = loop.run(1, deadline_s=90.0, policy=WARM)
        efs = [server.request_ef(i, timeout=30) for i in range(N)]
    finally:
        stop_all(server, list(procs) + list(rejoin_procs))

    recs = {r["round"]: r for r in loop.history}
    assert recs[1]["delivered"].all()
    assert not recs[2]["delivered"][KILL] and KILL in recs[2]["dead"]
    assert not recs[3]["delivered"][KILL] and KILL in recs[3]["dead"]
    assert recs[4]["delivered"].all() and KILL not in recs[4]["dead"]
    want_params, want_ef = inproc_oracle(
        "stc", N, 5, schedule_fn=outage_schedule(KILL, (2, 3)))
    for a, b in zip(tree_leaves(want_params), tree_leaves(live_params)):
        assert torch.equal(a, b)
    for i in range(N):
        np.testing.assert_array_equal(efs[i], ef_row(want_ef, i))


def vision_setup_tiny(run):
    from repro_torch.launch.worker import vision_setup
    return vision_setup(run, model="mlp", spec=TINY, train_size=TRAIN_N,
                        device="cpu")


# ---------------------------------------------------------------------------
# the trainer's --ckpt-every / --resume, both transports
# ---------------------------------------------------------------------------


def _train(out, rounds, *flags):
    return train.main([
        "--compressor", "stc", "--wire", "codec", "--rounds", str(rounds),
        "--clients", "2", "--local-steps", "2", "--batch", "8",
        "--train-size", "128", "--eval-every", "1", "--device", "cpu",
        "--ckpt-every", "2", "--round-deadline-s", "60",
        "--out", str(out), *flags])


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_trainer_resume_is_bitwise_the_uninterrupted_run(tmp_path,
                                                         transport):
    """4 rounds straight against 2 rounds, then ``--resume`` to round 4
    from the step-2 recovery point: the final params bitwise equal, and
    every client's EF too (on the socket the resumed workers are re-synced
    from the checkpointed bank)."""
    flags = ("--transport", transport)
    whole = _train(tmp_path / "whole", 4, *flags)
    part = tmp_path / "part"
    _train(part, 2, *flags)
    mgr = CheckpointManager(str(part / "ckpt"))
    assert mgr.steps() == [2]
    resumed = _train(part, 4, *flags, "--resume", str(part / "ckpt"))
    assert mgr.steps() == [2, 4]
    assert resumed.round == whole.round == 4
    for a, b in zip(tree_leaves(whole.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    assert whole.ef is not None and resumed.ef is not None
    for a, b in zip(tree_leaves(whole.ef), tree_leaves(resumed.ef)):
        assert torch.equal(a, b)
    rows = [json.loads(l) for l in open(part / "metrics.jsonl")]
    assert [r["round"] for r in rows] == [1, 2, 3, 4]
    assert os.path.isdir(part / "final")
    # a resume under another configuration is refused
    with pytest.raises(ValueError, match="configuration mismatch"):
        _train(tmp_path / "other", 6, *flags, "--lr", "0.5", "--resume",
               str(part / "ckpt"))
