"""Ranks for the port's sharded client fan-out tests, on the CPU over gloo.

``run_ranks(scenario, world, tmp_path)`` (``start_ranks`` then
``collect``, for a caller with work of its own meanwhile) starts ``world``
processes of::

    python tests/_torch_fanout.py SCENARIO RANK WORLD STORE OUT

each of which joins one gloo process group through a ``FileStore`` under
``tmp_path`` (no TCP port, so parallel test workers never collide), sets
``torch.set_num_threads(2)`` as the test files do, and runs the scenario's
checks in order. After each check a rank rewrites ``OUT/SCENARIO.rank<r>
.json`` with the checks passed so far; the first failure ends the rank
with its traceback in ``OUT/SCENARIO.rank<r>.log``. ``run_ranks`` joins
the ranks within a deadline, kills them past it, and returns each rank's
record. A test then asserts that its own check passed on every rank, so
one spawn serves several tests. Spawning, joining and the bitwise
comparison are the port's ``repro_torch.launch.ranks``, which the card's
smoke run uses too.

The single-process oracle of every sharded run is computed inside each
rank's own process, with the same thread count, so "bitwise" compares two
runs of the same math. This module imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.ranks import Ranks, bits_equal, tree_bits_diff

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

CPU = torch.device("cpu")
# the reference's sizes (tests/test_shard_round.py)
N, K, B, ROUNDS = 8, 2, 8, 3
KINDS = {
    "fedavg": dict(kind="identity", error_feedback=False),
    "dgc": dict(kind="topk", keep_ratio=0.05),
    "signsgd": dict(kind="signsgd"),
    "stc": dict(kind="stc", keep_ratio=0.05),
    "threesfc": dict(kind="threesfc", syn_steps=2, syn_lr=0.1),
}
# every registered kind: the reference's engine kinds and the two without
# a wire format
ALL_KINDS = {**KINDS, "randk": dict(kind="randk", keep_ratio=0.05),
             "fedsynth": dict(kind="fedsynth", syn_steps=2, syn_lr=0.1)}
# the reference's fault scenario: a 4x4x1 -> 3 MLP, K = 1
FAULT_N, FAULT_K = 8, 1
FAULT_KNOBS = dict(participation_rate=0.7, drop_rate=0.2,
                   straggler_rate=0.3, staleness_max=2, fault_seed=5)


# ---------------------------------------------------------------------------
# the parent side
# ---------------------------------------------------------------------------


def start_ranks(scenario: str, world: int, tmp_path, extra=()) -> Ranks:
    """Start ``world`` ranks of ``scenario`` and return them running (the
    caller joins them with ``collect``)."""
    out = str(tmp_path)
    store = os.path.join(out, f"{scenario}.{world}.store")
    if os.path.exists(store):        # a FileStore must start empty
        os.remove(store)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    argvs = [[sys.executable, os.path.abspath(__file__), scenario, str(r),
              str(world), store, out, *extra] for r in range(world)]
    logs = [os.path.join(out, f"{scenario}.rank{r}.log")
            for r in range(world)]
    return Ranks(argvs, logs, env=env, cwd=REPO)


def collect(ranks: Ranks, scenario: str, world: int, tmp_path,
            timeout: float = 300) -> list:
    """Join ``ranks`` within ``timeout`` seconds of their start (killing
    what is left) and return each rank's record (``{"ok": [check, ...],
    "failed": check or None, ...}``)."""
    with ranks:
        rcs = ranks.join(timeout)
    records = []
    for r in range(world):
        path = os.path.join(str(tmp_path), f"{scenario}.rank{r}.json")
        rec = json.load(open(path)) if os.path.exists(path) else {"ok": []}
        rec["rc"] = rcs[r]
        rec["log"] = ranks.log(r)
        records.append(rec)
    return records


def run_ranks(scenario: str, world: int, tmp_path, timeout: float = 300,
              extra=()) -> list:
    """Run ``scenario`` on ``world`` ranks; returns each rank's record."""
    return collect(start_ranks(scenario, world, tmp_path, extra), scenario,
                   world, tmp_path, timeout)


def assert_check(records: list, check: str) -> None:
    """``check`` passed on every rank."""
    for r, rec in enumerate(records):
        if check not in rec["ok"]:
            raise AssertionError(
                f"check {check!r} did not pass on rank {r} (exit "
                f"{rec['rc']}, failed: {rec.get('failed')})\n"
                f"--- rank {r} log ---\n{rec['log'][-6000:]}")


# ---------------------------------------------------------------------------
# helpers of the ranks
# ---------------------------------------------------------------------------


def leaves(tree) -> list:
    from repro_torch.core import flat
    return flat.tree_leaves(tree)


def snapshot(tree) -> list:
    """Copies of a tree's leaves, to hold it unwritten later."""
    return [t.clone() for t in leaves(tree)]


def assert_tree_bits(a, b, what: str) -> None:
    diff = tree_bits_diff(a, b)
    assert diff is None, f"{what}: {diff}"


def assert_metrics_bits(ma, mb, what: str) -> None:
    for f in ma._fields:
        assert bits_equal(getattr(ma, f), getattr(mb, f)), \
            f"{what}: metric {f} not bitwise equal"


def vision_world():
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import make_class_image_dataset
    from repro_torch.models.cnn import MNIST_SPEC, make_paper_model
    model = make_paper_model("mlp", MNIST_SPEC)
    params = model.init(torch.Generator().manual_seed(0))
    train = make_class_image_dataset(torch.Generator().manual_seed(1), 400,
                                     MNIST_SPEC.input_shape, 10)
    parts = dirichlet_partition(train.y, N, alpha=0.5, seed=0,
                                min_per_client=16)
    return model, params, train, parts


def strategy_for(model, spec, kind: str, **over):
    from repro_torch.configs.base import CompressorConfig
    from repro_torch.core.strategy import make_strategy
    from repro_torch.models.build import vision_syn_spec
    comp = CompressorConfig(**{**ALL_KINDS[kind], **over})
    return comp, make_strategy(comp, loss_fn=model.syn_loss,
                               syn_spec=vision_syn_spec(spec, comp),
                               local_lr=0.05)


def engine(world, kind: str, shardings=None, mesh=None, donate=True,
           **run_kw):
    """The reference's ``_world`` engine on the port: (engine, state,
    codec)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.fl.engine import RoundEngine, device_pools, \
        vision_batcher
    from repro_torch.fl.round import build_fl_round
    from repro_torch.models.cnn import MNIST_SPEC
    model, params, train, parts = world
    comp, strat = strategy_for(model, MNIST_SPEC, kind)
    if shardings is not None:
        run_kw.update(client_parallel="shard_map", mesh=mesh)
    run = RunConfig(fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.05,
                                local_batch=B, compressor=comp), **run_kw)
    codec = strat.wire_codec(params) if run.wire == "codec" else None
    pools, clients = device_pools(parts, CPU), None
    if shardings is not None:
        pools = shardings.place_pools(pools)
        clients = shardings.local_clients(N)
    eng = RoundEngine(build_fl_round(model.loss, strat, run, codec=codec),
                      vision_batcher(train.x, train.y, pools, K, B,
                                     clients=clients),
                      seed=0, donate=donate, shardings=shardings)
    return eng, eng.init_state(params, N, strat,
                               staleness_max=run.staleness_max), codec


def counters():
    from repro_torch.fl import sharding
    return sharding.COLLECTIVES, sharding.GATHERED_BYTES


def sharded_vs_single(world, sh, mesh, kind: str, rounds: int = ROUNDS,
                      **run_kw):
    """``rounds`` rounds of one configuration through the single-process
    engine and the sharded one: final params, the gathered EF and every
    RoundMetrics field bitwise; exactly one collective per round. Returns
    the bytes this rank gathered per local client per round and the
    codec."""
    e1, s1, _ = engine(world, kind, **run_kw)
    s1, m1 = e1.run_block(s1, rounds)
    e2, s2, codec = engine(world, kind, sh, mesh, **run_kw)
    c0, b0 = counters()
    s2, m2 = e2.run_block(s2, rounds)
    c1, b1 = counters()
    tag = f"{kind} {run_kw}"
    assert c1 - c0 == rounds, f"{tag}: {c1 - c0} collectives in {rounds} " \
                              f"rounds"
    local = len(sh.local_clients(N))
    assert leaves(s2.ef)[0].shape[0] == local, tag
    full = sh.gather_state(s2)
    assert_tree_bits(s1.params, full.params, f"{tag} params")
    assert_tree_bits(s1.ef, full.ef, f"{tag} EF")
    assert_metrics_bits(m1, m2, tag)
    assert s1.round == s2.round == rounds
    return (b1 - b0) / (rounds * local), codec


class Rank:
    """One rank of a scenario: runs its checks, records what passed."""

    def __init__(self, scenario, rank, world, out):
        self.scenario, self.rank, self.world, self.out = (scenario, rank,
                                                          world, out)
        self.record = {"ok": [], "failed": None, "notes": {}}

    def _dump(self):
        path = os.path.join(self.out, f"{self.scenario}.rank{self.rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(self.record, f)
        os.replace(path + ".tmp", path)

    def check(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        try:
            note = fn(*args, **kw)
        except BaseException:
            self.record["failed"] = name
            self._dump()
            raise
        if note is not None:
            self.record["notes"][name] = note
        self.record["ok"].append(name)
        print(f"ok {name} ({time.perf_counter() - t0:.1f} s)", flush=True)
        self._dump()


# ---------------------------------------------------------------------------
# scenario "sharding": the mesh and placement units
# ---------------------------------------------------------------------------


def _client_axes(world):
    from repro_torch.launch.mesh import (axis_size, client_axes,
                                         make_host_mesh, num_clients_for)
    mesh = make_host_mesh(device="cpu")
    assert client_axes(mesh) == ("data",)
    assert num_clients_for(mesh) == tuple(mesh.mesh.shape)[0] == world
    assert axis_size(mesh, "model") == 1 and axis_size(mesh, "pod") == 1


def _production_mesh_needs_its_ranks():
    """The production shapes (16x16, 2x16x16) need 256 and 512 ranks: on a
    smaller job the mesh is refused, not truncated."""
    import pytest
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="bigger than"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


def _rejects_nondivisible(world):
    import pytest
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(ValueError, match="n % model"):
        make_host_mesh(model=world + 1, device="cpu")
    with pytest.raises(ValueError, match="n % model"):
        make_host_mesh(model=0, device="cpu")


def _units(rank, world):
    import pytest
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.fl.engine import ClientPools
    from repro_torch.fl.round import fl_init
    from repro_torch.fl.sharding import all_gather_rows, make_fl_shardings
    from repro_torch.launch.mesh import client_axes, make_host_mesh

    mesh = make_host_mesh(device="cpu")
    assert tuple(mesh.mesh.shape) == (world, 1)
    sh = make_fl_shardings(mesh)
    assert sh.axes == client_axes(mesh) == ("data",)
    assert sh.client_shards == world and sh.shard == rank
    assert sh.replicated == (Replicate(), Replicate())
    assert sh.client == (Shard(0), Replicate())
    assert sh.state.params == sh.replicated and sh.state.ef == sh.client
    with pytest.raises(ValueError, match="not divisible"):
        sh.check_divisible(2 * world + 1)
    # placement: params as they are, EF cut to this rank's block of rows
    n = 4 * world
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn((16, 4), generator=g),
              "b": torch.randn((4,), generator=g)}
    whole = fl_init(params, n)
    whole = whole._replace(ef={k: torch.randn(v.shape, generator=g)
                               for k, v in whole.ef.items()})
    state = sh.place_state(whole)
    assert state.params is whole.params
    ids = sh.local_clients(n)
    assert ids == range(4 * rank, 4 * rank + 4)
    for k in whole.ef:
        assert tuple(state.ef[k].shape) == (4, *whole.ef[k].shape[1:])
        assert torch.equal(state.ef[k], whole.ef[k][ids.start:ids.stop])
    pools = sh.place_pools(ClientPools(
        torch.arange(n * 5).reshape(n, 5), torch.ones((n,), dtype=torch.int64)))
    assert tuple(pools.index.shape) == (4, 5)
    assert int(pools.index[0, 0]) == 5 * ids.start
    # the gather: rank order is client order, bytes exact, one collective
    from repro_torch.fl import sharding
    c0 = sharding.COLLECTIVES
    back = sh.gather_state(state)
    assert sharding.COLLECTIVES == c0 + 1
    assert_tree_bits(back.ef, whole.ef, "gather_state")
    # place_state and gather_state follow the placement tree: a field
    # placed as client is cut and gathered, a replicated one is left
    import dataclasses
    sh_buf = dataclasses.replace(sh, state=sh.state._replace(buf=sh.client))
    with_buf = whole._replace(buf=whole.ef)
    assert sh.place_state(with_buf).buf is with_buf.buf
    cut = sh_buf.place_state(with_buf)
    assert cut.round == whole.round and cut.params is whole.params
    assert_tree_bits(cut.buf, state.ef, "a client-placed buffer")
    assert_tree_bits(sh_buf.gather_state(cut).buf, whole.ef,
                     "the buffer gathered")
    frames = [torch.randint(0, 256, (13,), dtype=torch.uint8, generator=g)
              for _ in range(2)]
    rows = [(f, torch.tensor(float(2 * rank + j)),
             {"i": torch.tensor([2 * rank + j, -1]),
              "h": torch.randn((3,), generator=g).to(torch.bfloat16)})
            for j, f in enumerate(frames)]
    got = all_gather_rows(rows, sh.group)
    assert tuple(got[0].shape) == (2 * world, 13)
    assert got[0].dtype == torch.uint8 and got[2]["h"].dtype == torch.bfloat16
    assert torch.equal(got[1], torch.arange(2 * world, dtype=torch.float32))
    assert torch.equal(got[2]["i"][:, 0], torch.arange(2 * world))
    mine = slice(2 * rank, 2 * rank + 2)
    assert torch.equal(got[0][mine], torch.stack(frames))
    assert bits_equal(got[2]["h"][mine], torch.stack(
        [r[2]["h"] for r in rows]))


def _pod_mesh(rank, world):
    """The production mesh's client axes ("pod", "data") on a (2, P/2, 1)
    mesh: the client group is the flattened sub-mesh, its rank order the
    (pod, data) block order."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.fl.sharding import all_gather_rows, make_fl_shardings
    from repro_torch.launch.mesh import client_axes, num_clients_for

    mesh = init_device_mesh("cpu", (2, world // 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    assert client_axes(mesh) == ("pod", "data")
    assert num_clients_for(mesh) == world
    sh = make_fl_shardings(mesh)
    assert sh.client == (Shard(0), Shard(0), Replicate())
    assert sh.client_shards == world and sh.shard == rank
    assert make_fl_shardings(mesh).group is sh.group      # cached
    n = 2 * world
    assert sh.local_clients(n) == range(2 * rank, 2 * rank + 2)
    got = all_gather_rows([torch.tensor([float(i)])
                           for i in sh.local_clients(n)], sh.group)
    assert torch.equal(got[:, 0], torch.arange(n, dtype=torch.float32))


def _run_config(world):
    """RunConfig's shard_map checks (the reference's): a mesh is needed,
    the clients must divide over its client shards, socket transport
    takes the single-process fan-out; ``mesh`` is never serialized."""
    import pytest

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    run = RunConfig(fl=FLConfig(num_clients=2 * world),
                    client_parallel="shard_map", mesh=mesh)
    assert run.client_axes() == ("data",)
    assert "mesh" not in run.to_json()
    assert run.to_json()["client_parallel"] == "shard_map"
    with pytest.raises(ValueError, match="not divisible"):
        RunConfig(fl=FLConfig(num_clients=2 * world + 1),
                  client_parallel="shard_map", mesh=mesh)
    with pytest.raises(ValueError, match="requires client_parallel='vmap'"):
        RunConfig(fl=FLConfig(num_clients=2 * world), transport="socket",
                  wire="codec", client_parallel="shard_map", mesh=mesh)


def _make_fanout(world):
    import pytest

    from repro_torch.launch import train

    def args(clients, mode):
        return argparse.Namespace(clients=clients, client_parallel=mode)

    mode, mesh, sh = train.make_fanout(args(2 * world, "auto"), CPU)
    assert mode == "shard_map" and sh.client_shards == world
    assert tuple(mesh.mesh.shape) == (world, 1)
    assert train.make_fanout(args(2 * world, "vmap"), CPU) == (
        "vmap", None, None)
    # auto falls back when the clients do not divide; explicit raises
    assert train.make_fanout(args(2 * world + 1, "auto"), CPU)[0] == "vmap"
    with pytest.raises(ValueError, match="not divisible"):
        train.make_fanout(args(2 * world + 1, "shard_map"), CPU)


def scenario_sharding(r: Rank):
    r.check("client_axes", _client_axes, r.world)
    r.check("make_host_mesh_rejects_nondivisible_model",
            _rejects_nondivisible, r.world)
    r.check("fl_shardings_units", _units, r.rank, r.world)
    r.check("make_fanout", _make_fanout, r.world)
    r.check("run_config", _run_config, r.world)
    r.check("production_mesh", _production_mesh_needs_its_ranks)
    if r.world >= 4:
        r.check("pod_mesh", _pod_mesh, r.rank, r.world)


# ---------------------------------------------------------------------------
# scenario "rounds": the sharded round against the single-process round
# ---------------------------------------------------------------------------


def _bitexact(world, sh, mesh):
    for kind in KINDS:
        sharded_vs_single(world, sh, mesh, kind)
    per_client, _ = sharded_vs_single(world, sh, mesh, "threesfc",
                                      fused_decode=True)
    return {"fused_bytes_per_client": per_client}


def _wire(world, sh, mesh):
    """Codec mode: only frames (and the clients' three f32 metrics) cross
    the gather, exactly ``codec.nbytes`` frame bytes per local client."""
    notes = {}
    for kind in KINDS:
        per_client, codec = sharded_vs_single(world, sh, mesh, kind,
                                              wire="codec")
        assert per_client == codec.nbytes + 12, (kind, per_client,
                                                 codec.nbytes)
        notes[kind] = per_client
    per_client, codec = sharded_vs_single(world, sh, mesh, "threesfc",
                                          wire="codec", fused_decode=True)
    assert per_client == codec.nbytes + 8, (per_client, codec.nbytes)
    notes["threesfc_fused"] = per_client
    return notes


def _gathered_bytes(world, sh, mesh):
    """Bytes per client in the gather at the reference's MLP on MNIST
    shapes: float 3SFC carries the d-float reconstruction and three f32
    metrics, fused 3SFC its 795-float payload, the loss and the cosine —
    the reference's per-device all-gather bytes (BENCH_collectives.json:
    796,852 and 3,188)."""
    from repro_torch.core import flat
    d = flat.tree_size(world[1])
    e, s, _ = engine(world, "threesfc", sh, mesh)
    _, b0 = counters()
    e.run_block(s, 1)
    _, b1 = counters()
    float_b = (b1 - b0) / len(sh.local_clients(N))
    e, s, _ = engine(world, "threesfc", sh, mesh, fused_decode=True)
    e.run_block(s, 1)
    _, b2 = counters()
    fused_b = (b2 - b1) / len(sh.local_clients(N))
    assert float_b == 4 * d + 12 == 796_852, float_b
    assert fused_b == 4 * 795 + 8 == 3_188, fused_b
    return {"float": float_b, "fused": fused_b, "ratio": float_b / fused_b}


def fault_world():
    from repro_torch.models.cnn import VisionSpec, make_paper_model
    spec = VisionSpec("tiny", (4, 4, 1), 3)
    model = make_paper_model("mlp", spec)
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batches = {"x": torch.randn((FAULT_N, FAULT_K, B, 4, 4, 1), generator=g),
               "y": torch.randint(0, 3, (FAULT_N, FAULT_K, B), generator=g)}
    return spec, model, params, batches


def fault_round(fw, kind, wire="float", fused=False, sched_fn=None,
                mesh=None, **knobs):
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.fl.round import build_fl_round
    spec, model, params, _ = fw
    comp, strat = strategy_for(model, spec, kind, keep_ratio=0.2)
    run = RunConfig(fl=FLConfig(num_clients=FAULT_N, local_steps=FAULT_K,
                                local_lr=0.05, local_batch=B,
                                compressor=comp),
                    wire=wire, fused_decode=fused,
                    client_parallel="vmap" if mesh is None else "shard_map",
                    mesh=mesh, **knobs)
    codec = strat.wire_codec(params) if wire == "codec" else None
    return build_fl_round(model.loss, strat, run, codec=codec,
                          fault_schedule_fn=sched_fn), strat, run


def _run_rounds(rf, state, batches, rounds=ROUNDS):
    ms = []
    for r in range(rounds):
        state, m = rf(state, batches, 100 + r)
        ms.append(m)
    return state, ms


def _fault_pair(fw, sh, mesh, kind, wire="float", fused=False,
                sched_fn=None, **knobs):
    """The same faulted (or null-schedule) rounds single-process and
    sharded: params, the gathered EF, the staleness buffer and every
    metric bitwise."""
    from repro_torch.fl.round import fl_init
    _, _, params, batches = fw
    rf1, strat, run = fault_round(fw, kind, wire, fused, sched_fn, **knobs)
    rf2, _, _ = fault_round(fw, kind, wire, fused, sched_fn, mesh, **knobs)
    s0 = fl_init(params, FAULT_N, strat, staleness_max=run.staleness_max)
    s1, m1 = _run_rounds(rf1, s0, batches)
    c0, _ = counters()
    s2, m2 = _run_rounds(rf2, sh.place_state(s0),
                         sh.place_client_tree(batches))
    assert counters()[0] - c0 == ROUNDS
    tag = f"{kind}/{wire}{'/fused' if fused else ''} {knobs}"
    full = sh.gather_state(s2)
    assert_tree_bits((s1.params, s1.ef, s1.buf, s1.buf_w),
                     (full.params, full.ef, full.buf, full.buf_w), tag)
    for a, b in zip(m1, m2):
        assert_metrics_bits(a, b, tag)
    return s2, m2


def _faults(sh, mesh):
    fw = fault_world()
    arrivals = {}
    for kind, wire in (("threesfc", "float"), ("dgc", "float"),
                       ("fedavg", "float"), ("signsgd", "codec")):
        _, ms = _fault_pair(fw, sh, mesh, kind, wire, **FAULT_KNOBS)
        arrivals[f"{kind}/{wire}"] = [float(m.arrivals) for m in ms]
        assert min(arrivals[f"{kind}/{wire}"]) < FAULT_N, arrivals
    # fused 3SFC under faults takes no staleness (RunConfig)
    _fault_pair(fw, sh, mesh, "threesfc", fused=True, participation_rate=0.7,
                drop_rate=0.2, fault_seed=5)
    return arrivals


def _null_schedule(sh, mesh):
    """The masked pipeline under the null schedule: bitwise the sharded
    unfaulted round, which is bitwise the single-process one."""
    from repro_torch.fl import faults
    fw = fault_world()
    null = lambda r, n: faults.null_schedule(n)
    combos = ([(k, "float", False) for k in KINDS]
              + [(k, "codec", False) for k in KINDS]
              + [("threesfc", "float", True), ("threesfc", "codec", True)])
    for kind, wire, fused in combos:
        sa, ma = _fault_pair(fw, sh, mesh, kind, wire, fused)
        sb, mb = _fault_pair(fw, sh, mesh, kind, wire, fused, null)
        tag = f"null {kind}/{wire}{'/fused' if fused else ''}"
        assert_tree_bits((sa.params, sa.ef), (sb.params, sb.ef), tag)
        for a, b in zip(ma, mb):
            assert_metrics_bits(a._replace(arrivals=0.0),
                                b._replace(arrivals=0.0), tag)
            assert float(b.arrivals) == float(FAULT_N)


def _ef_roundtrip(world, sh, mesh):
    """The mirror of the reference's EF placement through donation: the
    engine's state keeps this rank's EF rows, in the storage it was handed,
    across blocks; the caller's params and the params handed in are never
    written, and the gathered EF is the single-process one."""
    from repro_torch.fl.round import FLState
    e, s0, _ = engine(world, "fedavg", sh, mesh)
    local = len(sh.local_clients(N))
    params = world[1]
    before = snapshot((params, s0.params))
    storages = [t.untyped_storage().data_ptr() for t in leaves(s0.ef)]
    s2, _ = e.run_block(s0, 2)
    assert all(v.shape[0] == local for v in leaves(s2.ef))
    s4, ms = e.run_block(s2, 2)
    assert np.isfinite(ms.loss).all() and s4.round == 4
    assert [t.untyped_storage().data_ptr() for t in leaves(s4.ef)] \
        == storages, "the EF left the donated rows"
    assert_tree_bits(before, leaves((params, s0.params)),
                     "the engine wrote params it was handed")
    e1, t0, _ = engine(world, "fedavg")
    t4, _ = e1.run_block(t0, 4)
    full = sh.gather_state(s4)
    assert isinstance(full, FLState)
    assert_tree_bits((t4.params, t4.ef), (full.params, full.ef), "ef round trip")


def _width_matched(world_size):
    """The reference's width-matched (1, P) mesh: one client shard, so
    every rank runs all clients and the gather is over one rank."""
    from repro_torch.fl.sharding import make_fl_shardings
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model=world_size, device="cpu")
    sh = make_fl_shardings(mesh)
    assert sh.client_shards == 1 and sh.local_clients(N) == range(N)
    w = vision_world()
    for kind, kw in (("threesfc", {}), ("signsgd", {"wire": "codec"}),
                     ("threesfc", {"fused_decode": True})):
        sharded_vs_single(w, sh, mesh, kind, **kw)


def _lm_smoke(rank, out):
    """``train_lm_smoke`` under ``--client-parallel shard_map`` against the
    same run's single-process loop, bitwise; only rank 0 writes logs."""
    from repro_torch.fl import sharding
    from repro_torch.launch import train
    argv = ["--arch", "mamba2-370m", "--smoke", "--rounds", "2", "--clients",
            "2", "--local-steps", "1", "--batch", "2", "--eval-every", "1",
            "--device", "cpu"]
    d_sh = os.path.join(out, f"lm_shard_r{rank}")
    c0 = sharding.COLLECTIVES
    sharded = train.main(argv + ["--client-parallel", "shard_map", "--out",
                                 d_sh])
    # two rounds and gather_state at the end
    assert sharding.COLLECTIVES - c0 == 3, sharding.COLLECTIVES - c0
    assert dist.is_initialized()          # the caller's group stays up
    single = train.main(argv + ["--client-parallel", "vmap", "--out",
                                os.path.join(out, f"lm_single_r{rank}")])
    assert_tree_bits((single.params, single.ef),
                     (sharded.params, sharded.ef), "lm smoke")
    wrote = os.path.exists(os.path.join(d_sh, "metrics.jsonl"))
    assert wrote == (rank == 0), (rank, wrote)
    if rank == 0:
        cfg = json.load(open(os.path.join(d_sh, "run_config.json")))
        assert cfg["client_parallel"] == "shard_map" and "mesh" not in cfg
        assert cfg["world_size"] == 2
        rows = [json.loads(l) for l in open(os.path.join(d_sh,
                                                         "metrics.jsonl"))]
        assert [r["round"] for r in rows] == [1, 2]


def scenario_rounds(r: Rank):
    from repro_torch.fl.sharding import make_fl_shardings
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    sh = make_fl_shardings(mesh)
    world = vision_world()
    r.check("bitexact", _bitexact, world, sh, mesh)
    r.check("wire", _wire, world, sh, mesh)
    r.check("gathered_bytes", _gathered_bytes, world, sh, mesh)
    r.check("faults", _faults, sh, mesh)
    r.check("null_schedule", _null_schedule, sh, mesh)
    r.check("ef_roundtrip", _ef_roundtrip, world, sh, mesh)
    if r.world == 2:
        r.check("width_matched", _width_matched, r.world)
        r.check("lm_smoke", _lm_smoke, r.rank, r.out)


# ---------------------------------------------------------------------------
# scenario "reference": sharded 3SFC+EF rounds from given inputs, for the
# parent's JAX reference
# ---------------------------------------------------------------------------


def _reference_rounds(rank, out, fused: bool):
    from repro_torch.configs.base import CompressorConfig, FLConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.core.strategy import make_strategy
    from repro_torch.core.threesfc import SynData
    from repro_torch.fl.round import build_fl_round, fl_init
    from repro_torch.fl.sharding import make_fl_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.build import vision_syn_spec
    from repro_torch.models.cnn import MNIST_SPEC, make_mlp
    z = np.load(os.path.join(out, "reference_inputs.npz"))
    n, k, lr, steps = (int(z["n"]), int(z["k"]), float(z["lr"]),
                       int(z["syn_steps"]))
    params = {}
    for name in z.files:
        if name.startswith("p/"):
            layer, leaf = name[2:].split("/")
            params.setdefault(layer, {})[leaf] = torch.from_numpy(z[name])
    batches = {"x": torch.from_numpy(z["x"]),
               "y": torch.from_numpy(z["y"]).long()}
    mesh = make_host_mesh(device="cpu")
    sh = make_fl_shardings(mesh)
    model = make_mlp(MNIST_SPEC)
    comp = CompressorConfig(kind="threesfc", syn_steps=steps, syn_lr=0.1)
    strat = make_strategy(comp, loss_fn=model.syn_loss,
                          syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                          local_lr=lr)
    rf = build_fl_round(model.loss, strat, RunConfig(
        fl=FLConfig(num_clients=n, local_steps=k, local_lr=lr,
                    compressor=comp), fused_decode=fused,
        client_parallel="shard_map", mesh=mesh))
    state = sh.place_state(fl_init(params, n, strat))
    local = sh.place_client_tree(batches)
    res = {}
    for r in range(int(z["rounds"])):
        syn0 = SynData(*[torch.from_numpy(z[f"syn{r}_{i}"])
                         for i in range(3)])
        state, m = rf(state, local, 0, syn0=syn0)
        res[f"loss{r}"] = m.loss.numpy()
        res[f"cos{r}"] = m.cosine.numpy()
        res[f"norm{r}"] = m.update_norm.numpy()
    full = sh.gather_state(state)
    for layer, leaves in full.params.items():
        for leaf, v in leaves.items():
            res[f"p/{layer}/{leaf}"] = v.numpy()
    for layer, leaves in full.ef.items():
        for leaf, v in leaves.items():
            res[f"e/{layer}/{leaf}"] = v.numpy()
    if rank == 0:
        np.savez(os.path.join(out, f"reference_port_{'fused' if fused else 'float'}.npz"),
                 **res)


def scenario_reference(r: Rank):
    r.check("float", _reference_rounds, r.rank, r.out, False)
    r.check("fused", _reference_rounds, r.rank, r.out, True)


# ---------------------------------------------------------------------------
# scenario "engine" and "toy": the engine's and the strategy API's mirrors
# ---------------------------------------------------------------------------


def _engine_under_mesh():
    """The mirror of the reference's donation-under-a-mesh check: with
    shardings, every kind's donating engine writes each round's EF into
    this rank's own EF rows (the state handed in is consumed, its params
    and the caller's stay as they were), and its rounds are bitwise the
    undonated engine's."""
    from repro_torch.fl.sharding import make_fl_shardings
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    sh = make_fl_shardings(mesh)
    world = vision_world()
    local = len(sh.local_clients(N))
    for kind in ALL_KINDS:
        e, state, _ = engine(world, kind, sh, mesh)
        before = snapshot((world[1], state.params))
        storages = [t.untyped_storage().data_ptr()
                    for t in leaves(state.ef)]
        s2, ms = e.run_block(state, 2)
        assert np.isfinite(ms.loss).all() and s2.round == 2, kind
        assert all(v.shape[0] == local for v in leaves(s2.ef)), kind
        assert [t.untyped_storage().data_ptr()
                for t in leaves(s2.ef)] == storages, \
            f"{kind}: the EF left the donated rows"
        assert_tree_bits(before, leaves((world[1], state.params)),
                         f"{kind}: the engine wrote params it was handed")
        e1, t0, _ = engine(world, kind, sh, mesh, donate=False)
        t2, mt = e1.run_block(t0, 2)
        assert_tree_bits((s2.params, s2.ef), (t2.params, t2.ef),
                         f"{kind}: donated vs undonated")
        assert_metrics_bits(ms, mt, f"{kind}: donated vs undonated")


def scenario_engine(r: Rank):
    r.check("donation_safe_under_mesh", _engine_under_mesh)


def _toy_shard_codec():
    """The toy method over the sharded fan-out in wire mode: bitwise the
    single-process float round (its codec is lossless)."""
    from _torch_toy import TOY_KIND, register_toy
    from repro_torch.configs.base import CompressorConfig, FLConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.core import strategy as S
    from repro_torch.fl.round import build_fl_round, fl_init
    from repro_torch.fl.sharding import make_fl_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.cnn import VisionSpec, make_paper_model
    register_toy()
    n = 8
    model = make_paper_model("mlp", VisionSpec("tiny", (4, 4, 1), 3))
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batches = {"x": torch.from_numpy(
        rng.standard_normal((n, 2, 8, 4, 4, 1)).astype(np.float32)),
        "y": torch.from_numpy(rng.integers(0, 3, (n, 2, 8)))}
    fl = FLConfig(num_clients=n, local_steps=2, local_lr=0.05, local_batch=8,
                  compressor=CompressorConfig(kind=TOY_KIND))
    strat = S.make_strategy(fl.compressor)
    codec = strat.wire_codec(params)
    state = fl_init(params, n, strat)
    s_f, m_f = build_fl_round(model.loss, strat, RunConfig(fl=fl))(
        state, batches, 3)
    mesh = make_host_mesh(device="cpu")
    sh = make_fl_shardings(mesh)
    run_w = RunConfig(fl=fl, wire="codec", client_parallel="shard_map",
                      mesh=mesh)
    s_w, m_w = build_fl_round(model.loss, strat, run_w, codec=codec)(
        sh.place_state(state), sh.place_client_tree(batches), 3)
    full = sh.gather_state(s_w)
    assert_tree_bits((s_f.params, s_f.ef), (full.params, full.ef), "toy")
    for f in ("loss", "cosine", "payload_floats", "update_norm"):
        assert bits_equal(getattr(m_f, f), getattr(m_w, f)), f
    assert float(m_w.wire_bytes_up) == codec.nbytes


def scenario_toy(r: Rank):
    r.check("toy_strategy_shard_map_codec", _toy_shard_codec)


def scenario_tp(r: Rank):
    """Tensor parallelism on a (world / 2, 2) mesh (tests/_torch_tp.py)."""
    import _torch_tp
    _torch_tp.scenario(r)


SCENARIOS = {
    "sharding": scenario_sharding,
    "rounds": scenario_rounds,
    "reference": scenario_reference,
    "engine": scenario_engine,
    "toy": scenario_toy,
    "tp": scenario_tp,
}


def main(argv) -> int:
    scenario, rank, world, store, out = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        SCENARIOS[scenario](Rank(scenario, rank, world, out))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)                  # peers' collectives fail, not hang
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
