"""The round matrix at tiny shapes, recorded for the contracts.

``iter_round_configs()`` enumerates every *valid* point of
``strategy_kinds()`` × {vmap, shard_map} × {float, codec} × {fused,
default} × {faulted, null}, filtered the way ``build_fl_round`` filters
(codec only for kinds with a registered wire format, fused only for
``supports_fused_aggregate`` strategies, fused × faulted only with a real
``mask_payloads``): the reference's matrix over the port's registries.

``record_round`` runs one point at the reference's tiny shapes (4 clients,
1 local step, batch 4, a 4×4×1 3-class vision spec and the paper MLP;
keep_ratio 0.25, 2 synthetic steps at lr 0.1, EF on except for
``identity``) through a ``RoundEngine`` — donating unless told not to —
under a ``contracts.RoundRecorder``, and returns the
``contracts.RoundRecord``.

Mesh-free points run in the calling process (``run_matrix``). Sharded
points need ranks: ``run_sharded`` spawns ``SHARD_WORLD`` gloo ranks on
the CPU over a (4, 1) ``data`` × ``model`` mesh, joined through a
``FileStore`` (no TCP port), which record every sharded point in one
spawn. Rank 0's records come back to the caller; every other rank checks
its own and returns its violations, so a contract holds on each rank.
``run_all`` does both halves and returns one report
(``scripts/check_static_torch.py`` prints it).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import contracts

# tiny-but-real round shape: 4 clients over a (4, 1) data×model mesh,
# one local step, batch 4, 4x4x1 inputs, 3 classes
TINY_N, TINY_K, TINY_B = 4, 1, 4
TINY_MESH_SHAPE = (4, 1)
TINY_INPUT = (4, 4, 1)
TINY_CLASSES = 3
SHARD_WORLD = TINY_MESH_SHAPE[0]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def iter_round_configs() -> List[Dict[str, Any]]:
    """Every constructible (kind, fanout, wire, fused, faulted) point."""
    from repro_torch.comm.codec import CODECS
    from repro_torch.core.strategy import (STRATEGIES, CompressionStrategy,
                                           strategy_kinds)
    cfgs: List[Dict[str, Any]] = []
    for kind in strategy_kinds():
        cls = STRATEGIES[kind]
        wires = ["float"] + (["codec"] if kind in CODECS else [])
        fuseds = [False, True] if cls.supports_fused_aggregate else [False]
        masked = cls.mask_payloads is not CompressionStrategy.mask_payloads
        for fanout in ("vmap", "shard_map"):
            for wire in wires:
                for fused in fuseds:
                    for faulted in (False, True):
                        if fused and faulted and not masked:
                            continue
                        cfgs.append({"kind": kind, "fanout": fanout,
                                     "wire": wire, "fused": fused,
                                     "faulted": faulted})
    return cfgs


def build_context(device="cpu", mesh=None) -> Dict[str, Any]:
    """Shared round context: the tiny model and params on ``device``, the
    (N, K, B, ...) batch tree from a seed, and with ``mesh`` its shardings
    and this rank's rows of the batches."""
    from repro_torch.models.cnn import VisionSpec, make_paper_model

    device = torch.device(device)
    spec = VisionSpec("tiny", TINY_INPUT, TINY_CLASSES)
    model = make_paper_model("mlp", spec)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    batches = {
        "x": torch.from_numpy(rng.standard_normal(
            (TINY_N, TINY_K, TINY_B, *TINY_INPUT)).astype(np.float32)
        ).to(device),
        "y": torch.from_numpy(rng.integers(
            0, TINY_CLASSES, (TINY_N, TINY_K, TINY_B))).to(device),
    }
    sh, local = None, None
    if mesh is not None:
        from repro_torch.fl.sharding import make_fl_shardings
        sh = make_fl_shardings(mesh)
        local = sh.place_client_tree(batches)
    return {"spec": spec, "model": model, "params": params, "mesh": mesh,
            "sh": sh, "batches": batches, "local_batches": local,
            "device": device}


def record_round(config: Dict[str, Any], ctx: Dict[str, Any], *,
                 donate: bool = True) -> contracts.RoundRecord:
    """One matrix point through a ``RoundEngine`` (``donate``) for one
    round, recorded."""
    from repro_torch.comm.codec import make_codec
    from repro_torch.configs.base import CompressorConfig, FLConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.core.strategy import make_strategy
    from repro_torch.fl import faults
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.fl.round import build_fl_round
    from repro_torch.models.build import vision_syn_spec

    kind = config["kind"]
    shard = config["fanout"] == "shard_map"
    if shard and ctx["mesh"] is None:
        raise RuntimeError("a shard_map point needs a context built with a "
                           "mesh (run_sharded)")
    model, params = ctx["model"], ctx["params"]
    ccfg = CompressorConfig(kind=kind, keep_ratio=0.25, syn_steps=2,
                            syn_lr=0.1, error_feedback=(kind != "identity"))
    spec = vision_syn_spec(ctx["spec"], ccfg)
    strat = make_strategy(ccfg, loss_fn=model.syn_loss, syn_spec=spec,
                          local_lr=0.05)
    fl = FLConfig(num_clients=TINY_N, local_steps=TINY_K, local_lr=0.05,
                  local_batch=TINY_B, compressor=ccfg)
    run = RunConfig(fl=fl, wire=config["wire"],
                    fused_decode=config["fused"],
                    client_parallel=config["fanout"],
                    mesh=ctx["mesh"] if shard else None)
    codec = None
    if config["wire"] == "codec":
        codec = make_codec(ccfg, params, syn_spec=spec,
                           syn_loss_fn=model.syn_loss)
    sched = ((lambda r, n: faults.null_schedule(n)) if config["faulted"]
             else None)
    rf = build_fl_round(model.loss, strat, run, codec=codec,
                        fault_schedule_fn=sched)
    batches = ctx["local_batches"] if shard else ctx["batches"]
    sh = ctx["sh"] if shard else None
    engine = RoundEngine(rf, lambda data_seed, rnd: batches, seed=0,
                         donate=donate, shardings=sh)
    state = engine.init_state(params, TINY_N, strat)
    ef_in = contracts.ef_storages(state.ef)
    with contracts.RoundRecorder() as rec:
        state, metrics = engine.run_block(state, 1)
    if not np.isfinite(metrics.loss).all():
        raise RuntimeError(f"{config}: non-finite loss {metrics.loss}")
    shards = sh.client_shards if shard else 1
    payload = None
    if config["fused"]:
        payload = (4.0 * float(strat.payload_floats(params))
                   * (TINY_N // shards))
    return contracts.RoundRecord(
        config=dict(config),
        collectives=rec.collectives,
        rows=rec.rows,
        host_syncs=dict(rec.host_syncs),
        donate=donate,
        ef_in=ef_in,
        ef_out=contracts.ef_storages(state.ef),
        payload_bytes_local=payload,
        codec_nbytes=(codec.nbytes if codec is not None else None),
        codec_policy=(codec.policy if codec is not None else None),
        num_clients=TINY_N,
        client_shards=shards)


def run_matrix(configs: Optional[List[Dict[str, Any]]] = None,
               device="cpu", mesh=None) -> List[contracts.RoundRecord]:
    """Record ``configs`` (the mesh-free half of the matrix by default) in
    this process; sharded points need ``mesh``."""
    if configs is None:
        configs = [c for c in iter_round_configs() if c["fanout"] == "vmap"]
    ctx = build_context(device, mesh)
    return [record_round(c, ctx) for c in configs]


def run_sharded(configs: Optional[List[Dict[str, Any]]] = None, *,
                world: int = SHARD_WORLD, timeout: float = 600,
                ) -> Tuple[List[contracts.RoundRecord], Dict[int, Dict]]:
    """Record the sharded points (all of them by default) on ``world`` gloo
    ranks spawned on the CPU. Returns rank 0's records and, per other
    rank, its own ``run_contracts`` report."""
    from repro_torch.launch.ranks import Ranks

    if configs is None:
        configs = [c for c in iter_round_configs()
                   if c["fanout"] == "shard_map"]
    with tempfile.TemporaryDirectory(prefix="repro_torch_ir_") as out:
        with open(os.path.join(out, "configs.json"), "w") as f:
            json.dump(configs, f)
        store = os.path.join(out, "store")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(REPO, "src")]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        argvs = [[sys.executable, "-m", "repro_torch.analysis.ir", "--rank",
                  str(r), str(world), store, out] for r in range(world)]
        logs = [os.path.join(out, f"rank{r}.log") for r in range(world)]
        with Ranks(argvs, logs, env=env, cwd=REPO) as ranks:
            rcs = ranks.join(timeout)
            if any(rc != 0 for rc in rcs):
                tails = "\n".join(f"--- rank {r} (exit {rc}) ---\n"
                                  f"{ranks.log(r)[-4000:]}"
                                  for r, rc in enumerate(rcs) if rc != 0)
                raise RuntimeError(f"sharded contract ranks failed:\n{tails}")
        with open(os.path.join(out, "rank0.json")) as f:
            records = [contracts.RoundRecord.from_json(d)
                       for d in json.load(f)]
        peers = {}
        for r in range(1, world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                peers[r] = contracts.run_contracts(
                    [contracts.RoundRecord.from_json(d)
                     for d in json.load(f)])
    return records, peers


def merge_peers(report: Dict[str, Any], peers: Dict[int, Dict]) -> Dict:
    """Add every other rank's violations to ``report``, each tagged with
    its rank; evaluation counts stay rank 0's."""
    for r, rep in sorted(peers.items()):
        for name, c in rep["contracts"].items():
            extra = [f"rank {r}: {v}" for v in c["violations"]]
            report["contracts"][name]["violations"].extend(extra)
            report["violations"] += len(extra)
    return report


def run_all(timeout: float = 600) -> Dict[str, Any]:
    """The whole matrix: the mesh-free half here, the sharded half on
    ``SHARD_WORLD`` ranks; one ``run_contracts`` report."""
    local = run_matrix()
    sharded, peers = run_sharded(timeout=timeout)
    return merge_peers(contracts.run_contracts(local + sharded), peers)


def _rank_main(rank: int, world: int, store: str, out: str) -> int:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        with open(os.path.join(out, "configs.json")) as f:
            configs = json.load(f)
        mesh = make_host_mesh(device="cpu")
        records = run_matrix(configs, "cpu", mesh)
        path = os.path.join(out, f"rank{rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump([r.to_json() for r in records], f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    # one rank of run_sharded: --rank RANK WORLD STORE OUT
    sys.exit(_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                        sys.argv[5]))
