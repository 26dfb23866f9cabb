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
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --smoke --rounds 3 --clients 2 --eval-every 1

It runs on the CUDA device unless ``--device cpu`` is given, and raises
when no CUDA device is available and the CPU was not asked for.

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
import time
from typing import Tuple

import torch

from repro_torch.configs.base import (ARCH_IDS, CompressorConfig,
                                     ModelConfig, get_smoke_config)
from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.strategy import CompressionStrategy, make_strategy
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (make_class_image_dataset,
                                        make_token_dataset)
from repro_torch.fl.budget import matched_compressors
from repro_torch.fl.engine import (RoundEngine, RunHistory, device_pools,
                                   token_batcher, vision_batcher)
from repro_torch.fl.round import FLState, build_fl_round, fold_in
from repro_torch.models.build import (build_model, syn_loss_fn, syn_spec_for,
                                      vision_syn_spec)
from repro_torch.models.cnn import DATASETS, accuracy, make_paper_model
from repro_torch.models.transformer import LM

# the reference's reduced LM run (launch/train.py train_lm_smoke)
SMOKE_SEQ_LEN, SMOKE_NUM_SEQS = 64, 2048


def resolve_device(name: str) -> torch.device:
    """The run's device. CUDA unless the caller asked for the CPU; raises
    when CUDA was asked for (the default) and none is available."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is false; pass "
            "--device cpu to run on the CPU")
    # the reference computes in full f32: keep TF32 off for matrix products
    # and for cuDNN, whatever the process defaults are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def train_vision(args) -> FLState:
    device = resolve_device(args.device)
    spec = DATASETS[args.dataset]
    model = make_paper_model(args.model, spec)
    params = model.init(_generator(device, fold_in(args.seed, 2)))
    d = flat.tree_size(params)
    comp = matched_compressors(args.model, spec, d)[args.compressor]
    syn_spec = vision_syn_spec(spec, comp)
    strategy = make_strategy(comp, loss_fn=model.syn_loss, syn_spec=syn_spec,
                             local_lr=args.lr)
    run = RunConfig.from_flags(args, compressor=comp)
    codec = strategy.wire_codec(params, policy=run.wire_policy) \
        if run.wire == "codec" else None

    cpu = torch.device("cpu")
    train = make_class_image_dataset(_generator(cpu, fold_in(args.seed, 0)),
                                     args.train_size, spec.input_shape,
                                     spec.num_classes)
    test = make_class_image_dataset(_generator(cpu, fold_in(args.seed, 1)),
                                    1000, spec.input_shape, spec.num_classes)
    parts = dirichlet_partition(train.y, args.clients, alpha=args.alpha,
                                seed=args.seed, min_per_client=args.batch)
    pools = device_pools(parts, device)
    engine = RoundEngine(
        build_fl_round(model.loss, strategy, run, codec=codec),
        vision_batcher(train.x, train.y, pools, args.local_steps, args.batch),
        seed=args.seed)
    state = engine.init_state(params, args.clients, strategy,
                              staleness_max=run.staleness_max)
    test_x = torch.as_tensor(test.x, device=device)
    test_y = torch.as_tensor(test.y, device=device)

    def eval_acc(p) -> float:
        with torch.no_grad():
            return float(accuracy(model.apply(p, test_x), test_y))

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "run_config.json"), "w") as f:
        json.dump({**run.to_json(), "device": str(device)}, f, indent=1)
    t0 = time.time()
    with open(os.path.join(args.out, "metrics.jsonl"), "w") as log:
        def on_eval(st, m, r):
            rec = {"round": r, "loss": float(m.loss[-1]),
                   "acc": eval_acc(st.params),
                   "cos": float(m.cosine[-1].mean()),
                   "payload_floats": float(m.payload_floats[-1]),
                   "elapsed_s": round(time.time() - t0, 1)}
            print(json.dumps(rec))
            log.write(json.dumps(rec) + "\n")
            log.flush()

        state, _ = engine.run(state, args.rounds, eval_every=args.eval_every,
                              eval_fn=on_eval)
    return state


def num_micro_for(per_client: int, seq_len: int) -> int:
    """The reference's microbatch rule (``launch/specs.py``
    ``make_train_entry``): from 4,096 tokens a sequence, ``min(per_client,
    8)`` slices of each local batch, lowered to a divisor of it; else 1."""
    num_micro = min(per_client, 8) if seq_len >= 4096 else 1
    while per_client % num_micro:
        num_micro -= 1
    return num_micro


def lm_setup(args, cfg: ModelConfig, comp: CompressorConfig,
             seq_len: int) -> Tuple[LM, CompressionStrategy, RunConfig]:
    """(model, strategy, run config) of an LM-family FL round: ``cfg``'s
    model, ``comp`` with the model's synthetic-data loss, the flags' FL
    settings and the microbatch rule for ``args.batch`` sequences of
    ``seq_len`` tokens."""
    model = build_model(cfg)
    strategy = make_strategy(comp, loss_fn=syn_loss_fn(model),
                             syn_spec=syn_spec_for(cfg, comp),
                             local_lr=args.lr)
    run = RunConfig.from_flags(args, compressor=comp).replace(
        num_micro=num_micro_for(args.batch, seq_len))
    return model, strategy, run


def train_lm(args, cfg: ModelConfig, comp: CompressorConfig, seq_len: int,
             num_seqs: int) -> Tuple[FLState, RunHistory]:
    """An LM-family FL run: ``cfg``'s model trained by ``args.clients``
    clients on ``num_seqs`` planted-bigram sequences of ``seq_len`` tokens
    (IID batches of ``args.batch`` sequences, ``args.local_steps`` local
    steps), the update compressed by ``comp``; one row per eval with the
    reference's keys ``round``, ``loss``, ``cos``, ``params``, printed and
    written to ``<out>/metrics.jsonl``."""
    device = resolve_device(args.device)
    model, strategy, run = lm_setup(args, cfg, comp, seq_len)
    params = model.init(_generator(device, fold_in(args.seed, 2)))
    d = flat.tree_size(params)
    codec = strategy.wire_codec(params, policy=run.wire_policy) \
        if run.wire == "codec" else None
    data = make_token_dataset(
        _generator(torch.device("cpu"), fold_in(args.seed, 0)), num_seqs,
        seq_len, cfg.vocab_size)
    extras = ({"prefix_embeds": (cfg.num_mm_tokens, cfg.d_model)}
              if cfg.num_mm_tokens else {})
    engine = RoundEngine(
        build_fl_round(model.loss, strategy, run, codec=codec),
        token_batcher(data, args.clients, args.local_steps, args.batch,
                      extras=extras, device=device),
        seed=args.seed)
    state = engine.init_state(params, args.clients, strategy,
                              staleness_max=run.staleness_max)
    del params                       # the state holds its own copy

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "run_config.json"), "w") as f:
        json.dump({**run.to_json(), "arch": cfg.name, "seq_len": seq_len,
                   "device": str(device)}, f, indent=1)
    with open(os.path.join(args.out, "metrics.jsonl"), "w") as log:
        def on_eval(st, m, r):
            rec = {"round": r, "loss": float(m.loss[-1]),
                   "cos": float(m.cosine[-1].mean()), "params": d}
            print(json.dumps(rec))
            log.write(json.dumps(rec) + "\n")
            log.flush()

        return engine.run(state, args.rounds, eval_every=args.eval_every,
                          eval_fn=on_eval)


def train_lm_smoke(args) -> Tuple[FLState, RunHistory]:
    """The reference's reduced LM-family run: the arch's smoke config, 3SFC
    (10 steps at lr 0.1 over 8 synthetic positions) or the named
    compressor, FedAvg as identity without EF, on 2,048 sequences of 64
    tokens."""
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the run raises when cuda is "
                         "asked for and no CUDA device is available")
    return ap.parse_args(argv)


def main(argv=None) -> FLState:
    args = parse_args(argv)
    if args.arch and args.smoke:
        return train_lm_smoke(args)[0]
    return train_vision(args)


if __name__ == "__main__":
    main()
