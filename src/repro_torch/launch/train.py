"""Federated training driver — the port's end-to-end entry point.

Runs an in-process FL training job on the paper's vision setting through
``repro_torch.fl.engine.RoundEngine``: data and Dirichlet pools live on the
device, the round is built by ``repro_torch.fl.round.build_fl_round`` over
the compressor's registered strategy, and the flags fold into one
validated ``RunConfig`` (logged as ``run_config.json`` next to
``metrics.jsonl``). ``--wire codec`` runs the round on serialized uint8
frames (``repro_torch.comm``), one per client per round.

    PYTHONPATH=src python -m repro_torch.launch.train --model mlp \
        --dataset mnist --compressor threesfc --rounds 200 --clients 10
    PYTHONPATH=src python -m repro_torch.launch.train --compressor signsgd \
        --wire codec

It runs on the CUDA device unless ``--device cpu`` is given, and raises
when no CUDA device is available and the CPU was not asked for.

Seeds: the training set is drawn from ``fold_in(seed, 0)``, the test set
from ``fold_in(seed, 1)`` and the initial params from ``fold_in(seed, 2)``
(``repro_torch.fl.round.fold_in``); the engine derives batches and encoder
draws from ``seed`` as ``repro_torch.fl.engine`` documents.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs.run import RunConfig
from repro_torch.core import flat
from repro_torch.core.strategy import make_strategy
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_class_image_dataset
from repro_torch.fl.budget import matched_compressors
from repro_torch.fl.engine import RoundEngine, device_pools, vision_batcher
from repro_torch.fl.round import FLState, build_fl_round, fold_in
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import DATASETS, accuracy, make_paper_model


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
    state = engine.init_state(params, args.clients, strategy)
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


def main(argv=None) -> FLState:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp",
                    choices=["mlp", "mnistnet", "convnet", "resnet", "regnet"])
    ap.add_argument("--dataset", default="mnist", choices=sorted(DATASETS))
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the run raises when cuda is "
                         "asked for and no CUDA device is available")
    args = ap.parse_args(argv)
    return train_vision(args)


if __name__ == "__main__":
    main()
