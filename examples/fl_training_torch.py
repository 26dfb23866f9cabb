"""End-to-end FL training on the PyTorch port: 20 non-iid clients, 3SFC at
250x compression, a few hundred rounds of MLP training with live accuracy.

    PYTHONPATH=src python examples/fl_training_torch.py [--rounds 200] \
        [--wire codec] [--transport socket] [--device cpu]

The full stack — data synthesis, Dirichlet partition, the clients,
EF-compressed uplink (serialized uint8 frames with ``--wire codec``; N
worker processes over sockets with ``--transport socket``), server
aggregation, eval, checkpointing — driven through
``repro_torch.launch.train``'s ``RunConfig``-based CLI. It runs on the
CUDA device unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--compressor", default="threesfc")
    ap.add_argument("--wire", default="float", choices=["float", "codec"])
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "socket"])
    ap.add_argument("--train-size", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="experiments/example_fl_run_torch")
    args = ap.parse_args(argv)
    return train_main([
        "--model", "mlp", "--dataset", "mnist",
        "--compressor", args.compressor, "--wire", args.wire,
        "--transport", args.transport,
        "--rounds", str(args.rounds), "--clients", str(args.clients),
        "--train-size", str(args.train_size), "--batch", str(args.batch),
        "--eval-every", str(args.eval_every), "--device", args.device,
        "--out", args.out])


if __name__ == "__main__":
    main()
