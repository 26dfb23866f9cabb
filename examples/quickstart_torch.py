"""Quickstart on the PyTorch port: compress one federated update with 3SFC
and decode it back.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: train
one client locally for K steps, encode the accumulated update into ONE
synthetic sample + one scalar (795+1 floats against 199,210 gradient
entries -> the paper's 250x ratio) through the registered
``CompressionStrategy``, serialize it into the method's wire frame, decode
it on the server with one backward pass, apply. Runs on the CUDA device
unless ``--device cpu`` is given.
"""
import argparse

import torch

from repro_torch.configs.base import CompressorConfig
from repro_torch.core import baselines, flat
from repro_torch.core.strategy import make_strategy
from repro_torch.data.synthetic import make_class_image_dataset
from repro_torch.fl.client import local_train
from repro_torch.launch.train import resolve_device
from repro_torch.models.build import vision_syn_spec
from repro_torch.models.cnn import MNIST_SPEC, accuracy, make_paper_model


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-size", type=int, default=512)
    ap.add_argument("--test-size", type=int, default=400)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--syn-steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cpu = torch.device("cpu")

    model = make_paper_model("mlp", MNIST_SPEC)   # 199,210 params (paper Fig. 1)
    w_global = model.init(_gen(device, 0))
    ds = make_class_image_dataset(_gen(cpu, 1), args.train_size,
                                  (28, 28, 1), 10)

    # --- client: K local SGD steps (g = w^t - w_i^t, Eq. 3) ---------------
    k, b = args.local_steps, args.batch
    batches = {"x": torch.as_tensor(ds.x[:k * b], device=device)
               .reshape(k, b, 28, 28, 1),
               "y": torch.as_tensor(ds.y[:k * b], device=device)
               .reshape(k, b).long()}
    g_accum, _ = local_train(model.loss, w_global, batches, 0.05)

    # --- client: 3SFC encode (Eq. 8/9) via the registered strategy ----------
    comp = CompressorConfig(kind="threesfc", syn_batch=1,
                            syn_steps=args.syn_steps, syn_lr=0.1)
    spec = vision_syn_spec(MNIST_SPEC, comp)
    strategy = make_strategy(comp, loss_fn=model.syn_loss, syn_spec=spec)
    enc = strategy.client_encode(_gen(device, 2), g_accum, w_global)
    d = flat.tree_size(w_global)
    payload = strategy.payload_floats(w_global)
    print(f"uplink payload: {payload:.0f} floats vs {d:,} gradient entries "
          f"-> {d / payload:.1f}x compression (paper: 250.6x)")
    print(f"compression efficiency (cosine, paper Fig. 7 metric): "
          f"{float(enc.cosine):+.3f}")

    # --- the wire: the strategy's codec serializes the (D_syn, s) payload ---
    codec = strategy.wire_codec(w_global)
    buf = codec.encode(enc.wire)
    print(f"serialized uplink frame: {codec.nbytes} bytes "
          f"({codec.nbytes - codec.header_bytes} payload + "
          f"{codec.header_bytes} header)")

    # --- server: decode the framed payload (Eq. 10) + update ----------------
    recon = strategy.server_decode(codec.decode(buf), w_global)
    err = flat.tree_norm(flat.tree_sub(recon, enc.recon))
    print(f"server decode == client recon: L2 diff {float(err):.2e} "
          f"(exactness)")
    fl = flat.Flattener(w_global)
    fcos, frel = baselines.reconstruction_stats(fl.flatten(g_accum),
                                                fl.flatten(recon))
    print(f"reconstruction fidelity vs true update: cos {float(fcos):+.3f}, "
          f"rel L2 err {float(frel):.3f}")
    w_next = flat.tree_sub(w_global, recon)

    te = make_class_image_dataset(_gen(cpu, 3), args.test_size, (28, 28, 1),
                                  10)
    te_x = torch.as_tensor(te.x, device=device)
    te_y = torch.as_tensor(te.y, device=device)
    with torch.no_grad():
        a0 = accuracy(model.apply(w_global, te_x), te_y)
        a1 = accuracy(model.apply(w_next, te_x), te_y)
    print(f"test acc before {float(a0):.3f} -> after 1 compressed round "
          f"{float(a1):.3f}")
    return float(err)


if __name__ == "__main__":
    main()
