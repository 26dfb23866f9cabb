"""3SFC beyond the paper, on the PyTorch port: compress an LLM federated
update.

    PYTHONPATH=src python examples/compress_llm_update_torch.py [--device cpu]

The counterpart of ``examples/compress_llm_update.py`` on ``repro_torch``:
the registered 3SFC strategy runs on the reduced (smoke) mamba2-370m, its
synthetic payload soft input EMBEDDINGS + LOW-RANK soft labels over the
vocabulary. The port carries mamba2 only so far; the other architectures
and the encoder-decoder branch come with their model families. Runs on the
CUDA device unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import CompressorConfig, get_smoke_config
from repro_torch.core import flat
from repro_torch.core.strategy import make_strategy
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.fl.client import local_train
from repro_torch.launch.train import resolve_device
from repro_torch.models.build import build_model, syn_loss_fn, syn_spec_for

ARCHS = ("mamba2-370m",)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--local-iters", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    model = build_model(cfg)
    w = model.init(torch.Generator(device=device).manual_seed(0))
    d = flat.tree_size(w)

    data = make_token_dataset(torch.Generator().manual_seed(1), 64, 32,
                              cfg.vocab_size)
    tokens = torch.as_tensor(np.asarray(data[:8]), device=device)

    # accumulate a local update: the same batch for every local step
    target, _ = local_train(
        model.loss, w,
        {"tokens": tokens.unsqueeze(0).expand(args.local_iters,
                                              *tokens.shape)}, 0.01)

    comp = CompressorConfig(kind="threesfc", syn_batch=1, syn_seq=8,
                            soft_label_rank=8, syn_steps=args.steps,
                            syn_lr=0.1)
    spec = syn_spec_for(cfg, comp)
    strategy = make_strategy(comp, loss_fn=syn_loss_fn(model), syn_spec=spec)
    enc = strategy.client_encode(
        torch.Generator(device=device).manual_seed(2), target, w)
    recon = strategy.server_decode(enc.wire, w)
    err = float(flat.tree_norm(flat.tree_sub(recon, enc.recon)))

    print(f"arch={args.arch}  params={d:,}")
    print(f"payload = {strategy.payload_floats(w):.0f} floats "
          f"(soft embeds {np.prod(spec.x_shape)}, low-rank labels rank "
          f"{comp.soft_label_rank}) -> "
          f"{d / strategy.payload_floats(w):.1f}x compression")
    print(f"encode cosine = {float(enc.cosine):+.4f}  "
          f"(decode exactness: {err:.2e})")
    return err


if __name__ == "__main__":
    main()
