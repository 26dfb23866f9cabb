"""3SFC beyond the paper, on the PyTorch port: compress an LLM federated
update.

    PYTHONPATH=src python examples/compress_llm_update_torch.py \
        [--arch tinyllama-1.1b] [--device cpu]

The counterpart of ``examples/compress_llm_update.py`` on ``repro_torch``:
the registered 3SFC strategy runs on a reduced (smoke) LM architecture of
``ARCH_IDS``, its synthetic payload soft input EMBEDDINGS + LOW-RANK soft
labels over the vocabulary. Works for every family: dense, MoE (EF
carries the experts a payload does not reach), SSM, hybrid, the VLM
(prefix embeddings) and the encoder-decoder (frames). Runs on the CUDA
device unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import (ARCH_IDS, CompressorConfig,
                                     get_smoke_config)
from repro_torch.core import flat
from repro_torch.core.strategy import make_strategy
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.fl.client import local_train
from repro_torch.launch.train import resolve_device
from repro_torch.models.build import build_model, syn_loss_fn, syn_spec_for
from repro_torch.models.encdec import EncDec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
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
    batch = {"tokens": torch.as_tensor(np.asarray(data[:8]), device=device)}
    gen = torch.Generator(device=device).manual_seed(0)
    extra = torch.randn((8, cfg.num_mm_tokens, cfg.d_model), generator=gen,
                        device=device)
    if isinstance(model, EncDec):
        batch["frames"] = extra
    elif cfg.num_mm_tokens:
        batch["prefix_embeds"] = extra

    # accumulate a local update: the same batch for every local step
    target, _ = local_train(
        model.loss, w,
        {k: v.unsqueeze(0).expand(args.local_iters, *v.shape)
         for k, v in batch.items()}, 0.01)

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
