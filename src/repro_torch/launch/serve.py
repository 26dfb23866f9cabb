"""Serving driver: batched prefill + greedy decode loop.

The port's counterpart of the JAX package's ``launch/serve.py``, for
every architecture of ``ARCH_IDS`` (``--arch``, tinyllama-1.1b by
default, as the reference):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --batch 4 --prompt-len 32 --gen 16 --device cpu
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --size full \
        --batch 4 --prompt-len 2048 --gen 16
    python -m repro_torch.launch.serve --arch mamba2-370m --size full \
        --batch 4 --prompt-len 2048 --gen 16 --ssd-kernel

It runs on the CUDA device unless ``--device cpu`` is given, and raises
when no CUDA device is available and the CPU was not asked for.
``--size smoke`` (the default, as in the reference) serves the reduced
config; ``--size full`` the published widths. An encoder-decoder model
(seamless-m4t-medium) encodes ``(batch, num_mm_tokens, d_model)`` stub
frames before the prompt. ``--ssd-kernel`` sets ``use_pallas_ssd``: every
SSM layer's prefill runs its intra-chunk step in kernel B4, and an
architecture without SSM layers, or a prompt length that route cannot
take, raises.
``--metrics-port`` serves ``/healthz`` and ``/metrics`` (the
``repro_torch.obs`` registry snapshot: prefill and decode-step times,
token counters) for the run, and after it until interrupted.

Seeds: params from ``fold_in(seed, 0)``, the prompt from
``fold_in(seed, 1)``, an enc-dec model's frames from ``fold_in(seed, 2)``
(``repro_torch.fl.round.fold_in``).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.fl.round import fold_in
from repro_torch.launch.train import resolve_device
from repro_torch.models.build import build_model
from repro_torch.models.encdec import EncDec
from repro_torch.obs import get_registry
from repro_torch.obs.http import ObsHTTPServer


class ServeResult(NamedTuple):
    logits: torch.Tensor        # (B, V) f32, the last decode step's
    tokens: torch.Tensor        # (B, gen) the greedy tokens
    prefill_s: float            # wall seconds of the prefill
    decode_s: float             # wall seconds of the gen - 1 decode steps
    model: Any                  # LM or EncDec
    params: Any
    prompt: torch.Tensor        # (B, prompt_len)
    frames: Optional[torch.Tensor] = None   # (B, T, d), enc-dec only


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_kernel_route(cfg, prompt_len: int) -> None:
    """Raises unless ``cfg`` has SSM layers and every one's prefill takes
    the kernel route at ``prompt_len`` (``models.ssm.ssm_forward``'s shape
    rule)."""
    if "ssm" not in cfg.block_pattern:
        raise ValueError(f"--ssd-kernel: {cfg.name} has no SSM layers")
    q = min(cfg.ssm_chunk, prompt_len)
    if prompt_len < 1 or prompt_len % q:
        raise ValueError(
            f"--ssd-kernel: prompt length {prompt_len} does not divide by "
            f"min(ssm_chunk={cfg.ssm_chunk}, {prompt_len}) = {q}, so the "
            f"prefill would run ssd_scan instead of kernel B4")


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32, dest="prompt_len")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"],
                    help="the reduced CPU-test config (default) or the "
                         "published widths")
    ap.add_argument("--ssd-kernel", action="store_true", dest="ssd_kernel",
                    help="run the SSD intra-chunk step in kernel B4 "
                         "(use_pallas_ssd)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the run raises when cuda is "
                         "asked for and no CUDA device is available")
    ap.add_argument("--metrics-port", type=int, default=None,
                    dest="metrics_port",
                    help="serve /healthz + /metrics (the obs meters "
                         "snapshot) on this port (0 picks a free port)")
    args = ap.parse_args(argv)
    if args.gen < 1:
        raise ValueError(f"--gen must be at least 1, got {args.gen}")
    http = None
    if args.metrics_port is not None:
        http = ObsHTTPServer(port=args.metrics_port)
        print(f"metrics -> {http.url}/metrics  health -> {http.url}/healthz",
              flush=True)
    try:
        result = _serve(args)
        if http is not None:
            _linger()
        return result
    finally:
        if http is not None:
            http.stop()


def _linger() -> None:
    """Keep the metrics endpoint up until ctrl-c."""
    print("serving metrics until interrupted (ctrl-c to exit)", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass


def _serve(args) -> ServeResult:
    meters = get_registry()
    meters.gauge("serve.batch").set(args.batch)
    meters.gauge("serve.prompt_len").set(args.prompt_len)
    device = resolve_device(args.device)
    cfg = (get_config if args.size == "full" else get_smoke_config)(args.arch)
    if args.ssd_kernel:
        cfg = cfg.replace(use_pallas_ssd=True)
        check_kernel_route(cfg, args.prompt_len)
    model = build_model(cfg)
    with torch.inference_mode():
        params = model.init(
            torch.Generator(device).manual_seed(fold_in(args.seed, 0)))
        tokens = torch.randint(
            0, cfg.vocab_size, (args.batch, args.prompt_len),
            generator=torch.Generator(device).manual_seed(
                fold_in(args.seed, 1)),
            device=device)
        frames = None
        if isinstance(model, EncDec):
            frames = torch.randn(
                (args.batch, cfg.num_mm_tokens, cfg.d_model),
                generator=torch.Generator(device).manual_seed(
                    fold_in(args.seed, 2)), device=device)
        cache_len = args.prompt_len + args.gen

        _sync(device)
        t0 = time.perf_counter()
        if frames is None:
            logits, cache, t = model.prefill(params, tokens, cache_len)
        else:
            logits, cache, t = model.prefill(params, frames, tokens,
                                             cache_len)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        meters.histogram("serve.prefill_s").observe(prefill_s)
        meters.counter("serve.prefills").inc()
        print(f"prefill: batch={args.batch} len={args.prompt_len} "
              f"({prefill_s:.3f}s)")

        tok = torch.argmax(logits, -1)
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            step_t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok, t + i)
            tok = torch.argmax(logits, -1)
            out.append(tok)
            # the host's time per step (the device may still run behind)
            meters.histogram("serve.decode_step_s").observe(
                time.perf_counter() - step_t0)
        _sync(device)
        decode_s = time.perf_counter() - t0
    gen = torch.stack(out, dim=1)
    n_tok = args.gen * args.batch
    meters.counter("serve.tokens").inc(n_tok)
    meters.gauge("serve.tokens_per_s").set(n_tok / max(decode_s, 1e-9))
    print(f"decoded {args.gen} tokens x {args.batch} seqs in {decode_s:.2f}s "
          f"({n_tok / max(decode_s, 1e-9):.1f} tok/s)")
    print("sample token ids:", gen[0, :12].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    print("serve OK")
    return ServeResult(logits, gen, prefill_s, decode_s, model, params,
                       tokens, frames)


if __name__ == "__main__":
    main()
