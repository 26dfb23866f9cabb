"""Profile one main-path round and one signSGD codec round of the PyTorch
port on one CUDA card, and time kernels B1, B2, B3a, B3b, B5 and B6 on
their shapes.

    python3 scripts/torch_round_profile.py [--root DIR] [--label NAME]
                                           [--no-pdl]

The round is the one ``chip_smoke.py`` drives: 3SFC with EF on the paper
MLP (d = 199,210), N=10 clients, K=5 local steps, B=32, S=10 encoder steps,
float mode, from params and batches made from a fixed seed; the signSGD
round is the same clients in codec mode (``--wire codec``). It prints one
JSON line with

- B1 (``fused_cosine``) and B2 (``ef_update``) on one (d,) vector pair, and
  the front end's tree calls (``ops.tree_fused_stats``,
  ``ops.tree_ef_update``) on the MLP's 6 leaves; B3a (``pack_signs``) and
  B3b (``unpack_signs``) flat at d and at 4 Mi + 5, the calls at 4 Mi + 5
  rotating over six vectors (so each reads device memory): device time
  per call, 200 calls in a CUDA graph, median of 21 replays;
- B5 (``sign_quant``) and B6 (``topk_mask``, at the sampled threshold of
  k = 1%) the same way at d and at 4 Mi + 5, and each also eagerly (the
  median over 200 calls of the time one call holds the stream, the host's
  launch overhead included) and as device kernels per call, counted
  under ``torch.profiler``;
- for each round, after two warm rounds, its wall time (median of 3) and,
  from ``torch.profiler`` over one more round, its device kernel time,
  its device kernels and copies, and the kernels of B1, B2 and B3 among
  them.

Only entry points that the port has had since B3, B5 and B6 were first
ported (``pack_signs``, ``unpack_signs``, ``sign_quant``, ``topk_mask``,
``ops.topk_threshold``, ``build_fl_round`` with the signSGD codec) are
called, so that an older checkout runs too.

Both measurements are ``repro_torch.profiling``'s, as ``chip_smoke.py``
takes them; the helper is loaded from this checkout whatever ``--root``
names.

``--root`` names the checkout whose ``src/repro_torch`` is measured (this
one by default), so that two versions can be compared in turns within one
call on one card, one process each::

    for r in parent . . parent; do
        python3 scripts/torch_round_profile.py --root $r --label $r
    done

``--no-pdl`` builds that checkout's B1 and B2 sources, and its B5 and B6
sources where they launch with it, with the launch attribute for
programmatic dependent launch taken out (the one line ``cfg.numAttrs =
1;`` of each source's launch, or of the ``csrc/*.cuh`` header that holds
it for them, made ``0``; the ``griddepcontrol.wait`` in the kernels then
returns at once), into ``build/kernels_no_pdl/``, and measures with those:
the trial that chose to launch with it.

It needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, os.pardir))
N, K, B, S = 10, 5, 32, 10
MLP_D = 199_210
# B3, B5 and B6 at 4 Mi + 5: the calls rotate over 6 vectors, twice the
# 50 MB L2
BIG_N, ROTATE = (1 << 22) + 5, 6
# each kernel family by the names of its kernels now and before: the
# leaf-table B1/B2 and the two-pass B1 and one-vector B2 before them; the
# table and frames B3 and the one-vector B3 before them (matched as
# substrings of the profiler's names, so "::" keeps pack_signs_kernel from
# matching unpack_signs_kernel)
KERNELS = {"fused_cosine": ("fused_cosine_table", "fused_cosine_partials",
                            "fused_cosine_finish"),
           "ef_update": ("ef_update_table", "ef_update_kernel"),
           "pack_signs": ("pack_signs_table", "::pack_signs_kernel"),
           "unpack_signs": ("unpack_signs_frames", "::unpack_signs_kernel")}
PDL_LINE = "cfg.numAttrs = 1;"


def load_profiling():
    """``repro_torch/profiling.py`` of this checkout, under a name of its
    own (it imports only torch)."""
    path = os.path.join(REPO, "src", "repro_torch", "profiling.py")
    spec = importlib.util.spec_from_file_location("_round_profiling", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def use_no_pdl_builds(_build) -> list:
    """Build B1's and B2's sources, and B5's and B6's where they launch
    with PDL, without the PDL launch attribute and make ``_build.load``
    return those libraries. Returns the names rebuilt."""
    out = os.path.join(REPO, "build", "kernels_no_pdl")
    os.makedirs(out, exist_ok=True)
    # the sources include their shared headers from beside them
    headers = {h.name: h.read_text() for h in _build.CSRC.glob("*.cuh")}
    for h, text in headers.items():
        with open(os.path.join(out, h), "w") as f:
            f.write(text.replace(PDL_LINE, "cfg.numAttrs = 0;"))
    procs = {}
    for name in ("fused_cosine", "ef_update", "sign_quant", "topk_mask"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        found = src.count(PDL_LINE) + sum(
            text.count(PDL_LINE) for h, text in headers.items()
            if f'#include "{h}"' in src)
        if found == 0 and name in ("sign_quant", "topk_mask"):
            continue             # an older B5 or B6: no PDL to take out
        if found != 1:
            raise RuntimeError(f"{name}.cu and its headers have {found} "
                               f"lines {PDL_LINE!r}, not one: no PDL to "
                               f"take out")
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(PDL_LINE, "cfg.numAttrs = 0;"))
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu without PDL:\n{log}")
        _build._LIBS[name] = ctypes.CDLL(lib)
    return sorted(procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default=None)
    ap.add_argument("--no-pdl", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))

    import torch

    from repro_torch.configs.base import CompressorConfig, FLConfig
    from repro_torch.configs.run import RunConfig
    from repro_torch.core import flat
    from repro_torch.core.strategy import make_strategy
    from repro_torch.core.threesfc import SynData, init_syn
    from repro_torch.fl.round import build_fl_round, fl_init
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import bitpack as bp_mod
    from repro_torch.kernels import ef_update as ef_mod
    from repro_torch.kernels import fused_cosine as fc_mod
    from repro_torch.kernels import sign_quant as sq_mod
    from repro_torch.kernels import topk_mask as tm_mod
    from repro_torch.models.build import vision_syn_spec
    from repro_torch.models.cnn import MNIST_SPEC, make_mlp

    if not torch.cuda.is_available():
        raise RuntimeError("torch_round_profile.py needs a CUDA device")
    prof = load_profiling()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    no_pdl = use_no_pdl_builds(_build) if args.no_pdl else []
    _build.build_all(("fused_cosine", "ef_update", "bitpack", "sign_quant",
                      "topk_mask"))

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    model = make_mlp(MNIST_SPEC)
    x = torch.randn(MLP_D, generator=g, device=dev)
    y = torch.randn(MLP_D, generator=g, device=dev)
    s = torch.tensor([0.37], device=dev)
    a, b = model.init(g), model.init(g)
    if sum(t.numel() for t in flat.tree_leaves(a)) != MLP_D:
        raise AssertionError("not the paper MLP")
    words = bp_mod.pack_signs(x)
    xs = [torch.randn(BIG_N, generator=g, device=dev) for _ in range(ROTATE)]
    ws = [bp_mod.pack_signs(v) for v in xs]
    nx, nw = itertools.cycle(xs).__next__, itertools.cycle(ws).__next__
    kernel_ms = {
        "fused_cosine": prof.graph_ms(lambda: fc_mod.fused_cosine(x, y)),
        "ef_update": prof.graph_ms(lambda: ef_mod.ef_update(x, y, s)),
        "tree_fused_stats": prof.graph_ms(lambda: ops.tree_fused_stats(a, b)),
        "tree_ef_update": prof.graph_ms(lambda: ops.tree_ef_update(a, b, s)),
        "pack_signs": prof.graph_ms(lambda: bp_mod.pack_signs(x)),
        "unpack_signs": prof.graph_ms(
            lambda: bp_mod.unpack_signs(words, MLP_D)),
        "pack_signs_4Mi5": prof.graph_ms(lambda: bp_mod.pack_signs(nx())),
        "unpack_signs_4Mi5": prof.graph_ms(
            lambda: bp_mod.unpack_signs(nw(), BIG_N))}
    tau = ops.topk_threshold(x, MLP_D // 100)
    pairs = itertools.cycle(
        [(v, ops.topk_threshold(v, BIG_N // 100)) for v in xs]).__next__
    b56 = {"sign_quant": (lambda: sq_mod.sign_quant(x),
                          lambda: sq_mod.sign_quant(nx())),
           "topk_mask": (lambda: tm_mod.topk_mask(x, tau),
                         lambda: tm_mod.topk_mask(*pairs()))}
    kernels_per_call = {}
    for name, (at_d, at_big) in b56.items():
        kernel_ms[name] = prof.graph_ms(at_d)
        kernel_ms[f"{name}_4Mi5"] = prof.graph_ms(at_big)
        kernel_ms[f"{name}_call"] = prof.call_ms(at_d)
        kernel_ms[f"{name}_4Mi5_call"] = prof.call_ms(at_big)
        kernels_per_call[name] = prof.round_profile(at_d)["device_launches"]
    del xs, ws

    comp = CompressorConfig(kind="threesfc", syn_steps=S, syn_lr=0.1)
    strategy = make_strategy(comp, loss_fn=model.syn_loss,
                             syn_spec=vision_syn_spec(MNIST_SPEC, comp),
                             local_lr=0.01)
    one_round = build_fl_round(model.loss, strategy, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.01,
                    local_batch=B, compressor=comp)))
    state = fl_init(model.init(g), N, strategy)
    batches = {"x": torch.rand((N, K, B, 28, 28, 1), generator=g, device=dev),
               "y": torch.randint(0, 10, (N, K, B), generator=g, device=dev)}
    syns = [init_syn(g, strategy.syn_spec) for _ in range(N)]
    syn0 = SynData(*[torch.stack(ts) for ts in zip(*syns)])

    sign_comp = CompressorConfig(kind="signsgd")
    sign_strategy = make_strategy(sign_comp, local_lr=0.01)
    sign_round = build_fl_round(model.loss, sign_strategy, RunConfig(
        fl=FLConfig(num_clients=N, local_steps=K, local_lr=0.01,
                    local_batch=B, compressor=sign_comp), wire="codec"),
        codec=sign_strategy.wire_codec(state.params))
    sign_state = fl_init(state.params, N, sign_strategy)

    def profile(run):
        for _ in range(2):
            run()
        names = [k for keys in KERNELS.values() for k in keys]
        r = prof.round_profile(run, names)
        per_kernel = {}
        for family, keys in KERNELS.items():
            hits = [r["per_kernel_us"][k] for k in keys
                    if k in r["per_kernel_us"]]
            per_kernel[family] = {"launches": sum(c for _, c in hits),
                                  "device_us": sum(t for t, _ in hits)}
        return {"round_wall_ms": r["round_wall_ms"], "walls_ms": r["walls_ms"],
                "round_device_ms": r["round_device_ms"],
                "device_launches": r["device_launches"],
                "kernels": per_kernel}

    main_round = profile(lambda: one_round(state, batches, 0, syn0=syn0))
    print(json.dumps({
        "label": args.label or root, "device": torch.cuda.get_device_name(0),
        "pdl": f"off for {no_pdl}" if args.no_pdl else "as built",
        "kernel_ms": kernel_ms, "kernels_per_call": kernels_per_call,
        **main_round,
        "sign_round": profile(lambda: sign_round(sign_state, batches, 0))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
