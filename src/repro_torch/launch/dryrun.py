"""Dry run: trace every (arch x input-shape) pair's entry on fake tensors and
harvest its memory, cost and collective analyses — nothing is allocated.

The JAX package lowers and compiles each entry ahead of time on the
production mesh and reads the compiled program's memory and cost analyses.
The port compiles nothing: it runs the entry once under
``torch._subclasses.fake_tensor.FakeTensorMode``, with fake arguments on
``--device`` (``cuda`` by default: the card's path, each hand-written
kernel through its meta branch; ``--device cpu`` records the plain
versions), and reads the op trace (``repro_torch.utils.hlo_analyzer``):
product FLOPs, operand plus result bytes, collectives, and the live bytes'
peak as the caching allocator would count them. Fake tensors hold no
memory, so a configuration far larger than the card is dry-run on any
host. A mesh of n > 1 ranks runs as rank 0 of a fake process group of n
in this one process.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh 4,1 [--variant '{"fused_decode": true}']
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1,1 \\
        --device cpu

Per pair the run writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>
[__<tag>].json`` with ``memory_per_dev``, the roofline terms and the 20
ops with the most bytes. Failures raise, as in the reference; nothing is
skipped. A host read of a tensor's value inside an entry raises under the
fake mode: in the port's own code that is a fault to repair, not a pair to
skip. On a mesh whose ``model`` axis is larger than 1 (the production
meshes, ``--mesh d,m`` with m > 1, ``--multi-pod``'s (2, 16, 16)) the
entry runs tensor parallel, as rank 0 of the fake process group: its
parameters, EF and caches are ``DTensor`` shards (``launch/specs.py``),
the per-device figures are rank 0's local shards and ops, and the
collectives are DTensor's functional ones, counted by the analyzer.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import specs as specs_lib
from repro_torch.utils import hlo_analyzer
from repro_torch.utils import roofline as rl

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# the reference's production meshes: (data, model) = (16, 16), and two
# such pods, (pod, data, model) = (2, 16, 16)
PRODUCTION_MESH = (16, 16)
MULTI_POD_MESH = (2, 16, 16)
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def tokens_for(arch: str, shape_name: str) -> float:
    s = INPUT_SHAPES[shape_name]
    if s.mode == "train":
        return float(s.global_batch * s.seq_len)
    if s.mode == "prefill":
        return float(s.global_batch * s.seq_len)
    return float(s.global_batch)      # decode: one token per sequence


@contextlib.contextmanager
def fake_mesh(mesh_shape: Tuple[int, ...], device="cpu") -> Iterator:
    """A ``("data", "model")`` DeviceMesh of ``mesh_shape`` (``("pod",
    "data", "model")`` for three axes) over a fake process group, this
    process as rank 0: collectives on it move nothing. It makes the
    default process group and destroys it on exit, so none may exist
    before."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run makes its own fake process group; "
                           "destroy the default process group first")
    n = 1
    for d in mesh_shape:
        n *= d
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh(torch.device(device).type, tuple(mesh_shape),
                               mesh_dim_names=MESH_AXES[len(mesh_shape)])
    finally:
        dist.destroy_process_group()


def parameter_shards(arg) -> Tuple[int, int]:
    """(elements, bytes) of the parameters an entry's first argument holds
    on this device: a serving entry's params, or a round's
    ``state.params``; each ``DTensor`` leaf by its local shard."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import shard
    params = arg.params if hasattr(arg, "params") else arg
    with torch.no_grad():
        local = [shard.local(t) for t in tree_leaves(params)]
    return (sum(t.numel() for t in local),
            sum(t.numel() * t.element_size() for t in local))


def _check_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "a dry run on cuda traces the card's path and needs a CUDA build "
            "of torch (fake CUDA tensors take autograd's device guard); "
            "this one is CPU-only: pass --device cpu")


def run_pair(arch: str, shape_name: str, multi_pod: bool = False,
             save: bool = True, verbose: bool = True,
             variant: Optional[dict] = None, tag: str = "",
             mesh_shape: Optional[tuple] = None,
             device="cuda") -> Optional[dict]:
    """Dry-runs one pair and returns its result (None for a documented
    skip)."""
    device = torch.device(device)
    _check_device(device)
    mesh_shape = tuple(mesh_shape or (MULTI_POD_MESH if multi_pod
                                      else PRODUCTION_MESH))
    mesh_name = "x".join(map(str, mesh_shape))
    chips = 1
    for d in mesh_shape:
        chips *= d
    with fake_mesh(mesh_shape, device) as mesh:
        made = specs_lib.make_entry(arch, shape_name, mesh, variant=variant)
        if made is None:
            if verbose:
                print(f"SKIP {arch} x {shape_name} (documented skip)")
            return None
        entry, args = made
        t0 = time.perf_counter()
        with FakeTensorMode():
            fake_args = specs_lib.materialize(args, device)
            param_count, param_bytes = parameter_shards(fake_args[0])
            trace = hlo_analyzer.record(entry, *fake_args)
        trace_s = time.perf_counter() - t0
    shape = INPUT_SHAPES[shape_name]
    mode = "train" if shape.mode == "train" else "serve"
    cfg = specs_lib.serving_config(get_config(arch), shape)
    mf = rl.model_flops_estimate(cfg, tokens_for(arch, shape_name), mode)
    roof = rl.from_trace(trace, chips, mf)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "variant": variant or {},
        "tag": tag,
        "chips": chips,
        "device": device.type,
        "trace_s": round(trace_s, 1),
        "ops_dispatched": trace.dispatched,
        # one process's live bytes: per device (see launch/specs.py)
        "memory_per_dev": dict(trace.memory),
        # the parameters this device holds: its shards under tensor
        # parallelism (unrounded, unlike the live bytes' blocks)
        "parameter_count": param_count,
        "parameter_bytes": param_bytes,
        "roofline": roof.as_dict(),
        "top_ops_by_bytes": hlo_analyzer.top_ops(trace, 20),
    }
    if verbose:
        args_gib = result["memory_per_dev"]["argument_bytes"] / 2**30
        peak_gib = result["memory_per_dev"]["peak_bytes"] / 2**30
        print(f"OK   {arch} x {shape_name} [{mesh_name}, {device.type}]  "
              f"trace {trace_s:.0f}s ({trace.dispatched} ops)  "
              f"params/dev {param_count:,} ({param_bytes:,} B)  "
              f"args/dev {args_gib:.2f} GiB peak/dev {peak_gib:.2f} GiB  "
              f"dominant={roof.dominant}  "
              f"C/M/X = {roof.compute_s:.3e}/{roof.memory_s:.3e}/"
              f"{roof.collective_s:.3e} s  useful {roof.useful_ratio:.3f}",
              flush=True)
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = f"{arch}__{shape_name}__{mesh_name}{suffix}"
        with open(os.path.join(OUT_DIR, fn + ".json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", type=str, default="",
                    help='JSON knobs, e.g. \'{"fused_decode": true}\'')
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--mesh", type=str, default="",
                    help="mesh shape (data,model) or (pod,data,model), e.g. "
                         "4,1; the default is the production 16,16 "
                         "(2,16,16 with --multi-pod)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card's path) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    variant = json.loads(args.variant) if args.variant else None
    mesh_shape = (tuple(int(x) for x in args.mesh.split(",")) if args.mesh
                  else MULTI_POD_MESH if args.multi_pod else PRODUCTION_MESH)

    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        pairs = [(args.arch, args.shape)]

    failures = []
    mesh_name = "x".join(map(str, mesh_shape))
    suffix = f"__{args.tag}" if args.tag else ""
    for arch, shape in pairs:
        out = os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh_name}{suffix}"
                           ".json")
        if args.skip_existing and os.path.exists(out):
            print(f"CACHED {arch} x {shape}")
            continue
        try:
            run_pair(arch, shape, multi_pod=args.multi_pod, variant=variant,
                     tag=args.tag, mesh_shape=mesh_shape, device=args.device)
        except Exception as e:                     # noqa: BLE001
            traceback.print_exc()
            failures.append((arch, shape, str(e)[:200]))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall pairs traced")


if __name__ == "__main__":
    main()
