"""The readings a cell's limits are set from, on the card at the cell's
own size: for each seed the program's first rounds against the
reference's (the lower reading); for the control seeds the reference
computed with fp8 products against the reference (the upper reading);
for the control seeds also the reference with each planted fault, and
for the f32 seeds the reference in f32, against the reference.

    python3 fl_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --faults half_batch,one_answer \
        --out build/fl_bench/calibrate.jsonl

One JSON line a reading, appended to ``--out`` and printed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


def _ints(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--dtype", default=None,
                    help="run program and reference in this compute dtype "
                         "instead of the configuration's")
    ap.add_argument("--f32-seeds", type=_ints, default=[],
                    help="seeds on which the reference in the "
                         "configuration's dtype is read against itself in "
                         "float32")
    ap.add_argument("--out", default="build/fl_bench/calibrate.jsonl")
    args = ap.parse_args(argv)
    import torch

    import flb_check
    import flb_harness
    from flb_prec import Prec
    bench = flb_harness.Bench()
    cell = bench.cell(args.workload)
    if args.dtype:
        cell.cfg["assumed"]["compute_dtype"] = args.dtype
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    device = train.resolve_device("cuda")
    _build.build_all(("fused_cosine", "ef_update"))
    dt = getattr(torch, cell.cfg["assumed"]["compute_dtype"])
    faults = [f for f in args.faults.split(",") if f]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    def emit(kind, seed, values, secs, extra=None):
        line = {"cell": args.workload, "kind": kind, "seed": seed,
                "seconds": secs, **values, **(extra or {})}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")

    def peak():
        p = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        return {"peak_gib": p / 2 ** 30}

    seeds = list(dict.fromkeys(args.seeds + args.control_seeds
                               + args.f32_seeds))
    for seed in seeds:
        tokens = flb_harness.cell_tokens(cell, seed, device)
        t0 = time.perf_counter()
        ref = flb_harness.reference_records(cell, seed, device, tokens,
                                            prec=Prec(dt))
        ref_s = time.perf_counter() - t0
        extra = {"ref_loss": [r["loss"] for r in ref],
                 "ref_cosine": [r["cosine"] for r in ref], **peak()}
        if seed in args.seeds:
            t0 = time.perf_counter()
            prog = flb_harness.Program(cell, seed, device, tokens)
            recs = prog.check_rounds()
            del prog
            secs = time.perf_counter() - t0
            torch.cuda.empty_cache()
            emit("program", seed, flb_check.gaps(recs, ref), secs,
                 {**extra, "ref_seconds": ref_s,
                  "prog_loss": [r["loss"] for r in recs],
                  "prog_cosine": [r["cosine"] for r in recs],
                  "prog_delta": recs[0]["delta"],
                  "ref_delta": ref[0]["delta"],
                  "prog_change": recs[-1]["change"],
                  "ref_change": ref[-1]["change"]})
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            recs = flb_harness.reference_records(
                cell, seed, device, tokens, prec=Prec(dt, fp8=True))
            emit("control_fp8", seed, flb_check.gaps(recs, ref),
                 time.perf_counter() - t0, peak())
        if seed in args.f32_seeds:
            t0 = time.perf_counter()
            recs = flb_harness.reference_records(
                cell, seed, device, tokens, prec=Prec(torch.float32))
            emit("ref_f32", seed, flb_check.gaps(ref, recs),
                 time.perf_counter() - t0,
                 {"f32_cosine": [r["cosine"] for r in recs],
                  "ref_delta": ref[0]["delta"],
                  "f32_delta": recs[0]["delta"]})
        if seed in args.control_seeds:
            for fault in faults:
                t0 = time.perf_counter()
                recs = flb_harness.reference_records(
                    cell, seed, device, tokens, prec=Prec(dt), fault=fault)
                emit("fault_" + fault, seed, flb_check.gaps(recs, ref),
                     time.perf_counter() - t0)
        del tokens, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
