"""Run one cell of the benchmark once and print its result line.

    python3 fl_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Needs a CUDA card (exits 2 without one, or
with fewer than the cell asks for). The last line of standard output is
the result's JSON: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, traced, ``breakdown``, and ``setup_parts`` (``setup_s`` by
part, the kernels' build among them, in seconds); its last key, ``check``,
and the last lines of standard error give each number the check compared
beside its limit. Exits 3, printing no result, if a JAX module or the JAX
package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    import flb_harness
    bench = flb_harness.Bench()
    cells = {w["name"]: w for w in bench.manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; one of {sorted(cells)}",
              file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = flb_harness.run_cell(bench, args.workload, args.seed,
                               args.seconds, bool(args.trace),
                               torch.device("cuda"), T_START)
    found = flb_harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 3
    print(json.dumps(out["result"]))
    for name, value in sorted(out["values"].items()):
        print(f"  {name}: {value!r}", file=sys.stderr)
    for part, secs in out["result"]["setup_parts"].items():
        print(f"  setup {part}: {secs!r}", file=sys.stderr)
    print(f"correct: {out['result']['correct']}", file=sys.stderr)
    for name, value, limit in out["rows"]:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
