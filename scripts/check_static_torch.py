"""Static-analysis gate of the PyTorch port: round contracts, repo lints,
protocol analysis.

One entry point for the layers of ``repro_torch.analysis`` plus (when the
binary exists) ruff with the repo's pinned ``pyproject.toml`` rule set:

* **Round contracts** — records one round of every constructible
  strategy × fan-out × wire × fused × faulted configuration at tiny shapes
  (mesh-free in this process, sharded on four gloo ranks on the CPU) and
  checks the five ``repro_torch.analysis.contracts`` rules against the
  records; the report carries the client-scope host reads per strategy.
* **Repo lint** — the four AST rules of ``repro_torch.analysis.lint`` over
  ``src/repro_torch/``.
* **Protocol** — the ``MSG_*`` transition-table rules and the shared-state
  locking rules of ``repro_torch.analysis.protocol``.
* **ruff** — where the binary is missing the stanza records
  ``available: false`` and the layer is skipped (never silently green: the
  report says so).

Prints one JSON report as its last line and writes no file. Exits 1 on any
violation, or when any rule or contract evaluated nothing.

    PYTHONPATH=src python scripts/check_static_torch.py   # ~20 s on a CPU
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def run_ruff_layer() -> Dict:
    """ruff with the pyproject.toml pins, over the port's files."""
    exe = shutil.which("ruff")
    if exe is None:
        return {"available": False, "violations": []}
    p = subprocess.run(
        [exe, "check", "--output-format", "concise", "src/repro_torch",
         "scripts/check_static_torch.py", "chip_smoke.py"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in p.stdout.splitlines()
             if ln.strip() and not ln.startswith(("Found", "All checks"))]
    return {"available": True, "exit": p.returncode,
            "violations": lines if p.returncode != 0 else []}


def _print_rules(rules: Dict) -> List[str]:
    """Print each rule's verdict; returns the names that evaluated
    nothing."""
    empty = []
    for name, r in rules.items():
        if r["evaluated"] == 0:
            empty.append(name)
        mark = "PASS" if r["evaluated"] and not r["violations"] else "FAIL"
        print(f"  [{mark}] {name}: {r['evaluated']} evaluated")
        for v in r["violations"]:
            print(f"      - {v}")
    return empty


def main() -> int:
    from repro_torch.analysis import contracts, ir, lint, protocol

    report: Dict = {}
    print("== Round contracts: one recorded round per configuration "
          "(mesh-free here, sharded on 4 gloo ranks) ==")
    report["contracts"] = ir.run_all()
    rc = report["contracts"]
    want = len(ir.iter_round_configs())
    print(f"  {rc['configs_evaluated']} of {want} configs, "
          f"{rc['rules_evaluated']} rule evaluations, {rc['violations']} "
          f"violation(s)")
    empty = _print_rules(rc["contracts"])
    print(f"  client-scope host reads per strategy: "
          f"{rc['host_syncs_by_kind']} (allowed: "
          f"{contracts.EXPECTED_HOST_SYNCS or 'none'})")

    print("== Repo lint (AST over src/repro_torch/) ==")
    report["lint"] = lint.run_lint()
    empty += _print_rules(report["lint"]["rules"])

    print("== Protocol analysis (transport/worker) ==")
    report["protocol"] = protocol.run_protocol()
    empty += _print_rules(report["protocol"]["rules"])

    print("== ruff (pyproject.toml pins) ==")
    report["ruff"] = run_ruff_layer()
    if not report["ruff"]["available"]:
        print("  ruff not installed in this environment — layer skipped "
              "(recorded in the report)")
    else:
        mark = "PASS" if not report["ruff"]["violations"] else "FAIL"
        print(f"  [{mark}] exit {report['ruff']['exit']}")
        for v in report["ruff"]["violations"][:50]:
            print(f"      - {v}")

    layers = ("contracts", "lint", "protocol")
    report["rules_evaluated"] = sum(report[k]["rules_evaluated"]
                                    for k in layers)
    report["violations"] = (sum(report[k]["violations"] for k in layers)
                            + len(report["ruff"]["violations"]))
    report["configs_evaluated"] = rc["configs_evaluated"]
    report["unevaluated"] = empty
    report["pass"] = (report["violations"] == 0 and not empty
                      and rc["configs_evaluated"] == want)
    print(f"\ncheck_static_torch: {rc['configs_evaluated']} configs, "
          f"{report['rules_evaluated']} rule evaluations, "
          f"{report['violations']} violation(s), "
          f"{len(empty)} rule(s) evaluated nothing")
    print(json.dumps(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
