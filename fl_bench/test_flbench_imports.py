"""What the benchmark loads: a process that runs the harness's import
graph and builds a small cell's program holds no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package); one
that runs the reference alone holds none of ``repro_torch`` either."""
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
TOP = "sorted({m.split('.')[0] for m in sys.modules})"

REFERENCE = f"""
import sys, torch
sys.path[:0] = [{str(HERE)!r}]
import flb_testkit, flb_data, flb_reference, flb_prec, flb_check, tempfile
from pathlib import Path
root = flb_testkit.make_tiny_bench(Path(tempfile.mkdtemp()))
import flb_harness
cell = flb_harness.Bench(root).cell("tiny.qwen1.5-0.5b")
tokens = flb_harness.cell_tokens(cell, 3, torch.device("cpu"))
flb_harness.reference_records(cell, 3, torch.device("cpu"), tokens, rounds=1)
print({TOP})
"""

HARNESS = f"""
import sys, torch
sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent / 'src')!r}]
import flb_testkit, tempfile, run
from pathlib import Path
root = flb_testkit.make_tiny_bench(Path(tempfile.mkdtemp()))
import flb_harness
bench = flb_harness.Bench(root)
for m in bench.manifest["per_layer"] + bench.manifest["end_to_end"]:
    bench.reader(m["name"])
flb_harness.run_cell(bench, "tiny.mamba2-370m", 3, 0.0, False,
                     torch.device("cpu"), 0.0)
print({TOP})
"""


def _modules(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program():
    mods = _modules(REFERENCE)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_harness_loads_no_jax():
    mods = _modules(HARNESS)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
