"""The port's examples can't silently rot: the mirror of
tests/test_examples_smoke.py for ``examples/quickstart_torch.py``,
``examples/compress_llm_update_torch.py`` and
``examples/fl_training_torch.py``, each imported and run through its
``main(argv)`` at tiny shapes on the CPU (``--device cpu``). What is
asserted is the example's own headline claim: decode exactness, at the
reference's bounds (1e-6 and 1e-4), and a completed training run with
metrics, run config and checkpoint."""
import importlib
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

torch.set_num_threads(2)


def _load(name):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def test_quickstart_main_tiny():
    qs = _load("quickstart_torch")
    err = qs.main(["--train-size", "64", "--test-size", "32",
                   "--local-steps", "2", "--batch", "8", "--syn-steps", "2",
                   "--device", "cpu"])
    # the example's headline claim: server decode == client recon exactly
    assert err <= 1e-6, err


def test_compress_llm_update_main_tiny():
    ex = _load("compress_llm_update_torch")
    err = ex.main(["--arch", "tinyllama-1.1b", "--steps", "2",
                   "--local-iters", "1", "--device", "cpu"])
    assert err <= 1e-4, err


@pytest.mark.parametrize("wire", ["float", "codec"])
def test_fl_training_main_tiny(tmp_path, wire):
    ex = _load("fl_training_torch")
    out = str(tmp_path / f"run_{wire}")
    ex.main(["--rounds", "2", "--clients", "2", "--train-size", "128",
             "--batch", "16", "--eval-every", "1", "--wire", wire,
             "--device", "cpu", "--out", out])
    # metrics + run config + checkpoint all written
    lines = [json.loads(l) for l in
             open(os.path.join(out, "metrics.jsonl"))]
    assert lines and lines[-1]["round"] == 2
    rc = json.load(open(os.path.join(out, "run_config.json")))
    assert rc["wire"] == wire and rc["fl"]["num_clients"] == 2
    assert os.path.isdir(os.path.join(out, "final"))
