"""The port's examples can't silently rot: the mirror of
tests/test_examples_smoke.py for ``examples/quickstart_torch.py`` and
``examples/compress_llm_update_torch.py``, each imported and run through
its ``main(argv)`` at tiny shapes on the CPU (``--device cpu``). What is
asserted is the example's own headline claim: decode exactness, at the
reference's bounds (1e-6 and 1e-4)."""
import importlib
import os
import sys

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
    err = ex.main(["--arch", "mamba2-370m", "--steps", "2",
                   "--local-iters", "1", "--device", "cpu"])
    assert err <= 1e-4, err
