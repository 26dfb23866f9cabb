"""Ranks spawned on one host, and bitwise comparison of what they return.

``Ranks(argvs, logs)`` starts one process per argument vector at once,
each writing its output to its own log. ``join(timeout)`` waits for them
within ``timeout`` seconds of the start and kills what is left, soon after
a first rank fails too (a peer of a dead rank may wait on a collective
for ever). Leaving the ``with`` block kills any rank still running.

``tree_bits_diff(a, b)`` says which leaf of two trees differs bit for bit
(so ``-0.0`` differs from ``0.0`` and a NaN's payload counts), or
``None``. Used by the fan-out's multi-process tests and by the card's
smoke run to hold each rank's replica to the single-process round.
"""
from __future__ import annotations

import subprocess
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import flat

# integer dtypes of each element size: a float is compared as its words
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _words(x: Any) -> torch.Tensor:
    x = (x.detach() if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.asarray(x)))
    if x.is_floating_point():
        x = x.contiguous().view(_WORDS[x.element_size()])
    return x


def bits_equal(a: Any, b: Any) -> bool:
    """``a`` and ``b`` (tensors on any device, or numbers) have the same
    dtype, shape and bits."""
    x, y = _words(a), _words(b)
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.device != y.device:
        x, y = x.cpu(), y.cpu()
    return torch.equal(x, y)


def tree_bits_diff(a: Any, b: Any) -> Optional[str]:
    """``None`` when trees ``a`` and ``b`` hold the same leaves bit for bit,
    else which leaf differs first."""
    la, lb = flat.tree_leaves(a), flat.tree_leaves(b)
    if len(la) != len(lb):
        return f"{len(la)} leaves against {len(lb)}"
    for i, (x, y) in enumerate(zip(la, lb)):
        if not bits_equal(x, y):
            return f"leaf {i} not bitwise equal"
    return None


class Ranks:
    """One process per entry of ``argvs``, all started at once, the output
    and errors of process r in the file ``logs[r]``."""

    def __init__(self, argvs: Sequence[Sequence[str]], logs: Sequence[str],
                 *, env=None, cwd=None):
        self.logs = list(logs)
        self.started = time.monotonic()
        self.procs: List[subprocess.Popen] = []
        try:
            for argv, path in zip(argvs, self.logs):
                with open(path, "w") as log:
                    self.procs.append(subprocess.Popen(
                        list(argv), stdout=log, stderr=subprocess.STDOUT,
                        env=env, cwd=cwd))
        except OSError:
            # a rank that could not start: stop those that did
            self.kill()
            raise

    def join(self, timeout: float, grace: float = 15.0) -> List[int]:
        """Wait until every rank has exited, ``timeout`` seconds after the
        start have passed, or ``grace`` seconds after a first rank exited
        non-zero; kill the rest. Returns the return codes (a killed rank's
        is negative)."""
        deadline = self.started + timeout
        failed_at = None
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in self.procs]
            if all(rc is not None for rc in rcs):
                break
            if failed_at is None and any(rc not in (None, 0) for rc in rcs):
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > grace:
                break
            time.sleep(0.05)
        self.kill()
        return [p.returncode for p in self.procs]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def log(self, rank: int) -> str:
        with open(self.logs[rank]) as f:
            return f.read()

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.kill()
