"""The check must fail what it exists to catch. On the CPU at small widths,
with each real cell's limits: the control (the reference with its
products' operands in fp8) against the reference, and a run of the
harness with a fault planted in the program underneath it: a round that
returns its state unchanged, and each half of that on its own (the server
leaves the params as they were; the clients leave their residuals), each
client's batch cut to half (the mean over the rest), and an answer
altered where it is produced (client 0's residual, and the scale of its
reconstruction). On the card, the control at the cell's own size."""
import json
from pathlib import Path

import pytest
import torch

import flb_check
import flb_harness
from flb_testkit import make_tiny_bench
from flb_prec import Prec

REAL = ["qwen1.5-0.5b.fl3sfc.t4096", "mamba2-370m.fl3sfc.t2048"]
TINY = {"qwen1.5-0.5b.fl3sfc.t4096": "tiny.qwen1.5-0.5b",
        "mamba2-370m.fl3sfc.t2048": "tiny.mamba2-370m"}
SEED = 2 ** 31 + 11
HERE = Path(__file__).resolve().parent


def _params_unchanged(mp):
    import repro_torch.fl.round as rnd
    mp.setattr(rnd, "server_update", lambda params, agg, lr=1.0: params)


def _ef_unchanged(mp):
    import repro_torch.core.strategy as strategy
    mp.setattr(strategy.CompressionStrategy, "_ef_update",
               lambda self, u, e, recon, d, s: e)


def _state_unchanged(mp):
    _params_unchanged(mp)
    _ef_unchanged(mp)


def _half_batch(mp):
    import repro_torch.fl.round as rnd
    real = rnd.local_train

    def half(loss_fn, params, batches, lr, **kw):
        cut = {k: v[:, : v.shape[1] // 2] for k, v in batches.items()}
        return real(loss_fn, params, cut, lr, **kw)
    mp.setattr(rnd, "local_train", half)


def _residual_altered(mp):
    import repro_torch.core.strategy as strategy
    from repro_torch.core import flat
    real = strategy.CompressionStrategy._ef_update
    seen = []

    def altered(self, u, e, recon, d, s):
        out = real(self, u, e, recon, d, s)
        seen.append(1)
        if len(seen) % 2 == 1:               # client 0 of each round
            out = flat.tree_map(lambda v: v * 1.5, out)
        return out
    mp.setattr(strategy.CompressionStrategy, "_ef_update", altered)


def _scale_altered(mp):
    import repro_torch.core.threesfc as threesfc
    real = threesfc.encode

    def altered(*a, **kw):
        res = real(*a, **kw)
        return res._replace(s=res.s * 2.0)
    mp.setattr(threesfc, "encode", altered)


FAULTS = {"none": None, "state_unchanged": _state_unchanged,
          "params_unchanged": _params_unchanged,
          "ef_unchanged": _ef_unchanged,
          "half_batch": _half_batch, "residual_altered": _residual_altered,
          "scale_altered": _scale_altered}


# the reconstruction's scale is seen only by a cell that compares a
# number of the aggregate (mamba2's are bf16 noise; PERF.md §2)
CASES = [(real, fault) for real in REAL for fault in FAULTS
         if fault != "scale_altered" or "update_norm" in json.loads(
             (HERE / "cells" / f"{real}.json").read_text())["limits"]]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {real: make_tiny_bench(tmp_path_factory.mktemp("f"),
                                  limits_from=real) for real in REAL}


@pytest.mark.parametrize("real,fault", CASES)
def test_planted_fault_fails_the_check(roots, real, fault, monkeypatch):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    out = flb_harness.run_cell(flb_harness.Bench(roots[real]), TINY[real],
                               SEED, 0.0, False, torch.device("cpu"), 0.0)
    assert out["result"]["correct"] is (fault == "none"), out["values"]


def _control(cell, seed, device):
    tokens = flb_harness.cell_tokens(cell, seed, device)
    dt = getattr(torch, cell.cfg["assumed"]["compute_dtype"])
    ref = flb_harness.reference_records(cell, seed, device, tokens,
                                        prec=Prec(dt))
    ctl = flb_harness.reference_records(cell, seed, device, tokens,
                                        prec=Prec(dt, fp8=True))
    return flb_check.verdict(flb_check.gaps(ctl, ref), cell.spec["limits"])


@pytest.mark.parametrize("real", REAL)
def test_control_fails_at_small_size(tmp_path, real):
    root = make_tiny_bench(tmp_path, dtype="bfloat16", limits_from=real)
    ok, rows = _control(flb_harness.Bench(root).cell(TINY[real]), SEED,
                        torch.device("cpu"))
    assert not ok, rows


@pytest.mark.card
@pytest.mark.parametrize("real", REAL)
def test_control_fails_at_cell_size(card, real):
    ok, rows = _control(flb_harness.Bench().cell(real), SEED, card)
    assert not ok, rows
