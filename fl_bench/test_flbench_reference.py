"""The plain reference against the port's round at small widths on the
CPU, through the harness's own run of a cell that exists only as files
added beside the real ones (the manifest unchanged), and the harness's
weights in the layout of the port's own ``init``."""
import math

import pytest
import torch

import flb_check
import flb_data
import flb_harness
from flb_testkit import TINY, make_tiny_bench

CELLS = [f"tiny.{name}" for name in TINY]
# f32 at small widths: the two sides differ by summation order alone
TOL = {"loss": 1e-6, "ef": 1e-5, "cosine": 1e-3, "update_norm": 1e-3,
       "delta": 1e-3, "change": 1e-3, "applied": 1e-3, "payload": 0.0}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_bench(tmp_path_factory.mktemp("flbench"))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_program(tiny_root, cell):
    torch.manual_seed(0)
    bench = flb_harness.Bench(tiny_root)
    out = flb_harness.run_cell(bench, cell, 2 ** 31 + 7, 0.05, False,
                               torch.device("cpu"), 0.0)
    for name, tol in TOL.items():
        assert out["values"][name] <= tol, (name, out["values"])
    res = out["result"]
    assert res["correct"] and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"round_s", "setup_s"}   # no peak on CPU
    assert len(out["program"]) == flb_harness.CHECK_ROUNDS


@pytest.mark.parametrize("cell", CELLS)
def test_weights_in_the_program_layout(tiny_root, cell):
    """The benchmark's weights have the leaves, shapes and dtype of the
    port's ``model.init`` at the same configuration."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.build import build_model
    c = flb_harness.Bench(tiny_root).cell(cell)
    model = build_model(ModelConfig(name=cell,
                                    **c.family.program_config(c.cfg)))
    gen = torch.Generator().manual_seed(0)
    ours = flb_data.make_weights(c.family.param_specs(c.cfg), 3,
                                 torch.device("cpu"))
    theirs = flb_data.flatten(model.init(gen))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    assert all(v.dtype == theirs[k].dtype for k, v in ours.items())
    assert all(torch.isfinite(v).all() for v in ours.values())
    again = flb_data.make_weights(c.family.param_specs(c.cfg), 3,
                                  torch.device("cpu"))
    assert all(torch.equal(v, again[k]) for k, v in ours.items())


def test_batches_differ_within_the_checked_rounds():
    tokens = flb_data.make_tokens(5, 64, 8, 100, torch.device("cpu"))
    b = flb_data.Batcher(tokens, 5, clients=4, local_steps=1, batch=4)
    rows = torch.cat([b.rows(r).reshape(-1)
                      for r in range(flb_harness.CHECK_ROUNDS)])
    assert rows.unique().numel() == rows.numel()
    assert torch.equal(b(0, 1)["tokens"], tokens[b.rows(1)])
    assert flb_data.fold_in(2 ** 31 + 5, 1, 2) < 2 ** 63
    assert math.isfinite(float(tokens.float().mean()))


@pytest.mark.parametrize("p,r,want", [
    ({"a": 3.0, "b": 4.0}, {"a": 0.0, "b": 5.0}, 0.0),
    ({"a": 10.0}, {"a": 5.0}, math.log(2.0)),
    ({"a": 5.0}, {"a": 10.0}, math.log(2.0)),
    ({"a": 0.0, "b": 0.0}, {"a": 1e-9, "b": 0.0}, math.inf),
    ({"a": 0.0}, {"a": 0.0}, 0.0),
    ({"a": math.nan}, {"a": 1.0}, math.inf)])
def test_tree_factor(p, r, want):
    """The whole tree's change as a factor either way; a tree that did not
    move against one that did reads infinity."""
    assert flb_check.tree_factor(p, r) == pytest.approx(want)
