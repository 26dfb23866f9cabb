"""The leaf tables of kernels B1 and B2 (``repro_torch.kernels.leaf_table``)
and the tree entries that take them (``fused_cosine_leaves``,
``ef_update_leaves``), on the CPU.

The plan is what the CUDA kernels are launched with, so it is checked
here: a function of the leaf sizes alone, covering every element once,
at most ``TABLE`` segments per launch. On the CPU the tree forms of
``kernels.ops`` keep the reference's route (chunks, ``torch.cat``, the
plain version): they are held bitwise to that route and, within the
reference's rtol 2e-4, to ``repro.kernels.ops`` (Pallas in interpret
mode).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat
from repro_torch.kernels import ef_update as ef_mod
from repro_torch.kernels import fused_cosine as fc_mod
from repro_torch.kernels import leaf_table, ops
from repro_torch.models.cnn import MNIST_SPEC, make_mlp

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL = 2e-4
T = leaf_table.TABLE
E = leaf_table.ELEMS_PER_BLOCK
# a ragged tree of more than one table: sizes 0, 1, 3, 5 and 1,027 and
# leaves that cross block steps
RAGGED_SIZES = [0, 1, 3, 5, 1027] * 17 + [E - 1, E, E + 1, 3 * E + 7]
SIZE_CASES = {
    "empty": [],
    "zeros": [0, 0, 0],
    "one": [1],
    "mlp": [784 * 200, 200, 200 * 200, 200, 200 * 10, 10],
    "ragged": RAGGED_SIZES,
    "one_table": [7] * T,
    "table_plus_one": [7] * (T + 1),
    "capped": [leaf_table.MAX_SEG_BLOCKS * E * 2 + 3, 5],
}


def _mlp_numpy(seed):
    params = make_mlp(MNIST_SPEC).init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return {k: {kk: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                for kk, v in d.items()} for k, d in params.items()}


def _ragged_numpy(seed):
    rng = np.random.default_rng(seed)
    return {f"p{i:03d}": rng.standard_normal(n).astype(np.float32)
            for i, n in enumerate(RAGGED_SIZES)}


TREES = {"mlp": _mlp_numpy, "ragged": _ragged_numpy}


@pytest.mark.parametrize("case", sorted(SIZE_CASES))
def test_segment_plan_covers_every_element_once(case):
    """Every non-empty leaf is one segment of one launch, in leaf order;
    each launch's blocks are numbered segment after segment with no gap;
    each segment's block count is a function of its size alone; and its
    blocks' unrolled steps, striding by that count, cover its elements
    exactly once."""
    sizes = SIZE_CASES[case]
    plan = leaf_table.segment_plan(sizes)
    nonempty = [i for i, n in enumerate(sizes) if n > 0]
    assert len(plan) == math.ceil(len(nonempty) / T)
    assert [leaf for step in plan for leaf, _, _ in step.segments] == nonempty
    for step in plan:
        assert 1 <= len(step.segments) <= T
        first = 0
        for leaf, fb, blocks in step.segments:
            assert fb == first
            assert blocks == leaf_table.segment_blocks(sizes[leaf]) >= 1
            assert blocks <= leaf_table.MAX_SEG_BLOCKS
            first += blocks
            # block b takes steps b, b + blocks, ... of E elements each
            n = sizes[leaf]
            owners = (np.arange(n) // E) % blocks
            assert np.all(np.bincount(owners, minlength=blocks) > 0)
        assert step.blocks == first


@pytest.mark.parametrize("case", sorted(SIZE_CASES))
def test_segment_plan_is_a_function_of_the_sizes(case):
    sizes = SIZE_CASES[case]
    plan = leaf_table.segment_plan(sizes)
    assert plan == leaf_table.segment_plan(list(sizes))
    assert plan == leaf_table.segment_plan(tuple(np.asarray(sizes, np.int64)))
    # a leaf's blocks do not depend on its neighbours
    for step in plan:
        for leaf, _, blocks in step.segments:
            (alone,) = leaf_table.segment_plan([sizes[leaf]])
            assert alone == (((0, 0, blocks),), blocks)


@pytest.mark.parametrize("leaves", [1, T - 1, T, T + 1, 2 * T + 3])
def test_launches_hold_at_most_a_table(leaves):
    """L non-empty leaves, with empty ones between them, take ceil(L / T)
    launches of at most T segments each, every one full but the last."""
    sizes = [0, 5] * leaves
    plan = leaf_table.segment_plan(sizes)
    assert len(plan) == math.ceil(leaves / T)
    assert [len(step.segments) for step in plan[:-1]] == [T] * (len(plan) - 1)
    assert 1 <= len(plan[-1].segments) <= T


def test_scratch_holds_the_largest_launch():
    """B1's partials scratch, made once per stream, has a row for every
    block of the largest launch a plan can hold: T segments at the cap."""
    capped = leaf_table.MAX_SEG_BLOCKS * E
    (step,) = leaf_table.segment_plan([capped] * T)
    assert step.blocks == fc_mod.SCRATCH_ROWS
    assert max(s.blocks for s in leaf_table.segment_plan(RAGGED_SIZES)) \
        <= fc_mod.SCRATCH_ROWS


def test_first_call_on_a_stream_inside_a_capture_raises(monkeypatch):
    """A stream's scratch and ticket are made outside any CUDA graph
    capture: its first call while one is being captured raises before it
    allocates anything."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(fc_mod, "_SCRATCH", {})
    with pytest.raises(RuntimeError, match="captured"):
        fc_mod._scratch(torch.device("cuda", 0), 12345)
    assert fc_mod._SCRATCH == {}


@pytest.mark.parametrize("n,blocks", [(0, 0), (1, 1), (E, 1), (E + 1, 2),
                                      (199_210, 98),
                                      ((1 << 22) + 5,
                                       leaf_table.MAX_SEG_BLOCKS)])
def test_segment_blocks(n, blocks):
    assert leaf_table.segment_blocks(n) == blocks


@pytest.mark.parametrize("tree", sorted(TREES))
def test_cpu_tree_stats_keep_the_cat_route(tree):
    """On the CPU ``tree_fused_stats`` is bitwise the plain version on the
    concatenated leaves (both trees are under one chunk), and within the
    reference's tolerance of ``repro.kernels.ops``."""
    a, b = TREES[tree](1), TREES[tree](2)
    ta, tb = params_from_numpy(a, CPU), params_from_numpy(b, CPU)
    la, lb = flat.tree_leaves(ta), flat.tree_leaves(tb)
    got = ops.tree_fused_stats(ta, tb)
    cat_a = torch.cat([l.reshape(-1) for l in la])
    cat_b = torch.cat([l.reshape(-1) for l in lb])
    assert len(ops._chunk_plan([l.numel() for l in la],
                               ops.TREE_CHUNK_ELEMS)) == 1
    want = fc_mod.fused_cosine_plain(cat_a, cat_b)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    leaves = fc_mod.fused_cosine_leaves([l.reshape(-1) for l in la],
                                        [l.reshape(-1) for l in lb])
    assert torch.equal(leaves.view(torch.int32), want.view(torch.int32))
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.tree_fused_stats(ja, jb)),
                               rtol=RTOL)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_cpu_tree_ef_update_keeps_the_cat_route(tree):
    """On the CPU ``tree_ef_update`` is bitwise the plain version on the
    concatenated leaves, and so is ``ef_update_leaves`` leaf by leaf;
    within rtol 1e-5 / atol 1e-6 of ``repro.kernels.ops``."""
    u, d = TREES[tree](3), TREES[tree](4)
    tu, td = params_from_numpy(u, CPU), params_from_numpy(d, CPU)
    s = torch.tensor([-0.37])
    lu, ld = flat.tree_leaves(tu), flat.tree_leaves(td)
    got = torch.cat([l.reshape(-1) for l in
                     flat.tree_leaves(ops.tree_ef_update(tu, td, s))])
    want = ef_mod.ef_update_plain(torch.cat([l.reshape(-1) for l in lu]),
                                  torch.cat([l.reshape(-1) for l in ld]), s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    leaves = torch.cat(ef_mod.ef_update_leaves(
        [l.reshape(-1) for l in lu], [l.reshape(-1) for l in ld], s))
    assert torch.equal(leaves.view(torch.int32), want.view(torch.int32))
    ju, jd = jax.tree.map(jnp.asarray, u), jax.tree.map(jnp.asarray, d)
    jgot = jops.tree_ef_update(ju, jd, jnp.float32(-0.37))
    for g, w in zip(jax.tree.leaves(to_numpy(ops.tree_ef_update(tu, td, s))),
                    jax.tree.leaves(jgot)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


def test_zero_size_leaves_on_the_cpu():
    zs = [torch.zeros(0), torch.arange(3.0), torch.zeros(0)]
    os_ = [torch.zeros(0), torch.ones(3), torch.zeros(0)]
    np.testing.assert_array_equal(fc_mod.fused_cosine_leaves(zs, os_).numpy(),
                                  [3.0, 5.0, 3.0])
    np.testing.assert_array_equal(
        fc_mod.fused_cosine_leaves([torch.zeros(0)], [torch.zeros(0)]),
        np.zeros(3))
    outs = ef_mod.ef_update_leaves(zs, os_, torch.tensor([2.0]))
    assert [tuple(o.shape) for o in outs] == [(0,), (3,), (0,)]
    np.testing.assert_array_equal(outs[1].numpy(), [-2.0, -1.0, 0.0])


def _bad_leaf_calls():
    x = torch.ones(8)
    meta = torch.ones(8, device="meta")
    s = torch.ones(1)
    return [
        ("dtype", TypeError, [x.double()], [x.double()], s),
        ("length", ValueError, [x, x], [x], s),
        ("no leaves", ValueError, [], [], s),
        ("shape", ValueError, [x], [torch.ones(9)], s),
        ("rank", ValueError, [x.reshape(2, 4)], [x.reshape(2, 4)], s),
        ("contiguity", ValueError, [torch.ones(16)[::2]], [x], s),
        ("pair device", ValueError, [x], [meta], s),
        ("leaf device", ValueError, [x, meta], [x, meta], s),
        ("device", ValueError, [meta], [meta], torch.ones(1, device="meta")),
    ]


@pytest.mark.parametrize("what,err,xs,ys,s", _bad_leaf_calls(),
                         ids=[c[0] for c in _bad_leaf_calls()])
def test_leaf_entries_check_their_inputs(what, err, xs, ys, s):
    with pytest.raises(err):
        fc_mod.fused_cosine_leaves(xs, ys)
    with pytest.raises(err):
        ef_mod.ef_update_leaves(xs, ys, s)


def test_ef_update_leaves_checks_s():
    x = torch.ones(8)
    with pytest.raises(ValueError):
        ef_mod.ef_update_leaves([x], [x], torch.ones(2))
    with pytest.raises(TypeError):
        ef_mod.ef_update_leaves([x], [x], torch.ones(1, dtype=torch.float64))


def test_cpu_leaf_entries_launch_nothing():
    fc0, ef0 = fc_mod.LAUNCHES, ef_mod.LAUNCHES
    xs = [torch.arange(5.0), torch.ones(2)]
    fc_mod.fused_cosine_leaves(xs, xs)
    ef_mod.ef_update_leaves(xs, xs, torch.ones(1))
    assert (fc_mod.LAUNCHES, ef_mod.LAUNCHES) == (fc0, ef0)
