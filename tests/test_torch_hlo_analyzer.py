"""The op-trace cost analyzer (``repro_torch.utils.hlo_analyzer``) against
the reference's HLO analyzer: the nine tests of ``tests/test_hlo_analyzer.py``
under the same names, on op traces. A loop's trips are recorded one by one
where the reference multiplies a while body by its trip count; a scope is a
``record_function`` range where the reference reads the name stack; the
collectives run on a fake process group of this one process."""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.utils import hlo_analyzer as RH
from repro_torch.fl.round import CLIENT_SCOPE
from repro_torch.launch.dryrun import fake_mesh
from repro_torch.utils import hlo_analyzer as H

torch.set_num_threads(2)


def _ref(f, *shapes):
    """The reference analyzer's totals for ``f`` jitted on ones."""
    args = [jnp.ones(s) for s in shapes]
    return RH.analyze(jax.jit(f).lower(*args).compile().as_text())


def _ones(*shape):
    return torch.ones(shape, dtype=torch.float32)


def test_matmul_exact():
    tr = H.record(lambda a, b: a @ b, _ones(128, 64), _ones(64, 32))
    tot = H.analyze(tr)
    assert tot.flops == 2 * 128 * 64 * 32
    assert tot.flops == _ref(lambda a, b: a @ b, (128, 64), (64, 32)).flops
    assert tot.flops_by_class == {"f32": tot.flops}


def test_scan_multiplies_trip_count():
    def looped(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    def scanned(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        out, _ = jax.lax.scan(body, x, None, length=7)
        return out

    tr = H.record(looped, _ones(64, 64), _ones(64, 64))
    truth = 7 * 2 * 64 ** 3
    assert H.analyze(tr).flops == truth
    assert _ref(scanned, (64, 64), (64, 64)).flops == truth
    # every trip is its own record, each of trip 1
    mms = [o for o in tr.ops if o.op == "aten.mm.default"]
    assert len(mms) == 7 and all(o.trip == 1 for o in mms)


def test_nested_scan():
    def nested(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    tr = H.record(nested, _ones(32, 32), _ones(32, 32))
    assert H.analyze(tr).flops == 15 * 2 * 32 ** 3


def test_bytes_close_to_xla_on_loop_free():
    """Eager PyTorch fuses nothing: mm, tanh and add each read their
    operands and write their result, 8 arrays of 256² f32 in all; XLA fuses
    the tanh and the add, so the reference counts no more."""
    def f(a, b):
        return torch.tanh(a @ b) + a

    tr = H.record(f, _ones(256, 256), _ones(256, 256))
    tot = H.analyze(tr)
    assert tot.bytes == 8 * 256 * 256 * 4
    ref = _ref(lambda a, b: jnp.tanh(a @ b) + a, (256, 256), (256, 256))
    assert tot.bytes >= ref.bytes


def test_collectives_scaled_by_trip_count():
    def f(x):
        for _ in range(4):
            dist.all_reduce(x)
        return x

    with fake_mesh((4, 1)):
        tr = H.record(f, _ones(64, 128))
    tot = H.analyze(tr)
    assert tot.coll_bytes["all-reduce"] == 4 * 64 * 128 * 4
    assert all(v == 0.0 for k, v in tot.coll_bytes.items()
               if k != "all-reduce")


def test_collective_extraction_with_scope_and_trip():
    """collectives(): per-call records carry operand bytes, trip 1 (a loop
    of 3 is three records), and the scope stack that gates the per-client
    encode region collective-free."""
    def f(x):
        out = torch.empty((64, 16))
        dist.all_gather_into_tensor(out, x)
        with torch.profiler.record_function(CLIENT_SCOPE):
            for _ in range(3):
                dist.all_reduce(x)
        return out

    with fake_mesh((8, 1)):
        tr = H.record(f, _ones(8, 16))
    cols = H.collectives(tr)
    assert [c.kind for c in cols] == ["all-gather"] + ["all-reduce"] * 3
    ag, ars = cols[0], cols[1:]
    assert ag.bytes == 8 * 16 * 4 and ag.trip == 1
    assert ag.entry == "all_gather_into_tensor"
    assert ag.dtypes == ("torch.float32",)
    assert all(c.bytes == 8 * 16 * 4 and c.trip == 1 for c in ars)
    assert sum(c.total_bytes for c in ars) == 3 * 8 * 16 * 4
    assert H.collective_bytes(tr) == ag.total_bytes + 3 * ars[0].total_bytes
    scoped = H.collectives_in_scope(tr, CLIENT_SCOPE)
    assert [c.kind for c in scoped] == ["all-reduce"] * 3
    assert H.collectives_in_scope(tr, "nonexistent_scope") == []


# ---------------------------------------------------------------------------
# edge cases: degenerate runs must yield zeros, not crashes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", ["empty-trace", "no-op", "views-only",
                                 "no-tensor"])
def test_empty_or_entryless_module(run):
    """A trace with nothing to count -> zero totals and empty
    extractions."""
    x = _ones(4, 4)
    tr = {"empty-trace": lambda: H.Trace(),
          "no-op": lambda: H.record(lambda: None),
          "views-only": lambda: H.record(
              lambda t: t.view(-1)[1:].unsqueeze(0).t(), x),
          "no-tensor": lambda: H.record(lambda n: n + 1, 3)}[run]()
    tot = H.analyze(tr)
    assert tot.flops == 0.0 and tot.bytes == 0.0
    assert all(v == 0.0 for v in tot.coll_bytes.values())
    assert H.collectives(tr) == []
    assert H.collective_bytes(tr) == 0.0
    assert H.collectives_in_scope(tr, "any") == []
    assert tr.memory["peak_bytes"] == tr.memory["argument_bytes"]


def test_no_collective_module():
    """A loop-free run with zero collectives: flop/byte totals populate,
    every collective bucket stays exactly zero."""
    def f(a, b):
        return torch.tanh(a @ b)

    tr = H.record(f, _ones(64, 32), _ones(32, 16))
    tot = H.analyze(tr)
    assert tot.flops == 2 * 64 * 32 * 16
    assert tot.bytes > 0.0
    assert all(v == 0.0 for v in tot.coll_bytes.values())
    assert H.collectives(tr) == []
    assert H.collective_bytes(tr) == 0.0


def test_nested_scopes_and_nested_trip_counts():
    """A collective inside a loop within a loop under nested scopes: the
    trips compound (2·3 = 6 records) and every enclosing scope level
    matches by substring on the joined stack."""
    def f(x):
        with torch.profiler.record_function("outer_scope"):
            for _ in range(2):
                with torch.profiler.record_function("inner_scope"):
                    for _ in range(3):
                        dist.all_reduce(x)
        return x

    with fake_mesh((2, 1)):
        tr = H.record(f, _ones(8, 8))
        # the scopes close: an op after them is in none
        after = H.record(lambda a: (f(a), a + 1)[1], _ones(2, 2))
    assert after.ops[-1].op_name == ""
    cols = H.collectives(tr)
    assert len(cols) == 2 * 3
    assert {c.op_name for c in cols} == {"outer_scope/inner_scope"}
    assert H.collective_bytes(tr) == 6 * 8 * 8 * 4
    # totals agree with the extraction
    assert H.analyze(tr).coll_bytes["all-reduce"] == H.collective_bytes(tr)
    for scope in ("outer_scope", "inner_scope", "outer_scope/inner_scope"):
        assert [c.kind for c in H.collectives_in_scope(tr, scope)] == \
            ["all-reduce"] * 6, scope
    assert H.collectives_in_scope(tr, "other_scope") == []


def test_product_classes_follow_dtype_and_tf32():
    """f32 products count as f32 with TF32 off and as tf32 with it on;
    bf16 products as bf16; elementwise ops count no FLOPs."""
    a, b = _ones(16, 8), _ones(8, 4)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = H.analyze(H.record(lambda x, y: x @ y, a, b))
        torch.backends.cuda.matmul.allow_tf32 = True
        on = H.analyze(H.record(lambda x, y: x @ y, a, b))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    bf = H.analyze(H.record(lambda x, y: x @ y, a.bfloat16(), b.bfloat16()))
    flops = 2 * 16 * 8 * 4
    assert off.flops_by_class == {"f32": flops}
    assert on.flops_by_class == {"tf32": flops}
    assert bf.flops_by_class == {"bf16": flops}
    ew = H.analyze(H.record(lambda x: torch.exp(x) * x + 1.0, a))
    assert ew.flops == 0.0 and ew.bytes > 0.0
