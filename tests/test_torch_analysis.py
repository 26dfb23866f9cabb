"""Negative fixtures for the port's static analysis (``repro_torch.analysis``).

Mirror of tests/test_analysis.py: a checker that never fires is
indistinguishable from one that works, so every contract and every lint
rule gets a fixture in which its invariant is deliberately broken, and the
test asserts the rule FIRES:

* collectives recorded inside and outside ``CLIENT_SCOPE`` (a real
  all-reduce on a one-rank gloo group through ``RoundRecorder``) and in a
  mesh-free round (``client-scope-clean``);
* every counted host read, made inside the client scope and outside it
  (``no-host-sync-in-client-scope``);
* a real round through an engine built with ``donate=False``
  (``ef-donation-in-place``);
* a 16 KiB gather against a 1 B payload budget (``fused-gather-bounded``);
* an unregistered policy, a frame no larger than its header and a float
  tree on the wire (``wire-dtype-policy``);
* known-bad AST snippets for the four lint rules, including draws from
  torch's global RNG with and without ``generator=``.

The head sources are pinned clean too: the lint, and the contracts over the
whole matrix (the mesh-free half in this process, the sharded half on four
gloo ranks), whose size is the reference's.
"""
import ast
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed.distributed_c10d as c10d

from repro_torch.analysis import contracts, ir, lint
from repro_torch.analysis.contracts import (CLIENT_SCOPE, Collective,
                                            RoundRecord, RoundRecorder,
                                            run_contracts)
from repro_torch.fl.round import client_scope

torch.set_num_threads(2)


def _record(fanout="shard_map", wire="float", fused=False, **kw):
    cfg = {"kind": "threesfc", "fanout": fanout, "wire": wire,
           "fused": fused, "faulted": False}
    kw.setdefault("ef_in", [1])
    kw.setdefault("ef_out", [1])
    return RoundRecord(config=cfg, **kw)


def _violations(report, name):
    return report["contracts"][name]["violations"]


def _gather(nbytes=64, in_scope=False, dtype="torch.float32"):
    return Collective("all_gather_into_tensor", nbytes, [dtype], in_scope)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group (a FileStore, no port)."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# contract negatives
# ---------------------------------------------------------------------------


def test_scoped_collective_fires(one_rank):
    """A real all-reduce inside the client scope is recorded as scoped and
    the contract names it; the same call outside the scope is server-side
    traffic: clean. The patches are gone after the recorder."""
    t = torch.ones(16, 4)
    originals = (dist.all_reduce, c10d.all_reduce)
    with RoundRecorder() as rec:
        with client_scope():
            dist.all_reduce(t)
    assert [(c.kind, c.nbytes, c.in_scope) for c in rec.collectives] \
        == [("all_reduce", 256, True)]
    rep = run_contracts([_record(collectives=rec.collectives)])
    viol = _violations(rep, "client-scope-clean")
    assert viol and CLIENT_SCOPE in viol[0] and "all_reduce" in viol[0]
    with RoundRecorder() as rec:
        dist.all_reduce(t)
    assert [c.in_scope for c in rec.collectives] == [False]
    rep = run_contracts([_record(collectives=rec.collectives)])
    assert not _violations(rep, "client-scope-clean")
    assert (dist.all_reduce, c10d.all_reduce) == originals


def test_mesh_free_round_must_be_collective_free():
    rep = run_contracts([_record(fanout="vmap", collectives=[_gather()])])
    assert _violations(rep, "client-scope-clean")
    # a sharded round whose boundary went unrecorded fires too
    rep = run_contracts([_record()])
    assert any("no collective recorded" in v
               for v in _violations(rep, "client-scope-clean"))


def test_clean_record_passes():
    ctx = ir.build_context()
    rec = ir.record_round({"kind": "threesfc", "fanout": "vmap",
                           "wire": "codec", "fused": False,
                           "faulted": False}, ctx)
    rep = run_contracts([rec])
    assert rep["violations"] == 0, rep["contracts"]
    assert rep["rules_evaluated"] == 4   # scope, host sync, donation, wire
    assert rec.ef_in and rec.ef_in == rec.ef_out


# every counted host read, as a call on a tensor
HOST_READ_CALLS = {
    "item": lambda t: t[0].item(),
    "tolist": lambda t: t.tolist(),
    "numpy": lambda t: t.numpy(),
    "__array__": lambda t: np.asarray(t),
    "__bool__": lambda t: bool(t[0]),
    "__float__": lambda t: float(t[0]),
    "__int__": lambda t: int(t[0]),
    "__index__": lambda t: [0, 1, 2][t[0].long()],
    "cpu": lambda t: t.cpu(),
    "to(cpu)": lambda t: t.to("cpu"),
}


def test_every_host_read_has_a_fixture():
    assert set(HOST_READ_CALLS) == set(contracts.HOST_READS) | {"to(cpu)"}


@pytest.mark.parametrize("method", sorted(HOST_READ_CALLS))
def test_host_read_fires_inside_the_scope_only(method):
    t = torch.ones(3)
    with RoundRecorder() as rec:
        HOST_READ_CALLS[method](t)               # outside: not counted
        assert rec.host_syncs == {}
        with client_scope():
            HOST_READ_CALLS[method](t)
    assert rec.host_syncs == {method: 1}
    rep = run_contracts([_record(fanout="vmap",
                                 host_syncs=rec.host_syncs)])
    viol = _violations(rep, "no-host-sync-in-client-scope")
    assert viol and method in viol[0]
    # the recorder left: the scope counts nothing
    with client_scope():
        HOST_READ_CALLS[method](t)
    assert rec.host_syncs == {method: 1}


def test_ef_donation_negative_without_donate():
    """The same round through an undonating engine holds a second EF tree:
    the contract fires; donated, it is clean."""
    ctx = ir.build_context()
    cfg = {"kind": "topk", "fanout": "vmap", "wire": "float",
           "fused": False, "faulted": False}
    plain = ir.record_round(cfg, ctx, donate=False)
    viol = _violations(run_contracts([plain]), "ef-donation-in-place")
    assert viol and "not in the donated storage" in viol[0]
    donated = ir.record_round(cfg, ctx)
    assert not _violations(run_contracts([donated]), "ef-donation-in-place")
    # a record that saw no EF leaf cannot pass by default
    rep = run_contracts([_record(fanout="vmap", ef_in=[], ef_out=[])])
    assert _violations(rep, "ef-donation-in-place")


def test_fused_gather_bound_fires():
    # 16 KiB gathered against a 1 B local payload budget: way past
    # FACTOR x payload + SLACK
    rep = run_contracts([_record(fused=True, collectives=[_gather(16384)],
                                 payload_bytes_local=1.0)])
    viol = _violations(rep, "fused-gather-bounded")
    assert viol and "> bound" in viol[0]
    rep = run_contracts([_record(fused=True, collectives=[_gather(64)],
                                 payload_bytes_local=1.0)])
    assert not _violations(rep, "fused-gather-bounded")


def test_wire_dtype_policy_fires():
    # codec mode with an unregistered policy and a frame no larger than
    # its own header: both structural checks fire
    bad = _record(fanout="vmap", wire="codec", codec_policy="fp7",
                  codec_nbytes=4)
    viol = _violations(run_contracts([bad]), "wire-dtype-policy")
    assert any("unregistered dtype policy" in v for v in viol)
    assert any("header" in v for v in viol)
    # a valid layout, but each client's message crosses the gather as a
    # 16 KiB f32 tree: the float-tree leak fires
    rows = [[[("torch.float32", 16384)], [("torch.float32", 4)]]] * 4
    leaky = _record(wire="codec", codec_policy="fp16", codec_nbytes=256,
                    num_clients=4, client_shards=1, rows=rows,
                    collectives=[_gather(4 * 16388, dtype="torch.uint8")])
    viol = _violations(run_contracts([leaky]), "wire-dtype-policy")
    assert any("not one uint8 frame" in v for v in viol)
    assert any("crossing the wire" in v for v in viol)
    # whole frames, but the gather carries more than the rows
    rows = [[[("torch.uint8", 256)], [("torch.float32", 4)]]] * 4
    extra = _record(wire="codec", codec_policy="fp32", codec_nbytes=256,
                    num_clients=4, client_shards=1, rows=rows,
                    collectives=[_gather(4 * 260 + 64, dtype="torch.uint8")])
    viol = _violations(run_contracts([extra]), "wire-dtype-policy")
    assert viol and "the rows pack" in viol[0]
    clean = _record(wire="codec", codec_policy="fp32", codec_nbytes=256,
                    num_clients=4, client_shards=1, rows=rows,
                    collectives=[_gather(4 * 260, dtype="torch.uint8")])
    assert not _violations(run_contracts([clean]), "wire-dtype-policy")


# ---------------------------------------------------------------------------
# lint negatives (synthetic {path: source} trees through the same rules)
# ---------------------------------------------------------------------------


def _lint_one(rule, files):
    trees = {p: ast.parse(s) for p, s in files.items()}
    return rule(files, trees)


def test_lint_broad_except_fires():
    src = ("def f():\n"
           "    try:\n"
           "        return 1\n"
           "    except Exception:\n"
           "        return None\n")
    _, viol = _lint_one(lint.check_untyped_except,
                        {"src/repro_torch/bad.py": src})
    assert viol and "broad except" in viol[0]
    _, viol = _lint_one(
        lint.check_untyped_except,
        {"src/repro_torch/ok.py": src.replace(
            "except Exception:", "except Exception:  # noqa: BLE001 why")})
    assert not viol


def test_lint_host_call_fires_only_when_reachable():
    src = ("import time\n"
           "\n"
           "def helper():\n"
           "    return time.time()\n"
           "\n"
           "def build_fl_round(loss_fn, strategy, run):\n"
           "    return helper()\n"
           "\n"
           "def host_side_logger():\n"
           "    return time.time()\n")
    _, viol = _lint_one(lint.check_host_calls, {"src/repro_torch/bad.py": src})
    assert any("time.time" in v and "helper" in v for v in viol)
    assert not any("host_side_logger" in v for v in viol)


# (source of the round-path helper, fires?)
RNG_CASES = {
    "global_draw": ("    return torch.randn(\n"
                    "        (3, 4),\n"
                    "        device=device)\n", True),
    "seeded_draw": ("    return torch.randn(\n"
                    "        (3, 4),\n"
                    "        generator=gen,\n"
                    "        device=device)\n", False),
    "global_randint": ("    return torch.randint(0, 5, (3,))\n", True),
    "inplace_draw": ("    x = torch.empty(3)\n"
                     "    x.normal_(\n"
                     "        0.0, 1.0)\n"
                     "    return x\n", True),
    "seeded_inplace": ("    return torch.empty(3).uniform_(generator=gen)\n",
                       False),
    "manual_seed": ("    torch.manual_seed(0)\n", True),
    "generator_seed": ("    return torch.Generator().manual_seed(0)\n",
                       False),
    "numpy_rng": ("    return np.random.default_rng(0).random()\n", True),
    "stdlib_random": ("    return random.random()\n", True),
    "datetime_now": ("    return datetime.datetime.now()\n", True),
    "from_datetime_now": ("    return dt.now()\n", True),
}


@pytest.mark.parametrize("case", sorted(RNG_CASES))
def test_lint_host_rng_and_clock(case):
    body, fires = RNG_CASES[case]
    src = ("import datetime\n"
           "import random\n"
           "from datetime import datetime as dt\n"
           "\n"
           "import numpy as np\n"
           "import torch\n"
           "\n"
           "def helper(gen, device):\n"
           + body +
           "\n"
           "class Mine(CompressionStrategy):\n"
           "    def client_encode(self, key, u, params):\n"
           "        return helper(key, None)\n")
    _, viol = _lint_one(lint.check_host_calls,
                        {"src/repro_torch/core/mine.py": src})
    assert bool(viol) == fires, viol
    if fires:
        assert "helper" in viol[0]


def test_lint_host_call_fires_on_the_real_round_path():
    """A global-RNG draw spread over two lines, planted in the real
    ``local_train`` (in memory): the rule reaches it from the roots."""
    files = lint.collect_sources()
    path = "src/repro_torch/fl/client.py"
    src = files[path]
    assert "def local_train(" in src, "local_train moved"
    body = src.index('"""', src.index("def local_train("))
    planted = (src[:body] + "_noise = torch.rand(\n        3)\n    "
               + src[body:])
    rep = lint.run_lint({**files, path: planted})
    viol = rep["rules"]["host-call-in-round-path"]["violations"]
    assert len(viol) == 1 and "torch.rand without generator=" in viol[0] \
        and "local_train" in viol[0], viol


def test_lint_registry_kind_fires():
    files = {
        "src/repro_torch/core/newstrat.py": (
            "from repro_torch.core import register_strategy\n"
            "@register_strategy('newkind')\n"
            "class NewStrat:\n"
            "    pass\n"),
        "src/repro_torch/comm/frame.py": "KIND_IDS = {'identity': 0}\n",
    }
    _, viol = _lint_one(lint.check_registry_kinds, files)
    assert viol and "newkind" in viol[0] and "KIND_IDS" in viol[0]


def test_lint_public_exports_fires():
    files = {"src/repro_torch/comm/__init__.py": "__all__ = ['a', 'b']\n"}
    trees = {p: ast.parse(s) for p, s in files.items()}
    _, viol = lint.check_public_exports(
        files, trees, golden={"repro_torch.comm": ["a"]})
    assert viol and "extra: ['b']" in viol[0]


def test_lint_clean_at_head():
    """The committed port holds its own invariants, every rule evaluating
    something — the gate scripts/check_static_torch.py enforces."""
    rep = lint.run_lint()
    assert rep["violations"] == 0, rep["rules"]
    for name, r in rep["rules"].items():
        assert r["evaluated"] > 0, name
    # the golden pins govern all four packages through their __all__
    assert rep["rules"]["public-api-exports"]["evaluated"] == 4


# ---------------------------------------------------------------------------
# the matrix at head
# ---------------------------------------------------------------------------


def _builtin(configs, registry, module):
    """The points of the kinds the package itself registers: other test
    files register toy kinds in the same worker process."""
    return [c for c in configs if registry[c["kind"]].__module__ == module]


def _head_matrix(fanout=None):
    from repro_torch.core.strategy import STRATEGIES
    return [c for c in _builtin(ir.iter_round_configs(), STRATEGIES,
                                "repro_torch.core.strategy")
            if fanout is None or c["fanout"] == fanout]


def test_matrix_is_the_references():
    from repro.analysis.ir import iter_round_configs as jconfigs
    from repro.core.strategy import STRATEGIES as JSTRATEGIES
    ours = _head_matrix()
    assert ours == _builtin(jconfigs(), JSTRATEGIES, "repro.core.strategy")
    assert len(ours) == 56


def test_contracts_clean_at_head_mesh_free():
    want = _head_matrix("vmap")
    rep = run_contracts(ir.run_matrix(want))
    assert rep["configs_evaluated"] == len(want) == 28
    assert rep["violations"] == 0, rep["contracts"]
    for name in ("client-scope-clean", "no-host-sync-in-client-scope",
                 "ef-donation-in-place", "wire-dtype-policy"):
        assert rep["contracts"][name]["evaluated"] > 0, name
    assert all(v == contracts.EXPECTED_HOST_SYNCS.get(k, 0)
               for k, v in rep["host_syncs_by_kind"].items())


@pytest.mark.transport(timeout=240)
def test_contracts_clean_at_head_sharded():
    """The sharded half on four gloo ranks: every contract evaluated on
    rank 0's records, clean on every rank."""
    want = _head_matrix("shard_map")
    records, peers = ir.run_sharded(want, timeout=200)
    rep = ir.merge_peers(run_contracts(records), peers)
    assert rep["configs_evaluated"] == len(want) == 28
    assert sorted(peers) == [1, 2, 3]
    assert rep["violations"] == 0, rep["contracts"]
    for name, c in rep["contracts"].items():
        assert c["evaluated"] > 0, name
    assert all(r.client_shards == 4 and len(r.rows) == 1 for r in records)
