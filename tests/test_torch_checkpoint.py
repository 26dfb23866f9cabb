"""The port's durable checkpoints: the mirror of tests/test_checkpoint.py
(atomic round-trips over awkward trees, typed failure modes, the versioned
step index, crash-mid-write survival, the ledger snapshot that resumes
round numbering) and of test_misc_substrate::test_checkpoint_roundtrip for
``repro_torch.checkpoint``, and the cross-package parity: a recovery point
either package writes loads bitwise in the other, with the same
``arrays.npz`` keys and the same manifests."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import (CheckpointManager as JCheckpointManager,
                              load_arrays as jload_arrays,
                              load_fl_checkpoint as jload_fl_checkpoint,
                              load_manifest as jload_manifest,
                              save_fl_checkpoint as jsave_fl_checkpoint)
from repro.fl.round import FLState as JFLState
from repro.fl.round import fl_init as jfl_init
from repro_torch.checkpoint import (MANIFEST_VERSION, CheckpointError,
                                    CheckpointKeyError, CheckpointManager,
                                    CheckpointMissingError,
                                    CheckpointShapeError,
                                    CheckpointVersionError, load_arrays,
                                    load_checkpoint, load_fl_checkpoint,
                                    load_manifest, save_checkpoint,
                                    save_fl_checkpoint)
from repro_torch.comm.channel import InProcessChannel
from repro_torch.convert import params_from_numpy
from repro_torch.core import flat
from repro_torch.core.tree import tree_leaves
from repro_torch.fl.round import FLState, fl_init

CPU = torch.device("cpu")

torch.set_num_threads(2)


def _bits(x) -> np.ndarray:
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return a


def _tree_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _zeros_like(tree):
    """A target structure: zero tensors, 0 for the int round counter,
    numpy zeros of a numpy leaf's dtype."""
    def zero(l):
        if isinstance(l, torch.Tensor):
            return torch.zeros_like(l)
        if isinstance(l, int):
            return 0
        return np.zeros_like(np.asarray(l))
    return flat.tree_map(zero, tree)


# ---------------------------------------------------------------------------
# single-checkpoint round-trips
# ---------------------------------------------------------------------------


def test_ragged_nested_tree_roundtrips_bitwise(tmp_path):
    """Mixed container kinds, ragged shapes, mixed dtypes, 0-d scalars —
    everything comes back bitwise in the target structure's dtypes."""
    rng = np.random.default_rng(0)
    tree = {
        "w": (torch.as_tensor(rng.normal(size=(7, 3)), dtype=torch.float32),
              torch.as_tensor(rng.normal(size=(3,)), dtype=torch.float32)),
        "counts": [torch.arange(5, dtype=torch.int32),
                   torch.as_tensor(rng.integers(0, 9, size=(2, 2)))],
        "mask": torch.tensor([True, False, True]),
        "scalar": torch.tensor(0.125, dtype=torch.float32),   # 0-d leaf
        "wide": torch.tensor(3.0, dtype=torch.float64),       # f64 leaf
        "host": np.float64(2.5),                              # numpy leaf
    }
    p = save_checkpoint(str(tmp_path / "ck"), tree, meta={"round": 7})
    like = _zeros_like(tree)
    out = load_checkpoint(p, like)
    assert _tree_equal(tree, out)
    for got, want in zip(tree_leaves(out), tree_leaves(like)):
        assert got.dtype == want.dtype
    assert load_manifest(p)["meta"] == {"round": 7}


def test_bf16_leaves_roundtrip_exactly_via_f32_storage(tmp_path):
    """bf16 has no npz representation: leaves are widened to f32 (exact)
    and cast back on load, bit for bit."""
    vals = torch.tensor([1.0, -2.5, 3.0e-20, 65280.0, 1.0 / 3.0],
                        dtype=torch.bfloat16)
    p = save_checkpoint(str(tmp_path / "ck"), {"p": vals})
    flat_, _ = load_arrays(p)
    assert flat_["p"].dtype == np.float32           # storage is f32
    out = load_checkpoint(p, {"p": torch.zeros_like(vals)})
    assert out["p"].dtype == torch.bfloat16
    assert torch.equal(out["p"].view(torch.int16), vals.view(torch.int16))


def test_bare_array_tree_uses_root_key(tmp_path):
    arr = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    p = save_checkpoint(str(tmp_path / "ck"), arr)
    flat_, _ = load_arrays(p)
    assert set(flat_) == {"_root"}
    out = load_checkpoint(p, torch.zeros_like(arr))
    assert torch.equal(out, arr)


# ---------------------------------------------------------------------------
# typed failure modes
# ---------------------------------------------------------------------------


def test_missing_checkpoint_is_typed_file_not_found(tmp_path):
    with pytest.raises(CheckpointMissingError) as ei:
        load_checkpoint(str(tmp_path / "nope"), {"a": torch.zeros(2)})
    assert isinstance(ei.value, FileNotFoundError)
    assert isinstance(ei.value, CheckpointError)


def test_missing_leaf_is_typed_key_error(tmp_path):
    p = save_checkpoint(str(tmp_path / "ck"), {"a": torch.zeros(2)})
    with pytest.raises(CheckpointKeyError) as ei:
        load_checkpoint(p, {"a": torch.zeros(2), "b": torch.zeros(3)})
    assert isinstance(ei.value, KeyError)


def test_shape_and_dtype_mismatch_are_typed_value_errors(tmp_path):
    p = save_checkpoint(str(tmp_path / "ck"),
                        {"a": torch.zeros((2, 3), dtype=torch.float32)})
    with pytest.raises(CheckpointShapeError):
        load_checkpoint(p, {"a": torch.zeros((3, 2), dtype=torch.float32)})
    with pytest.raises(CheckpointShapeError) as ei:
        load_checkpoint(p, {"a": torch.zeros((2, 3), dtype=torch.int32)})
    assert isinstance(ei.value, ValueError)


def test_future_manifest_version_is_rejected(tmp_path):
    p = save_checkpoint(str(tmp_path / "ck"), {"a": torch.zeros(2)})
    mpath = os.path.join(p, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["version"] = MANIFEST_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointVersionError):
        load_checkpoint(p, {"a": torch.zeros(2)})


def test_future_index_version_is_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.save(1, {"a": torch.zeros(2)})
    ipath = os.path.join(mgr.root, "MANIFEST.json")
    with open(ipath) as f:
        idx = json.load(f)
    idx["version"] = MANIFEST_VERSION + 1
    with open(ipath, "w") as f:
        json.dump(idx, f)
    with pytest.raises(CheckpointVersionError):
        mgr.latest()


def test_corrupt_manifest_json_is_missing_not_crash(tmp_path):
    p = save_checkpoint(str(tmp_path / "ck"), {"a": torch.zeros(2)})
    with open(os.path.join(p, "manifest.json"), "w") as f:
        f.write('{"version": 1, "leaves"')       # truncated write w/o rename
    with pytest.raises(CheckpointMissingError):
        load_checkpoint(p, {"a": torch.zeros(2)})


# ---------------------------------------------------------------------------
# versioned step index: retention, commit point, crash-mid-write
# ---------------------------------------------------------------------------


def test_manager_retention_prunes_oldest_after_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.full((3,), float(s))})
    assert mgr.steps() == [3, 4] and mgr.latest() == 4
    assert not os.path.exists(mgr.path(1))
    assert not os.path.exists(mgr.path(2))
    tree, _ = mgr.load({"a": torch.zeros(3)})
    assert torch.equal(tree["a"], torch.full((3,), 4.0))
    tree, _ = mgr.load({"a": torch.zeros(3)}, step=3)
    assert torch.equal(tree["a"], torch.full((3,), 3.0))


def test_crash_mid_payload_write_leaves_previous_loadable(tmp_path):
    """A kill while step 4's payload was being written (dir + arrays.npz,
    no manifest, no index entry) leaves latest() naming step 2, and a
    retried save over the debris succeeds."""
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.save(2, {"a": torch.full((3,), 2.0)}, meta={"round": 2})
    debris = mgr.path(4)
    os.makedirs(debris)
    with open(os.path.join(debris, "arrays.npz"), "wb") as f:
        f.write(b"PK\x03\x04 partial zip the crash truncated")
    assert mgr.latest() == 2
    tree, meta = mgr.load({"a": torch.zeros(3)})
    assert meta["round"] == 2
    with pytest.raises(CheckpointMissingError):
        mgr.load({"a": torch.zeros(3)}, step=4)    # never committed
    mgr.save(4, {"a": torch.full((3,), 4.0)}, meta={"round": 4})
    assert mgr.latest() == 4
    tree, _ = mgr.load({"a": torch.zeros(3)}, step=4)
    assert torch.equal(tree["a"], torch.full((3,), 4.0))


def test_crash_before_index_commit_leaves_step_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.save(2, {"a": torch.full((3,), 2.0)})
    save_checkpoint(mgr.path(6), {"a": torch.full((3,), 6.0)})  # no index
    assert mgr.latest() == 2 and mgr.steps() == [2]
    with pytest.raises(CheckpointMissingError):
        mgr.load({"a": torch.zeros(3)}, step=6)


def test_stray_index_tmp_is_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    mgr.save(2, {"a": torch.zeros(3)})
    with open(os.path.join(mgr.root, "MANIFEST.json.tmp"), "w") as f:
        f.write('{"version": 1, "steps": [2, 9')
    assert mgr.latest() == 2


def test_empty_manager_raises_missing(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "root"))
    assert mgr.latest() is None and mgr.steps() == []
    with pytest.raises(CheckpointMissingError):
        mgr.load({"a": torch.zeros(2)})


# ---------------------------------------------------------------------------
# full-FLState recovery points
# ---------------------------------------------------------------------------


def _params_np():
    return {"w": np.random.default_rng(1).normal(size=(4, 2))
            .astype(np.float32), "b": np.zeros((2,), np.float32)}


def _fl_state(staleness_max: int) -> FLState:
    params = params_from_numpy(_params_np(), CPU)
    state = fl_init(params, 3, None, staleness_max=staleness_max)
    # every component non-trivial, so bitwise equality means something
    bump = flat.tree_map(
        lambda l: l + torch.arange(l.numel(), dtype=l.dtype).reshape(
            l.shape) if isinstance(l, torch.Tensor)
        and l.is_floating_point() else l, state)
    return bump._replace(round=5)


@pytest.mark.parametrize("staleness_max", [0, 2])
def test_fl_checkpoint_roundtrips_state_bank_and_meta(tmp_path,
                                                      staleness_max):
    state = _fl_state(staleness_max)
    bank = {0: (5, np.arange(10, dtype=np.float32)),
            2: (4, np.linspace(-1, 1, 10).astype(np.float32))}
    mgr = CheckpointManager(str(tmp_path / "root"))
    save_fl_checkpoint(mgr, 5, state,
                       ledger={"uplink": {"total_bytes": 123}},
                       history=[{"round": 4,
                                 "delivered": [True, False, True]}],
                       ef_bank=bank, extra={"transport": "socket"})
    got, got_bank, meta = load_fl_checkpoint(mgr, _zeros_like(state))
    assert _tree_equal(state, got)
    assert got.round == 5 and isinstance(got.round, int)
    assert set(got_bank) == {0, 2}
    for cid in bank:
        assert got_bank[cid][0] == bank[cid][0]
        np.testing.assert_array_equal(got_bank[cid][1], bank[cid][1])
    assert meta["round"] == 5 and meta["transport"] == "socket"
    assert meta["ledger"]["uplink"]["total_bytes"] == 123
    assert meta["history"][0]["delivered"] == [True, False, True]


def test_fl_checkpoint_structure_mismatch_is_typed(tmp_path):
    """A buffer-less checkpoint refuses to load into a state that expects
    the staleness ring buffer — typed error, not garbage buffers."""
    mgr = CheckpointManager(str(tmp_path / "root"))
    save_fl_checkpoint(mgr, 5, _fl_state(0))
    with pytest.raises(CheckpointError):
        load_fl_checkpoint(mgr, _zeros_like(_fl_state(2)))


def test_channel_ledger_restore_resumes_round_numbering():
    ch = InProcessChannel()
    for _ in range(3):
        ch.begin_round()
        ch.send_up(np.zeros((17,), np.uint8))
        ch.send_down(np.zeros((5,), np.uint8))
    led = ch.ledger()
    assert led["uplink"]["per_round"] == [17, 17, 17]
    assert led["uplink"]["total_bytes"] == 51 \
        and led["uplink"]["messages"] == 3
    fresh = InProcessChannel()
    fresh.restore_ledger(json.loads(json.dumps(led)))   # via JSON, like a ckpt
    assert fresh.begin_round() == 3                     # continues
    fresh.send_up(np.zeros((17,), np.uint8))
    assert fresh.uplink.per_round == [17, 17, 17, 17]
    assert fresh.uplink.total_bytes == 68
    assert fresh.downlink.per_round == [5, 5, 5, 0]


def test_checkpoint_roundtrip(tmp_path):
    """The mirror of test_misc_substrate::test_checkpoint_roundtrip: a
    bf16 leaf and a 0-d integer leaf in a nested tree."""
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)},
            "t": (torch.zeros((2,)), torch.tensor(3))}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tree, meta={"round": 7})
    out = load_checkpoint(path, _zeros_like(tree))
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert torch.equal(a.float(), b.float())
    assert out["nested"]["b"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# cross-package parity: one on-disk format
# ---------------------------------------------------------------------------


def _j_state(staleness_max: int) -> JFLState:
    """The reference's state of ``_fl_state``'s values."""
    params = {k: jnp.asarray(v) for k, v in _params_np().items()}
    st = jfl_init(params, 3, None, staleness_max=staleness_max)
    port = _fl_state(staleness_max)
    fields = [flat.tree_map(lambda l: jnp.asarray(l.numpy()), x)
              if x is not None else None
              for x in (port.params, port.ef, None, port.buf, port.buf_w)]
    return st._replace(params=fields[0], ef=fields[1],
                       round=jnp.asarray(5, st.round.dtype),
                       buf=fields[3], buf_w=fields[4])


def _j_zeros(state: JFLState) -> JFLState:
    import jax
    return jax.tree_util.tree_map(jnp.zeros_like, state)


@pytest.mark.parametrize("staleness_max", [0, 2])
def test_reference_recovery_point_loads_bitwise_in_the_port(tmp_path,
                                                            staleness_max):
    bank = {1: (4, np.linspace(-2, 2, 10).astype(np.float32))}
    jmgr = JCheckpointManager(str(tmp_path / "ref"))
    jsave_fl_checkpoint(jmgr, 5, _j_state(staleness_max), ef_bank=bank,
                        ledger={"uplink": {"total_bytes": 7}},
                        extra={"transport": "inproc"})
    mgr = CheckpointManager(str(tmp_path / "ref"))
    got, got_bank, meta = load_fl_checkpoint(
        mgr, _zeros_like(_fl_state(staleness_max)))
    assert _tree_equal(got, _fl_state(staleness_max))
    assert got.round == 5
    assert got_bank[1][0] == 4
    np.testing.assert_array_equal(got_bank[1][1], bank[1][1])
    assert meta["ledger"] == {"uplink": {"total_bytes": 7}}


@pytest.mark.parametrize("staleness_max", [0, 2])
def test_port_recovery_point_loads_bitwise_in_the_reference(tmp_path,
                                                            staleness_max):
    bank = {1: (4, np.linspace(-2, 2, 10).astype(np.float32))}
    mgr = CheckpointManager(str(tmp_path / "port"))
    save_fl_checkpoint(mgr, 5, _fl_state(staleness_max), ef_bank=bank)
    jmgr = JCheckpointManager(str(tmp_path / "port"))
    jstate = _j_state(staleness_max)
    got, got_bank, meta = jload_fl_checkpoint(jmgr, _j_zeros(jstate))
    import jax
    la = jax.tree_util.tree_leaves(got)
    lb = jax.tree_util.tree_leaves(jstate)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got.round) == 5
    np.testing.assert_array_equal(got_bank[1][1], bank[1][1])


@pytest.mark.parametrize("staleness_max", [0, 2])
def test_both_packages_write_the_same_keys_and_manifests(tmp_path,
                                                         staleness_max):
    bank = {0: (3, np.ones(10, np.float32))}
    mgr = CheckpointManager(str(tmp_path / "port"))
    save_fl_checkpoint(mgr, 5, _fl_state(staleness_max), ef_bank=bank,
                       history=[{"round": 4}])
    jmgr = JCheckpointManager(str(tmp_path / "ref"))
    jsave_fl_checkpoint(jmgr, 5, _j_state(staleness_max), ef_bank=bank,
                        history=[{"round": 4}])
    pf, pm = load_arrays(mgr.path(5))
    jf, jm = jload_arrays(jmgr.path(5))
    assert sorted(pf) == sorted(jf)
    assert "state/round" in pf and pf["state/round"].dtype == np.int32 \
        and pf["state/round"].shape == ()
    assert {k for k in pf if k.startswith("state/ef/")} \
        == {"state/ef/b", "state/ef/w"}
    for k in pf:
        np.testing.assert_array_equal(pf[k], jf[k])
        assert pf[k].dtype == jf[k].dtype
    assert pm == jm == jload_manifest(jmgr.path(5))
    with open(os.path.join(mgr.root, "MANIFEST.json")) as f, \
            open(os.path.join(jmgr.root, "MANIFEST.json")) as g:
        assert json.load(f) == json.load(g)
