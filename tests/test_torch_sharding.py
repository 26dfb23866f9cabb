"""The port's mesh and placement contract (``repro_torch.launch.mesh``,
``repro_torch.fl.sharding``, the trainer's ``make_fanout``), the mirror of
tests/test_sharding.py's fan-out units on the CPU.

The reference runs its multi-device half on 8 forced host devices in a
child process; the port runs each case on 2, 4 and 8 gloo ranks, spawned
once per world by ``_torch_fanout.run_ranks`` (the ranks' checks are
``_torch_fanout.scenario_sharding``). The in-process cases need no
process group.
"""
import argparse
import sys
import time

import pytest
import torch

from _torch_fanout import assert_check, run_ranks
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import Ranks, bits_equal, tree_bits_diff

torch.set_num_threads(2)

WORLDS = [2, 4, 8]
_RECORDS = {}


def _ranks(world, tmp_path_factory):
    """The ``sharding`` scenario on ``world`` ranks, run once per world."""
    if world not in _RECORDS:
        _RECORDS[world] = run_ranks(
            "sharding", world, tmp_path_factory.mktemp(f"sharding{world}"),
            timeout=240)
    return _RECORDS[world]


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("world", WORLDS)
def test_client_axes(world, tmp_path_factory):
    assert_check(_ranks(world, tmp_path_factory), "client_axes")


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("world", WORLDS)
def test_make_host_mesh_rejects_nondivisible_model(world, tmp_path_factory):
    """A truncated (n // model, model) mesh would silently drop devices —
    make_host_mesh must refuse instead."""
    assert_check(_ranks(world, tmp_path_factory),
                 "make_host_mesh_rejects_nondivisible_model")


def test_make_host_mesh_rejects_nondivisible_model_single_rank():
    """The same refusal in a one-rank job, before any process group."""
    with pytest.raises(ValueError, match="n % model"):
        make_host_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="n % model"):
        make_host_mesh(model=0, device="cpu")


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("world", WORLDS)
def test_fl_shardings_units_on_eight_devices(world, tmp_path_factory):
    """The FLShardings placement contract on 2, 4 and 8 ranks: replicated
    params, the EF and pool rows of each rank's contiguous block of
    clients, divisibility guards, and the gather in client order with its
    bytes exact (mixed dtypes, a frame of odd length)."""
    assert_check(_ranks(world, tmp_path_factory), "fl_shardings_units")


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("world", [4, 8])
def test_production_client_axes_flatten_pod_and_data(world,
                                                     tmp_path_factory):
    """The production mesh's client axes ("pod", "data"): one group over
    the flattened sub-mesh, cached, in (pod, data) block order."""
    assert_check(_ranks(world, tmp_path_factory), "pod_mesh")


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("world", WORLDS)
def test_run_config_shard_map_checks(world, tmp_path_factory):
    assert_check(_ranks(world, tmp_path_factory), "run_config")


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("world", WORLDS)
def test_production_mesh_refuses_a_smaller_job(world, tmp_path_factory):
    assert_check(_ranks(world, tmp_path_factory), "production_mesh")


def _args(clients, mode):
    return argparse.Namespace(clients=clients, client_parallel=mode)


def test_make_fanout_single_rank():
    """'auto' and 'vmap' give the single-process loop in a one-rank job;
    an explicit 'shard_map' raises, as the reference's "needs >1 device"
    does."""
    cpu = torch.device("cpu")
    assert train.make_fanout(_args(4, "auto"), cpu) == ("vmap", None, None)
    assert train.make_fanout(_args(4, "vmap"), cpu) == ("vmap", None, None)
    with pytest.raises(ValueError, match="needs >1 device"):
        train.make_fanout(_args(4, "shard_map"), cpu)


@pytest.mark.transport(timeout=300)
@pytest.mark.parametrize("world", WORLDS)
def test_make_fanout_on_ranks(world, tmp_path_factory):
    """On a world of several ranks 'auto' picks shard_map when the clients
    divide and falls back to the loop when they do not; an explicit
    'shard_map' on clients that do not divide raises."""
    assert_check(_ranks(world, tmp_path_factory), "make_fanout")


def test_trainer_flag_defaults_to_auto():
    assert train.parse_args([]).client_parallel == "auto"
    assert train.parse_args(["--client-parallel", "shard_map"]
                            ).client_parallel == "shard_map"
    with pytest.raises(SystemExit):
        train.parse_args(["--client-parallel", "pmap"])


def test_tree_bits_diff_compares_bits():
    """The ranks' bitwise comparison: -0.0 is not 0.0, a NaN equals only
    its own payload, dtype and shape count, numbers compare as f64."""
    z = torch.zeros(3)
    assert tree_bits_diff({"a": z, "b": 1.5}, {"a": z.clone(), "b": 1.5}) \
        is None
    assert tree_bits_diff({"a": z}, {"a": -z}) == "leaf 0 not bitwise equal"
    nan = torch.tensor([float("nan")])
    other = (nan.view(torch.int32) + 1).view(torch.float32)
    assert bits_equal(nan, nan.clone()) and not bits_equal(nan, other)
    assert not bits_equal(z, z.double()) and not bits_equal(z, z[:2])
    h = torch.tensor([1.0, -0.0]).to(torch.bfloat16)
    assert bits_equal(h, h.clone()) and not bits_equal(h, h.abs())
    assert not bits_equal(0.1, float(torch.tensor(0.1)))
    assert tree_bits_diff([z], [z, z]) == "1 leaves against 2"


def test_ranks_join_kills_past_the_deadline_and_after_a_failure(tmp_path):
    """``Ranks.join`` kills a rank that outlives its deadline, and the
    peers of a rank that failed once the grace has passed."""
    sleep = [sys.executable, "-c", "import time; time.sleep(120)"]
    fail = [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]
    t0 = time.monotonic()
    with Ranks([fail, sleep], [tmp_path / "0.log", tmp_path / "1.log"]) as r:
        rcs = r.join(timeout=60, grace=0.5)
    assert rcs[0] == 3 and rcs[1] < 0 and time.monotonic() - t0 < 30
    assert "boom" in r.log(0)
    with Ranks([sleep], [tmp_path / "2.log"]) as r:
        assert r.join(timeout=1.0)[0] < 0
