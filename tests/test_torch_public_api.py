"""The port's public API: the exported names of its four runtime packages.

Mirror of tests/test_public_api.py. ``GOLDEN`` pins, for each of
``repro_torch.core``, ``repro_torch.fl``, ``repro_torch.comm`` and
``repro_torch.configs``, exactly the names the reference test pins for its
counterpart (held equal below, read from the reference test with ``ast``),
counted by the reference's rule: public attributes, no submodules. The
lint's ``public-api-exports`` rule reads this literal. Also pins the two
deprecated shims (one ``DeprecationWarning`` per process each, and a
working round after it) and ``RunConfig``'s validation and JSON round
trip.
"""
import ast
import os
import types
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))

GOLDEN = {
    "repro_torch.core": [
        "CompressionStrategy", "make_strategy", "register_strategy",
        "strategy_kinds",
    ],
    "repro_torch.fl": [
        "ClientPools", "DeliveryReport", "EngineStats", "FLShardings",
        "FLState", "FaultSchedule", "LiveRoundLoop", "RetryPolicy",
        "RoundEngine", "aggregate", "build_fl_round", "device_pools",
        "fault_schedule", "fl_init", "fl_round", "local_train",
        "make_fl_round", "make_fl_shardings", "matched_compressors",
        "null_schedule", "payload_budget", "residual_mass_conserved",
        "server_update", "token_batcher", "vision_batcher",
    ],
    "repro_torch.comm": [
        "CODECS", "Channel", "Codec", "FaultyChannel", "FrameError",
        "FrameSpec", "InProcessChannel", "LinkStats", "ProtocolError",
        "ServerLink", "SocketServer", "make_codec", "parse_header",
        "register_codec", "register_kind_id", "spawn_local_workers",
        "wire_bytes",
    ],
    "repro_torch.configs": [
        "ARCH_IDS", "CompressorConfig", "FLConfig", "INPUT_SHAPES",
        "ModelConfig", "RunConfig", "ShapeConfig", "get_config",
        "get_smoke_config", "list_archs",
    ],
}


def _public_names(mod) -> list:
    """Public attributes that are not modules; ``dir`` so that a name a
    package loads on first use counts as the attribute it is."""
    return sorted(n for n in dir(mod)
                  if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType))


@pytest.mark.parametrize("modname", sorted(GOLDEN))
def test_exported_names_pinned(modname):
    import importlib

    mod = importlib.import_module(modname)
    actual = _public_names(mod)
    assert actual == GOLDEN[modname], (
        f"{modname} exports changed; update the golden list DELIBERATELY "
        f"(added: {sorted(set(actual) - set(GOLDEN[modname]))}, "
        f"removed: {sorted(set(GOLDEN[modname]) - set(actual))})")
    # the package's __all__ is the same surface (the lint reads it)
    assert sorted(mod.__all__) == GOLDEN[modname]


def test_golden_is_the_references_pin():
    """Every pinned surface is the reference's, package for package."""
    with open(os.path.join(HERE, "test_public_api.py")) as f:
        tree = ast.parse(f.read())
    ref = next(ast.literal_eval(n.value) for n in tree.body
               if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "GOLDEN" for t in n.targets))
    assert GOLDEN == {k.replace("repro.", "repro_torch.", 1): v
                      for k, v in ref.items()}


def test_builtin_strategy_kinds_pinned():
    from repro_torch.core.strategy import STRATEGIES

    builtin = {"identity", "topk", "randk", "signsgd", "stc", "threesfc",
               "fedsynth"}
    assert builtin <= set(STRATEGIES), sorted(STRATEGIES)


def test_shape_config_and_archs_are_the_references():
    from repro.configs import base as jbase

    from repro_torch.configs import INPUT_SHAPES, ShapeConfig, list_archs

    assert list_archs() == jbase.list_archs()
    assert list(INPUT_SHAPES) == list(jbase.INPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert isinstance(shape, ShapeConfig)
        ref = jbase.INPUT_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.mode) \
            == (ref.name, ref.seq_len, ref.global_batch, ref.mode)


def _one_warning_only(fn):
    """Call ``fn`` twice; return the DeprecationWarnings raised in total."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn()
        fn()
    return [w for w in rec if issubclass(w.category, DeprecationWarning)]


def test_deprecated_shims_warn_exactly_once():
    from repro_torch.configs.base import CompressorConfig, FLConfig
    from repro_torch.core import strategy as S
    from repro_torch.core.compressor import make_compressor
    from repro_torch.fl import fl_round, make_fl_round
    from repro_torch.fl.round import fl_init
    from repro_torch.models.cnn import VisionSpec, make_paper_model

    assert fl_round is make_fl_round
    model = make_paper_model("mlp", VisionSpec("tiny", (4, 4, 1), 3))
    ccfg = CompressorConfig(kind="topk", keep_ratio=0.2)
    cfg = FLConfig(num_clients=2, compressor=ccfg)

    # reset the once-latch: earlier tests in the session may have tripped it
    S._DEPRECATION_SEEN.clear()
    ws = _one_warning_only(lambda: make_compressor(ccfg))
    assert len(ws) == 1 and "make_compressor" in str(ws[0].message), ws

    comp = make_compressor(ccfg)
    ws = _one_warning_only(lambda: make_fl_round(model.loss, comp, cfg))
    assert len(ws) == 1 and "make_fl_round" in str(ws[0].message), ws

    # the shims still produce a working round function
    rf = make_fl_round(model.loss, comp, cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batches = {
        "x": torch.from_numpy(
            rng.standard_normal((2, 1, 4, 4, 4, 1)).astype(np.float32)),
        "y": torch.from_numpy(rng.integers(0, 3, (2, 1, 4))),
    }
    state, m = rf(fl_init(params, 2), batches, 3)
    assert np.isfinite(float(m.loss)) and state.round == 1


def test_run_config_validates_and_roundtrips():
    import json

    from repro_torch.configs import CompressorConfig, FLConfig, RunConfig

    with pytest.raises(ValueError, match="'float' or 'codec'"):
        RunConfig(wire="bytes")
    with pytest.raises(ValueError, match="'vmap' or 'shard_map'"):
        RunConfig(client_parallel="pmap")
    with pytest.raises(ValueError, match="requires an explicit mesh"):
        RunConfig(client_parallel="shard_map")
    with pytest.raises(ValueError, match="num_micro"):
        RunConfig(num_micro=0)
    with pytest.raises(ValueError, match="participation_rate"):
        RunConfig(participation_rate=0.0)
    with pytest.raises(ValueError, match="drop_rate"):
        RunConfig(drop_rate=1.0)
    with pytest.raises(ValueError, match="staleness_max"):
        RunConfig(staleness_max=-1)
    with pytest.raises(ValueError, match="requires staleness_max"):
        RunConfig(straggler_rate=0.5)
    with pytest.raises(ValueError, match="fused_decode is incompatible"):
        RunConfig(fused_decode=True, staleness_max=2)

    run = RunConfig(
        fl=FLConfig(num_clients=4, local_steps=2, local_lr=0.05,
                    compressor=CompressorConfig(kind="stc", keep_ratio=0.1)),
        wire="codec", fused_decode=False, num_micro=2,
        participation_rate=0.7, drop_rate=0.3, straggler_rate=0.25,
        staleness_max=2, fault_seed=11)
    assert run.has_faults
    back = RunConfig.from_json(json.loads(json.dumps(run.to_json())))
    assert back == run
    assert back.fl.compressor.kind == "stc"
    assert back.staleness_max == 2 and back.fault_seed == 11
    assert not RunConfig().has_faults
    assert not RunConfig.from_json(
        json.loads(json.dumps(RunConfig().to_json()))).has_faults
