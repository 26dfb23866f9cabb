"""The parameter sharding rules (``repro_torch.models.params``) against the
JAX package's, leaf by leaf: for every arch of ``ARCH_IDS`` at its smoke
and its published config, on the (2, 2), (1, 4), (16, 16), (2, 16, 16)
and (4, 64) meshes ((4, 64) is the reshape on which 16 experts do not
divide the model axis, so the MoE rules fall back to the per-expert ff
dim), without and with a leading client axis, and with the q/k/v head_dim
fallback off. The reference reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stub mesh serves it; its shapes come from
``jax.eval_shape`` and the port's from its init under a ``FakeTensorMode``.
Nothing is spawned and nothing is allocated. Also the mirror of
tests/test_sharding.py::test_param_specs_rank_and_divisibility, and
``model_placement``'s mapping of a spec onto the model sub-mesh."""
import functools
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as jbase
from repro.models import build as jbuild
from repro.models import params as jparams
from repro_torch.configs import base as cbase
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.models import build
from repro_torch.models import params as P_

torch.set_num_threads(2)

MESHES = {
    "2x2": (("data", "model"), (2, 2)),
    "1x4": (("data", "model"), (1, 4)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "4x64": (("data", "model"), (4, 64)),
}
CONFIGS = ("smoke", "published")
VARIANTS = ("params", "client_axis", "no_qk_hd")


@pytest.fixture(autouse=True)
def _fallback_reset():
    yield
    P_.set_qk_hd_fallback(True)
    jparams.set_qk_hd_fallback(True)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str, which: str):
    get = jbase.get_smoke_config if which == "smoke" else jbase.get_config
    model = jbuild.build_model(get(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch: str, which: str):
    get = cbase.get_smoke_config if which == "smoke" else cbase.get_config
    model = build.build_model(get(arch))
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
    return params


def _client_axes(names):
    return tuple(a for a in names if a != "model")


def _lead(tree, n, shape_of):
    """``tree``'s leaves as shapes with a leading client axis of ``n``."""
    return [(path, (n, *shape_of(leaf))) for path, leaf in tree]


def _ref_specs(arch, which, mesh_key, variant):
    names, shape = MESHES[mesh_key]
    stub = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    shapes = _ref_shapes(arch, which)
    client = None
    if variant == "client_axis":
        client = _client_axes(names)
        n = math.prod(s for a, s in zip(names, shape) if a in client)
        shapes = jax.tree_util.tree_map(
            lambda sd: jax.ShapeDtypeStruct((n, *sd.shape), sd.dtype), shapes)
    jparams.set_qk_hd_fallback(variant != "no_qk_hd")
    specs = jparams.sharding_specs(shapes, stub, client_axis=client)
    flat = jax.tree_util.tree_flatten_with_path(specs,
                                                is_leaf=lambda x: isinstance(
                                                    x, jax.sharding.PartitionSpec))[0]
    return {jparams._path_str(p): tuple(s) for p, s in flat}


def _port_specs(arch, which, mesh_key, variant):
    names, shape = MESHES[mesh_key]
    sizes = dict(zip(names, shape))
    params = _port_shapes(arch, which)
    client = None
    if variant == "client_axis":
        client = _client_axes(names)
        n = math.prod(sizes[a] for a in client)
        params = {"_": params}
        lead = [SimpleNamespace(shape=(n, *leaf.shape))
                for leaf in tree_leaves(params)]
        params = _rebuild(params["_"], lead)
    P_.set_qk_hd_fallback(variant != "no_qk_hd")
    specs = P_.sharding_specs(params, sizes, client_axis=client)
    return {"/".join(map(str, p)): tuple(s)
            for p, s in tree_leaves_with_path(specs)}


def _rebuild(tree, leaves):
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    return tree_unflatten(tree_flatten(tree)[1], leaves)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("which", CONFIGS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch, which, mesh_key, variant):
    """The port's spec tree is the reference's, leaf by leaf, tuple for
    tuple, under the same paths."""
    ref = _ref_specs(arch, which, mesh_key, variant)
    got = _port_specs(arch, which, mesh_key, variant)
    assert sorted(got) == sorted(ref)
    diff = {k: (got[k], ref[k]) for k in ref if got[k] != ref[k]}
    assert not diff, diff


def test_moe_fallback_on_the_reshaped_mesh():
    """On (4, 64) the 16 experts do not divide the model axis: expert
    weights shard their per-expert ff dim instead, never replicate."""
    specs = _port_specs("llama4-scout-17b-a16e", "published", "4x64",
                        "params")
    moe = {k: v for k, v in specs.items() if "/moe/w_" in k}
    assert moe and all("model" in v for v in moe.values()), moe
    assert specs["layers/0/moe/w_in"] == (None, None, None, "model")
    assert specs["layers/0/moe/w_out"] == (None, None, "model", None)
    # the shared expert matches no rule and replicates, as the reference
    shared = [v for k, v in specs.items() if "/moe/shared/" in k]
    assert shared and all(v == (None,) * len(v) for v in shared)


def test_param_specs_rank_and_divisibility():
    """The mirror of the reference's test: every spec has at most the
    leaf's rank, and every sharded dim divides by its axes' sizes."""
    sizes = {"data": 2, "model": 2}
    for arch in ("tinyllama-1.1b", "qwen3-moe-30b-a3b", "mamba2-370m",
                 "recurrentgemma-2b"):
        params = _port_shapes(arch, "smoke")
        specs = P_.sharding_specs(params, sizes)
        for (_, leaf), (_, sp) in zip(tree_leaves_with_path(params),
                                      tree_leaves_with_path(specs)):
            assert len(sp) <= len(leaf.shape), (leaf.shape, sp)
            for dim, ax in zip(leaf.shape, tuple(sp) + (None,) * 8):
                if ax is not None:
                    axs = ax if isinstance(ax, tuple) else (ax,)
                    assert dim % math.prod(sizes[a] for a in axs) == 0, (
                        leaf.shape, sp)


def test_model_placement():
    """A spec onto the 1-D model sub-mesh: ``Shard`` where it names
    ``model`` (alone or in a tuple), ``Replicate`` elsewhere; the client
    axes are never the model's."""
    assert P_.model_placement(P_.P(None, "model")) == Shard(1)
    assert P_.model_placement(P_.P("model", None)) == Shard(0)
    assert P_.model_placement(P_.P(("pod", "data"), None, "model")) == Shard(2)
    assert P_.model_placement(P_.P(("data",), None)) == Replicate()
    assert P_.model_placement(P_.P()) == Replicate()
    assert P_.P(("data",), None) == ("data", None)
    assert P_.P(("pod", "data")) == (("pod", "data"),)
