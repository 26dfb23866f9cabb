"""Shared pieces of the per-architecture parity tests
(tests/test_torch_lm_families.py, tests/test_torch_lm_serving.py,
tests/test_torch_lm_families_fl.py): the reference's smoke model and params
per arch, the port's model on the same params, seeded inputs and the tree
comparison. Tolerances: rtol/atol 1e-4 for the model's numbers
(tests/test_torch_lm.py's block bound), 2e-3 for the serving contract
(tests/test_serving.py), and the round bounds of
tests/test_torch_lm_round.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.models import build as jbuild
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.models import build

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
EF_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 16
DECODE_STEPS = 3
# tests/test_serving.py's families and prompt
FAMS = ["tinyllama-1.1b", "qwen1.5-0.5b", "qwen3-moe-30b-a3b", "mamba2-370m",
        "recurrentgemma-2b"]
T = 12
ROUND_ARCHS = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "recurrentgemma-2b",
               "seamless-m4t-medium"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jcfg(arch, **kw):
    return jbase.get_smoke_config(arch).replace(dtype="float32", **kw)


def cfg_of(arch, **kw):
    return get_smoke_config(arch).replace(dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def reference(arch):
    jm = jbuild.build_model(jcfg(arch))
    return jm, np_tree(jm.init(jax.random.PRNGKey(0)))


def port(arch):
    _, jp = reference(arch)
    return build.build_model(cfg_of(arch)), params_from_numpy(jp, CPU)


def batch_of(arch, seed=1, b=B, s=S):
    """tokens (+ an enc-dec model's frames or a VLM's prefix embeddings)."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.enc_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.num_mm_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.num_mm_tokens:
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.num_mm_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def close_trees(got, want, **tol):
    g, w = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), **(tol or TOL))


def value_and_grad(fn, params):
    leaves, treedef = tree_flatten(params)
    w = [p.detach().requires_grad_(True) for p in leaves]
    v = fn(tree_unflatten(treedef, w))
    g = torch.autograd.grad(v, w, allow_unused=True, materialize_grads=True)
    return v.detach(), tree_unflatten(treedef, list(g))
