"""tests/test_models_smoke.py's 3SFC encode over every LM architecture of
``ARCH_IDS`` on the CPU: grad-of-grad through every family (attention,
MoE dispatch, SSD scan, RG-LRU scan, cross-attention), finite and exactly
decodable, and against the reference's encode from the same params,
target and syn0 at each smoke config in f32 (cosine and scale at rtol
1e-3, the server's decode at the reference's 1e-4/1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import CPU, batch_of, jax_batch, np_tree, port, reference

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.core import threesfc as jthreesfc
from repro.models import build as jbuild
from repro_torch.configs.base import ARCH_IDS
from repro_torch.convert import params_from_numpy
from repro_torch.core import threesfc
from repro_torch.core.threesfc import SynData
from repro_torch.core.tree import tree_leaves
from repro_torch.models import build

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_threesfc_encode(arch):
    """Grad-of-grad through every family (attention, MoE dispatch, SSD
    scan, RG-LRU scan, cross-attention): finite and exactly decodable; and
    against the reference's encode from the same params, target and
    syn0."""
    jm, jp = reference(arch)
    model, tp = port(arch)
    batch = batch_of(arch, 7)
    jg = np_tree(jax.grad(jm.loss)(jp, jax_batch(batch)))
    jspec = jbuild.syn_spec_for(jm.cfg, JCompressorConfig(syn_batch=1,
                                                          syn_seq=4))
    syn0 = np_tree(jthreesfc.init_syn(jax.random.PRNGKey(0), jspec))
    jres = jthreesfc.encode(jbuild.syn_loss_fn(jm), jp, jg,
                            jthreesfc.SynData(*map(jnp.asarray, syn0)),
                            steps=2, lr=0.1)
    lf = build.syn_loss_fn(model)
    res = threesfc.encode(lf, tp, params_from_numpy(jg, CPU),
                          SynData(*[torch.tensor(a) for a in syn0]),
                          steps=2, lr=0.1)
    assert np.isfinite(float(res.cosine)) and np.isfinite(float(res.s))
    np.testing.assert_allclose(float(res.cosine), float(jres.cosine),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(res.s), float(jres.s), rtol=1e-3)
    server = threesfc.decode(lf, tp, res.syn, res.s)
    for a, b in zip(tree_leaves(res.recon), tree_leaves(server)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
