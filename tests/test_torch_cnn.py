"""Port parity for the paper's four CNNs (``repro_torch.models.cnn``) and
their conv layer (``models.layers.conv2d``), on the CPU.

At the published widths on each model's paper dataset the parameter and
leaf counts equal the reference's. At narrow widths and 8x8 images the
reference's params are carried across (``convert.params_from_numpy``) and
the port's logits, ∇_w of the loss and one 3SFC encode are held to the
reference's (``repro.models.cnn``; its 3SFC stats through the Pallas kernel
in interpret mode). The tolerances are the cross-framework gap: XLA's and
PyTorch's CPU convolutions and matrix products sum in other orders, about
1e-7 relative per output, so logits are held to rtol 1e-5, gradients
(one backward, a few such sums deep) to rtol 1e-4, and the encoder's
results (2 grad-of-grad steps, as tests/test_torch_threesfc.py) to rtol
1e-4 with an absolute floor of 1e-5 of the tree's largest element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CompressorConfig as JCompressorConfig
from repro.core import threesfc as jthreesfc
from repro.models import cnn as jcnn
from repro.models import layers as jlayers
from repro.models.build import vision_syn_spec as jsyn_spec
from repro_torch.configs.base import CompressorConfig
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.core import flat, threesfc
from repro_torch.core.tree import tree_leaves
from repro_torch.models import cnn, layers
from repro_torch.models.build import vision_syn_spec

torch.set_num_threads(2)

CPU = torch.device("cpu")
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, ENCODE_RTOL, ATOL_OF_MAX = 1e-4, 1e-4, 1e-5
SYN_STEPS = 2

# (model, paper dataset, parameters, leaves) at the published widths
PUBLISHED = [("mnistnet", "fmnist", 54_840, 8),
             ("convnet", "cifar10", 390_986, 10),
             ("resnet", "cifar10", 77_706, 20),
             ("regnet", "cifar100", 559_924, 32)]

# narrow cases on 8x8 images: (label, maker name, kwargs, channels)
NARROW = [("mnistnet", "make_mnistnet", {}, 1),
          ("convnet", "make_convnet", {"widths": (4, 6, 8, 8)}, 3),
          ("resnet", "make_resnet", {"widths": (4, 6, 8)}, 3),
          ("resnet-identity", "make_resnet", {"widths": (4, 4, 4)}, 3),
          ("regnet", "make_regnet", {"widths": (4, 6, 8),
                                     "depths": (1, 1, 2)}, 3)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, atol_of_max=0.0):
    g_leaves, w_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = np.asarray(w)
        atol = atol_of_max * float(np.max(np.abs(w), initial=0.0))
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol,
                                   atol=max(atol, 1e-7))


@pytest.mark.parametrize("name,dataset,count,leaves", PUBLISHED)
def test_published_widths(name, dataset, count, leaves):
    # the reference's shapes, traced without drawing
    jparams = jax.eval_shape(
        jcnn.make_paper_model(name, jcnn.DATASETS[dataset]).init,
        jax.random.PRNGKey(0))
    params = cnn.make_paper_model(name, cnn.DATASETS[dataset]).init(
        torch.Generator().manual_seed(0))
    assert flat.tree_size(params) == count
    assert len(tree_leaves(params)) == leaves == len(jax.tree.leaves(jparams))
    # the same dict layout, leaf for leaf: HWIO convs, (in, out) denses
    shapes = [tuple(l.shape) for l in tree_leaves(params)]
    assert shapes == [tuple(l.shape) for l in jax.tree.leaves(jparams)]
    # the trees the kernels' leaf tables take: one table of at most 64
    assert leaves <= 64


def test_registry_builds_the_five_models():
    for name in ("mlp", "mnistnet", "convnet", "resnet", "regnet"):
        assert cnn.make_paper_model(name, cnn.MNIST_SPEC).spec == cnn.MNIST_SPEC
    with pytest.raises(KeyError):
        cnn.make_paper_model("vgg", cnn.MNIST_SPEC)


@pytest.fixture(scope="module", params=NARROW, ids=[c[0] for c in NARROW])
def narrow(request):
    """One narrow model on both sides, the same params on both (carried
    across as numpy), and a batch of 6 images with labels."""
    label, maker, kw, ch = request.param
    jspec = jcnn.VisionSpec("tiny8", (8, 8, ch), 5)
    spec = cnn.VisionSpec("tiny8", (8, 8, ch), 5)
    jmodel = getattr(jcnn, maker)(jspec, **kw)
    model = getattr(cnn, maker)(spec, **kw)
    # numpy draws at the reference's shapes: fan-in scaled weights and
    # nonzero biases
    rng = np.random.default_rng(2)
    jparams = jax.tree.map(
        lambda l: jnp.asarray((rng.standard_normal(l.shape) / np.sqrt(
            np.prod(l.shape[:-1]) if len(l.shape) > 1 else 10.0)
                               ).astype(np.float32)),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(1)))
    x = rng.standard_normal((6, 8, 8, ch)).astype(np.float32)
    y = (np.arange(6) % 5).astype(np.int32)
    return {"label": label, "jmodel": jmodel, "model": model,
            "jspec": jspec, "spec": spec, "jparams": jparams,
            "params": params_from_numpy(_np(jparams), CPU), "x": x, "y": y}


def test_forward_logits_match_reference(narrow):
    want = jax.jit(narrow["jmodel"].apply)(narrow["jparams"],
                                          jnp.asarray(narrow["x"]))
    got = narrow["model"].apply(narrow["params"], torch.from_numpy(narrow["x"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_loss_grads_match_reference(narrow):
    batch = {"x": narrow["x"], "y": narrow["y"]}
    want = jax.jit(jax.grad(narrow["jmodel"].loss))(
        narrow["jparams"], jax.tree.map(jnp.asarray, batch))
    w = flat.tree_map(lambda p: p.clone().requires_grad_(True),
                      narrow["params"])
    loss = narrow["model"].loss(w, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(w))
    _close([g.numpy() for g in grads], want, GRAD_RTOL, 1e-6)


def test_threesfc_encode_matches_reference(narrow):
    """3SFC differentiates ∇_w F with the graph kept: the conv's and the
    pool's double backward. Held on the encoder's result."""
    jspec = jsyn_spec(narrow["jspec"], JCompressorConfig(syn_batch=1))
    spec = vision_syn_spec(narrow["spec"], CompressorConfig(syn_batch=1))
    assert spec.x_shape == jspec.x_shape
    rng = np.random.default_rng(3)
    target = jax.tree.map(
        lambda p: 0.01 * rng.standard_normal(p.shape).astype(np.float32),
        _np(narrow["jparams"]))
    syn0 = jthreesfc.init_syn(jax.random.PRNGKey(4), jspec)
    ref = jax.jit(lambda p, t, s0: jthreesfc.encode(
        narrow["jmodel"].syn_loss, p, t, s0, steps=SYN_STEPS, lr=0.1))(
        narrow["jparams"], target, syn0)
    got = threesfc.encode(
        narrow["model"].syn_loss, narrow["params"],
        params_from_numpy(_np(target), CPU),
        threesfc.SynData(*[torch.from_numpy(np.array(t)) for t in syn0]),
        steps=SYN_STEPS, lr=0.1)
    for field in ("s", "cosine", "objective", "stats"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=ENCODE_RTOL, atol=1e-7)
    _close(to_numpy(got.gw), _np(ref.gw), ENCODE_RTOL, ATOL_OF_MAX)
    _close(to_numpy(list(got.syn)), _np(list(ref.syn)), ENCODE_RTOL,
           ATOL_OF_MAX)


@pytest.mark.parametrize("n", [7, 8, 9, 16, 17, 32])
@pytest.mark.parametrize("k,stride", [(1, 2), (3, 1), (3, 2), (5, 2)])
def test_conv2d_same_padding_matches_xla(n, k, stride):
    """SAME padding as XLA pads it: lo = total // 2, which at stride 2 on
    an even size is (0, 1) for k = 3, where F.conv2d(padding=1) would pad
    (1, 1) and shift every window."""
    rng = np.random.default_rng(n * 10 + k)
    x = rng.standard_normal((2, n, n + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = jlayers.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x), stride=stride)
    got = layers.conv2d({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        torch.from_numpy(x), stride=stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # VALID pads nothing
    want = jlayers.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x), stride=stride, padding="VALID")
    got = layers.conv2d({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        torch.from_numpy(x), stride=stride, padding="VALID")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_same_padding_values():
    assert layers.same_padding(32, 3, 2) == (0, 1)
    assert layers.same_padding(16, 3, 2) == (0, 1)
    assert layers.same_padding(7, 3, 2) == (1, 1)
    assert layers.same_padding(28, 5, 1) == (2, 2)
    assert layers.same_padding(8, 1, 2) == (0, 0)
    with pytest.raises(ValueError, match="SAME or VALID"):
        layers.conv2d({"w": torch.zeros((1, 1, 1, 1)), "b": torch.zeros(1)},
                      torch.zeros((1, 2, 2, 1)), padding="FULL")


def test_max_pool_ties_route_like_the_reference():
    """After a ReLU, tied 2×2 windows are common. The gradient of each
    window goes to the element the reference's reduce_window gradient
    picks, on planted ties: all-equal windows, ties on a row, a column and
    a diagonal, and all-zero windows."""
    x = np.zeros((2, 6, 6, 3), np.float32)
    x[0, 0:2, 0:2, 0] = 1.0                      # four-way tie
    x[0, 2, 2:4, 0] = 2.0                        # tie on the top row
    x[0, 4:6, 5, 0] = 3.0                        # tie on the right column
    x[1, 0, 1, 1] = x[1, 1, 0, 1] = 4.0          # anti-diagonal tie
    x[1, 2:4, 2:4, 2] = -1.0                     # all-negative window
    rng = np.random.default_rng(5)
    x[1, 4:, 4:, :] = rng.standard_normal((2, 2, 3))
    c = rng.standard_normal((2, 3, 3, 3)).astype(np.float32)

    def jpool(h):
        return jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                     (1, 2, 2, 1), "VALID")

    for relu in (False, True):
        jfn = (lambda h: jpool(jax.nn.relu(h))) if relu else jpool
        tfn = ((lambda h: layers.max_pool2x2(torch.relu(h))) if relu
               else layers.max_pool2x2)
        want = jax.grad(lambda h: jnp.sum(jfn(h) * c))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        out = tfn(xt)
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(jfn(jnp.asarray(x))))
        got, = torch.autograd.grad(torch.sum(out * torch.from_numpy(c)), xt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resnet_identity_shortcut_is_strided():
    """At equal widths no block projects, so the strided stages take the
    identity shortcut ``h[:, ::2, ::2, :]``."""
    params = cnn.make_resnet(cnn.CIFAR10_SPEC, widths=(16, 16, 16)).init(
        torch.Generator().manual_seed(0))
    assert not any("proj" in blk for name, blk in params.items()
                   if name.startswith("s"))
    jparams = jax.eval_shape(
        jcnn.make_resnet(jcnn.CIFAR10_SPEC, widths=(16, 16, 16)).init,
        jax.random.PRNGKey(0))
    assert [tuple(l.shape) for l in tree_leaves(params)] == [
        l.shape for l in jax.tree.leaves(jparams)]
