"""Port parity for the Mamba2 SSD path (``repro_torch.models.ssm``,
``repro_torch.kernels.ops.ssd_chunked`` and kernel B4's plain version,
``repro_torch.kernels.ssd_chunk``), on the CPU, where the B4 wrapper runs
its plain PyTorch version.

The same numpy inputs go through the JAX package (``ssd_chunk_call`` and
``ops.ssd_chunked`` in interpret mode, as tests/test_kernels.py runs them,
and the jnp ``ssd_scan``) and through the port. Tolerances are the
reference's own: rtol 1e-5 / atol 1e-6 for one kernel cell against its
oracle, rtol 1e-4 / atol 1e-5 for the chunked scan against ``ssd_scan``
(tests/test_kernels.py); the two sides differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.kernels import ops as jops
from repro.kernels.ssd_chunk import ssd_chunk_call
from repro.models import ssm as jssm
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as ssd_mod
from repro_torch.models import ssm

torch.set_num_threads(2)

CPU = torch.device("cpu")
CELL_TOL = dict(rtol=1e-5, atol=1e-6)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _cell_inputs(seed, b, h, nc, Q, P, N, decay_scale=0.2):
    """tests/test_kernels.py's distributions in the kernel layout."""
    rng = np.random.default_rng(seed)
    f = np.float32
    xdt = (0.1 * rng.standard_normal((b, h, nc, Q, P))).astype(f)
    dA = (-decay_scale * _softplus(rng.standard_normal((b, h, nc, Q)))
          ).astype(f)
    B = (0.5 * rng.standard_normal((b, nc, Q, N))).astype(f)
    C = (0.5 * rng.standard_normal((b, nc, Q, N))).astype(f)
    return xdt, dA, B, C


def _seq_inputs(seed, b, s, h, p, n, with_h0=False):
    """(xdt, dA, B, C, h0) in the model layout (b, s, ...)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    xdt = (0.1 * rng.standard_normal((b, s, h, p))).astype(f)
    dA = (-0.2 * _softplus(rng.standard_normal((b, s, h)))).astype(f)
    B = (0.5 * rng.standard_normal((b, s, n))).astype(f)
    C = (0.5 * rng.standard_normal((b, s, n))).astype(f)
    h0 = ((0.3 * rng.standard_normal((b, h, p, n))).astype(f)
          if with_h0 else None)
    return xdt, dA, B, C, h0


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# B4's plain version against the reference's kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,nc,Q,P,N,decay_scale", [
    (1, 1, 1, 16, 8, 4, 0.2),       # tests/test_kernels.py's single cell
    (2, 3, 2, 16, 8, 4, 0.2),
    (2, 2, 2, 8, 32, 16, 0.2),      # the smoke config's cell
    (2, 2, 2, 8, 32, 16, 30.0),     # decays that underflow to 0
])
def test_ssd_chunk_plain_matches_reference_kernel(b, h, nc, Q, P, N,
                                                  decay_scale):
    xdt, dA, B, C = _cell_inputs(0, b, h, nc, Q, P, N, decay_scale)
    want = ssd_chunk_call(*map(jnp.asarray, (xdt, dA, B, C)))
    got = ssd_mod.ssd_chunk(*map(_t, (xdt, dA, B, C)))
    assert ssd_mod.LAUNCHES == 0
    for g, w, shape in zip(got, want, [(b, h, nc, Q, P), (b, h, nc, P, N),
                                       (b, h, nc, Q)]):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **CELL_TOL)


def test_ssd_chunk_wrapper_checks_its_operands():
    xdt, dA, B, C = map(_t, _cell_inputs(1, 1, 2, 2, 8, 8, 4))
    with pytest.raises(TypeError, match="f32"):
        ssd_mod.ssd_chunk(xdt.double(), dA, B, C)
    with pytest.raises(ValueError, match="shapes disagree"):
        ssd_mod.ssd_chunk(xdt, dA[..., :4].contiguous(), B, C)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_mod.ssd_chunk(xdt.transpose(-1, -2).contiguous().transpose(
            -1, -2), dA, B, C)
    meta = [t.to("meta") for t in (xdt, dA, B, C)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ssd_mod.ssd_chunk(*meta)


@pytest.mark.parametrize("dims", [(129, 64, 128), (128, 129, 16),
                                  (32, 64, 256), (0, 8, 8), (8, 6, 16),
                                  (8, 32, 7), (8, 0, 16)])
def test_kernel_dims_outside_its_tiles_raise(dims):
    with pytest.raises(ValueError, match="takes 1 <= Q <= 128 and P, N "
                                         "multiples of 4"):
        ssd_mod.check_kernel_dims(*dims)
    ssd_mod.check_kernel_dims(128, 128, 128)
    ssd_mod.check_kernel_dims(1, 4, 4)
    ssd_mod.check_kernel_dims(5, 8, 12)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_kernel_operands_off_a_16_byte_boundary_raise(which):
    ops = [torch.zeros(64) for _ in range(3)]
    ssd_mod.check_kernel_alignment(*ops)
    buf = torch.zeros(65)
    ops[which] = buf[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        ssd_mod.check_kernel_alignment(*ops)


# ---------------------------------------------------------------------------
# the chunked scan and ssd_scan against the reference
# ---------------------------------------------------------------------------

SEQ_CASES = [
    ((1, 16, 2, 8, 4), 8, False),
    ((1, 16, 2, 8, 4), 16, True),
    ((2, 64, 4, 16, 8), 8, False),
    ((2, 64, 4, 16, 8), 16, True),
    ((1, 128, 8, 32, 16), 16, False),
]


@pytest.mark.parametrize("shape,chunk,with_h0", SEQ_CASES)
def test_ssd_chunked_matches_reference(shape, chunk, with_h0):
    xdt, dA, B, C, h0 = _seq_inputs(2, *shape, with_h0=with_h0)
    jy, jf = jops.ssd_chunked(*map(_j, (xdt, dA, B, C)), chunk, _j(h0))
    y, f = ops.ssd_chunked(*map(_t, (xdt, dA, B, C)), chunk, _t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **SCAN_TOL)


@pytest.mark.parametrize("shape,chunk,with_h0", SEQ_CASES + [
    ((2, 13, 2, 8, 4), 8, False),    # padded tail: 13 = 8 + 5 (+3 zeros)
    ((2, 13, 2, 8, 4), 8, True),
    ((1, 5, 2, 8, 4), 8, False),     # one chunk shorter than ssm_chunk
])
def test_ssd_scan_matches_reference(shape, chunk, with_h0):
    xdt, dA, B, C, h0 = _seq_inputs(3, *shape, with_h0=with_h0)
    jy, jf = jssm.ssd_scan(*map(_j, (xdt, dA, B, C)), chunk, _j(h0))
    y, f = ssm.ssd_scan(*map(_t, (xdt, dA, B, C)), chunk, _t(h0))
    assert tuple(y.shape) == tuple(xdt.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **SCAN_TOL)


def test_ssd_scan_matches_step_recurrence():
    """Mirror of tests/test_model_math.py: the chunked SSD equals the
    token-by-token linear recurrence h_t = exp(dA_t)·h_{t-1} + B_t⊗xdt_t,
    y_t = h_t·C_t (ground truth), at the reference's shapes and
    distributions and its SCAN_TOL (a CPU probe measured 2.4e-7)."""
    b, s, h, p, n = 2, 24, 3, 8, 4
    rng = np.random.default_rng(0)
    f = np.float32
    xdt = torch.from_numpy((0.2 * rng.standard_normal((b, s, h, p))).astype(f))
    dA = torch.from_numpy((-0.3 * _softplus(rng.standard_normal((b, s, h))))
                          .astype(f))
    B = torch.from_numpy((0.7 * rng.standard_normal((b, s, n))).astype(f))
    C = torch.from_numpy((0.7 * rng.standard_normal((b, s, n))).astype(f))
    y_scan, final = ssm.ssd_scan(xdt, dA, B, C, chunk=8)
    hstate = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        decay = torch.exp(dA[:, t])[:, :, None, None]
        dBx = torch.einsum("bn,bhp->bhpn", B[:, t], xdt[:, t])
        hstate = decay * hstate + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, C[:, t]))
    y_ref = torch.stack(ys, dim=1)
    np.testing.assert_allclose(y_scan.numpy(), y_ref.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), hstate.numpy(), **SCAN_TOL)


def test_ssd_scan_chunk_invariance():
    """Mirror of tests/test_model_math.py: the result does not depend on the
    chunk size, a chunk that does not divide the sequence included
    (SCAN_TOL; a CPU probe measured 3.6e-7 across chunks 4, 7, 20)."""
    b, s, h, p, n = 1, 20, 2, 4, 4
    rng = np.random.default_rng(4)
    f = np.float32
    xdt = torch.from_numpy((0.2 * rng.standard_normal((b, s, h, p))).astype(f))
    dA = torch.from_numpy((-0.2 * _softplus(rng.standard_normal((b, s, h))))
                          .astype(f))
    B = torch.from_numpy(rng.standard_normal((b, s, n)).astype(f))
    C = torch.from_numpy(rng.standard_normal((b, s, n)).astype(f))
    y4, f4 = ssm.ssd_scan(xdt, dA, B, C, chunk=4)
    y7, f7 = ssm.ssd_scan(xdt, dA, B, C, chunk=7)    # 20 % 7 != 0
    y20, f20 = ssm.ssd_scan(xdt, dA, B, C, chunk=20)
    np.testing.assert_allclose(y4.numpy(), y7.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(y4.numpy(), y20.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(f4.numpy(), f7.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(f4.numpy(), f20.numpy(), **SCAN_TOL)


def test_ssd_chunked_rejects_an_indivisible_sequence():
    xdt, dA, B, C, _ = map(_t, _seq_inputs(4, 1, 13, 2, 8, 4))
    with pytest.raises(ValueError, match="divide"):
        ops.ssd_chunked(xdt, dA, B, C, 8)


def test_ssd_chunked_keeps_the_activation_dtype():
    xdt, dA, B, C, h0 = map(_t, _seq_inputs(5, 1, 16, 2, 8, 4, True))
    y, f = ops.ssd_chunked(xdt.bfloat16(), dA, B.bfloat16(), C.bfloat16(),
                           8, h0.bfloat16())
    assert y.dtype == f.dtype == torch.bfloat16
    y32, _ = ops.ssd_chunked(xdt.bfloat16().float(), dA,
                             B.bfloat16().float(), C.bfloat16().float(), 8,
                             h0.bfloat16().float())
    np.testing.assert_allclose(y.float().numpy(), y32.numpy(), rtol=1e-2,
                               atol=1e-3)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_ad_gradient_matches_scan_autograd(with_h0):
    """The backward of ``ssd_chunked_ad`` is autograd of ``ssd_scan``: the
    same cotangents through both give the same gradients (bitwise: the
    backward recomputes the scan), and its forward is the kernel route's."""
    shape = (2, 16, 2, 8, 4)
    xdt, dA, B, C, h0 = _seq_inputs(6, *shape, with_h0=True)
    if not with_h0:
        h0 = np.zeros_like(h0)
    rng = np.random.default_rng(7)
    gy = _t(rng.standard_normal(xdt.shape).astype(np.float32))
    gf = _t(rng.standard_normal(h0.shape).astype(np.float32))

    def grads(fn):
        ins = [_t(a).requires_grad_() for a in (xdt, dA, B, C, h0)]
        y, f = fn(*ins)
        torch.autograd.backward((y, f), (gy, gf))
        return (y.detach(), f.detach()), [t.grad for t in ins]

    out_ad, g_ad = grads(lambda x, a, b, c, h: ops.ssd_chunked_ad(
        x, a, b, c, 8, h))
    out_scan, g_scan = grads(lambda x, a, b, c, h: ssm.ssd_scan(
        x, a, b, c, 8, h))
    for got, want in zip(g_ad, g_scan):
        assert got is not None and torch.equal(got, want)
    for got, want in zip(out_ad, out_scan):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SCAN_TOL)


def test_segsum_matches_reference():
    x = np.random.default_rng(8).standard_normal((3, 2, 8)).astype(
        np.float32)
    np.testing.assert_allclose(ssm.segsum(_t(x)).numpy(),
                               np.asarray(jssm.segsum(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the mixer on carried weights
# ---------------------------------------------------------------------------


def _mixer(use_pallas):
    jcfg = jget_smoke_config("mamba2-370m").replace(use_pallas_ssd=use_pallas)
    cfg = get_smoke_config("mamba2-370m").replace(use_pallas_ssd=use_pallas)
    jdims = jssm.SSMDims.from_cfg(jcfg)
    dims = ssm.SSMDims.from_cfg(cfg)
    assert tuple(jdims) == tuple(dims)
    jp = jssm.ssm_init(jax.random.PRNGKey(0), jdims)
    rng = np.random.default_rng(9)
    # non-trivial A, dt bias and D, so every term of the mixer is exercised
    jp = {**jp,
          "A_log": jnp.asarray(0.3 * rng.standard_normal(dims.heads),
                               jnp.float32),
          "dt_bias": jnp.asarray(0.3 * rng.standard_normal(dims.heads),
                                 jnp.float32),
          "D": jnp.asarray(1.0 + 0.1 * rng.standard_normal(dims.heads),
                           jnp.float32)}
    p = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    return jdims, dims, jp, p


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("seq", [16, 13])
def test_ssm_forward_matches_reference(use_pallas, seq):
    jdims, dims, jp, p = _mixer(use_pallas)
    u = np.random.default_rng(10).standard_normal(
        (2, seq, dims.d_model)).astype(np.float32)
    # the reference's own route is the jnp scan: its Pallas route is held
    # to it by tests/test_pallas_model_path.py
    jy, jf = jssm.ssm_forward(jp, jnp.asarray(u), jdims._replace(
        use_pallas=False))
    y, f = ssm.ssm_forward(p, _t(u), dims)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4,
                               atol=1e-5)


def test_ssm_decode_step_matches_reference():
    jdims, dims, jp, p = _mixer(False)
    rng = np.random.default_rng(11)
    u_t = rng.standard_normal((3, dims.d_model)).astype(np.float32)
    buf = rng.standard_normal((3, dims.conv_width - 1, dims.conv_dim)
                              ).astype(np.float32)
    st = (0.3 * rng.standard_normal((3, dims.heads, dims.head_dim,
                                     dims.state))).astype(np.float32)
    jy, jc = jssm.ssm_decode_step(jp, jnp.asarray(u_t), jssm.SSMCache(
        jnp.asarray(buf), jnp.asarray(st)), jdims)
    y, c = ssm.ssm_decode_step(p, _t(u_t), ssm.SSMCache(_t(buf), _t(st)),
                               dims)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(c.conv_buf.numpy(), np.asarray(jc.conv_buf),
                               **tol)
    np.testing.assert_allclose(c.state.numpy(), np.asarray(jc.state), **tol)


def test_decode_steps_continue_the_forward_pass():
    """A prefix through ``ssm_forward`` then one token at a time through
    ``ssm_decode_step`` gives the full-sequence output: the recurrent and
    chunked forms of the SSD agree (the port against itself)."""
    _, dims, _, p = _mixer(True)
    u = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 12, dims.d_model)).astype(np.float32))
    y_full, f_full = ssm.ssm_forward(p, u, dims)
    y_pre, f_pre = ssm.ssm_forward(p, u[:, :8], dims)
    z_, xc, Bc, Cc, _ = ssm._split_proj(p, u[:, 8 - (dims.conv_width - 1):8],
                                        dims)
    cache = ssm.SSMCache(torch.cat([xc, Bc, Cc], -1), f_pre)
    ys = []
    for i in range(8, 12):
        y_t, cache = ssm.ssm_decode_step(p, u[:, i], cache, dims)
        ys.append(y_t)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               y_full[:, 8:].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cache.state.numpy(), f_full.numpy(),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# C3: a second derivative through the mixer (the 3SFC encoder's grad-of-grad)
# ---------------------------------------------------------------------------


def _tangent(p):
    """A fixed direction T in the params' shapes (numpy, by sorted key)."""
    rng = np.random.default_rng(14)
    return {k: rng.standard_normal(tuple(p[k].shape)).astype(np.float32)
            for k in sorted(p)}


def _reference_grad_of_grad(jp, jdims, u, T):
    """∇_u ⟨∇_w Σ y², T⟩ on the reference."""
    def objective(u):
        gw = jax.grad(lambda q: jnp.sum(
            jssm.ssm_forward(q, u, jdims)[0] ** 2))(jp)
        return sum(jnp.vdot(gw[k], T[k]) for k in sorted(gw))
    return jax.grad(objective)(jnp.asarray(u))


def _port_grad_of_grad(p, dims, u, T):
    """∇_u ⟨∇_w Σ y², T⟩ on the port: a backward with ``create_graph``,
    then one more backward, as ``core.threesfc.encode`` takes them."""
    keys = sorted(p)
    w = {k: p[k].detach().requires_grad_(True) for k in keys}
    ut = _t(u).requires_grad_(True)
    y, _ = ssm.ssm_forward(w, ut, dims)
    gw = torch.autograd.grad(torch.sum(y * y), [w[k] for k in keys],
                             create_graph=True)
    obj = sum(torch.sum(g * _t(T[k])) for g, k in zip(gw, keys))
    return torch.autograd.grad(obj, ut)[0]


def test_grad_of_grad_through_the_kernel_route_raises():
    """The B4 route is differentiable once, in the port as in the
    reference (whose ``custom_vjp`` cannot be linearized again): a second
    derivative through it raises on both sides instead of returning
    numbers without the scan's second-order terms."""
    jdims, dims, jp, p = _mixer(True)
    u = np.random.default_rng(15).standard_normal(
        (1, 8, dims.d_model)).astype(np.float32)
    T = _tangent(p)
    with pytest.raises(RuntimeError, match="differentiable once"):
        _port_grad_of_grad(p, dims, u, T)
    with pytest.raises(ValueError, match="Linearization failed"):
        _reference_grad_of_grad(jp, jdims, u, T)


# 8: one chunk; 16: two chunks; 13: the padded tail
@pytest.mark.parametrize("seq", [8, 16, 13])
def test_grad_of_grad_through_ssd_scan_matches_reference(seq):
    """SCAN_TOL on the gradient divided by its largest element: its
    elements reach the hundreds here (Σy² over unit-scale inputs), and the
    two frameworks' f32 sums differ at ~1e-6 of that largest element, far
    above SCAN_TOL's atol for an element near zero."""
    jdims, dims, jp, p = _mixer(False)
    u = np.random.default_rng(15).standard_normal(
        (1, seq, dims.d_model)).astype(np.float32)
    T = _tangent(p)
    got = _port_grad_of_grad(p, dims, u, T).numpy()
    want = np.asarray(_reference_grad_of_grad(jp, jdims, u, T))
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(got / scale, want / scale, **SCAN_TOL)
