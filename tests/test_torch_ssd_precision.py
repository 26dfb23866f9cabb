"""Why kernel B4 (``ssd_chunk``) splits its products into three TF32
products (3xTF32), on the CPU.

The CUDA kernel runs its three products (C·Bᵀ, S·xdt and the state
product) on the tensor cores, whose TF32 inputs keep 10 of f32's 23
mantissa bits. This file emulates that rounding on CPU tensors and builds
B4's outputs from the plain version's cs and L with every product either
as one TF32 product (1xTF32) or as the kernel's split, a = big + small
with big = tf32(a) and small = tf32(a − big), summing small·big +
big·small + big·big (3xTF32). Products are summed in f64 and rounded to
f32 once, so only the input rounding differs from ``ssd_chunk_plain``.

At the full cell widths (Q, P, N) = (128, 64, 128), for the decays of
tests/test_kernels.py (dA = −0.2·softplus) and for decays that underflow
(dA = −30·softplus), 3xTF32 meets the reference's kernel bound B4_TOL
(rtol 1e-4, atol 1e-5; tests/test_kernels.py, ``chip_smoke.py`` phase 8)
and 1xTF32 misses it for y.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_chunk as ssd_mod

torch.set_num_threads(2)

B4_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPE = (1, 4, 2, 128, 64, 128)           # (b, h, nc, Q, P, N)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (a 10-bit mantissa), round to nearest,
    ties to even, on the f32 bits; returned as f32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & 0xFFFFE000
    return (rounded.to(torch.int32)).view(torch.float32).reshape(x.shape)


def product(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b with TF32 inputs (1xTF32) or the kernel's 3xTF32 split, summed
    in f64 and rounded to f32 once."""
    big_a, big_b = tf32(a), tf32(b)
    if not split:
        return (big_a.double() @ big_b.double()).float()
    small_a, small_b = tf32(a - big_a), tf32(b - big_b)
    return (small_a.double() @ big_b.double()
            + big_a.double() @ small_b.double()
            + big_a.double() @ big_b.double()).float()


def emulated_b4(xdt, dA, B, C, split: bool):
    """B4's outputs with its three products emulated, cs and L as the plain
    version forms them."""
    Q = xdt.shape[-2]
    cs = torch.cumsum(dA.double(), dim=-1).float()
    diff = cs[..., :, None] - cs[..., None, :]
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(tril, torch.exp(diff), 0.0)
    scores = product(C, B.transpose(-1, -2), split)[:, None] * L
    y = product(scores, xdt, split)
    w = torch.exp(cs[..., -1:] - cs)
    state = product((xdt * w[..., None]).transpose(-1, -2), B[:, None],
                    split)
    return y, state, torch.exp(cs)


def _inputs(seed, decay_scale):
    """tests/test_kernels.py's distributions in the kernel layout."""
    rng = np.random.default_rng(seed)
    b, h, nc, Q, P, N = SHAPE
    f = np.float32
    xdt = (0.1 * rng.standard_normal((b, h, nc, Q, P))).astype(f)
    dA = (-decay_scale * np.logaddexp(rng.standard_normal((b, h, nc, Q)),
                                      0.0)).astype(f)
    B = (0.5 * rng.standard_normal((b, nc, Q, N))).astype(f)
    C = (0.5 * rng.standard_normal((b, nc, Q, N))).astype(f)
    return tuple(torch.from_numpy(a) for a in (xdt, dA, B, C))


def _outside(got, want) -> int:
    """Elements outside B4_TOL: |got − want| > atol + rtol·|want|."""
    bound = B4_TOL["atol"] + B4_TOL["rtol"] * want.abs()
    return int(((got - want).abs() > bound).sum())


@pytest.mark.parametrize("bits, want", [
    (0x3F800000, 0x3F800000),   # 1.0 stays
    (0x3F801000, 0x3F800000),   # a tie, to the even mantissa (down)
    (0x3F803000, 0x3F804000),   # a tie, to the even mantissa (up)
    (0x3F801001, 0x3F802000),   # above the tie: up
    (0x3F800FFF, 0x3F800000),   # below the tie: down
    (0xBF801001, 0xBF802000),   # the sign is kept
    (0x3FFFF000, 0x40000000),   # the carry moves into the exponent
])
def test_tf32_rounds_to_nearest_even(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(
        torch.float32)
    got = tf32(x).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert int(got) == want


@pytest.mark.parametrize("decay_scale", [0.2, 30.0])
def test_3xtf32_meets_b4_tol(decay_scale):
    inputs = _inputs(11, decay_scale)
    want = ssd_mod.ssd_chunk_plain(*inputs)
    got = emulated_b4(*inputs, split=True)
    for name, g, w in zip(("y", "state", "decay"), got, want):
        assert _outside(g, w) == 0, (
            f"3xTF32 {name} outside B4_TOL: max |Δ| "
            f"{float((g - w).abs().max()):.3e}")


@pytest.mark.parametrize("decay_scale", [0.2, 30.0])
def test_1xtf32_misses_b4_tol_for_y(decay_scale):
    inputs = _inputs(11, decay_scale)
    want = ssd_mod.ssd_chunk_plain(*inputs)
    y, _, _ = emulated_b4(*inputs, split=False)
    assert _outside(y, want[0]) > 0
    # and by more than the tolerance's own slack: the worst element is at
    # least 10x the 1e-5 floor away
    assert float((y - want[0]).abs().max()) > 10 * B4_TOL["atol"]
